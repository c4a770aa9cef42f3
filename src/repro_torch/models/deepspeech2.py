"""DeepSpeech2-style ASR model (the JAX package's ``models/deepspeech2.py``).

conv-over-time frontend (2 strided layers) -> bidirectional GRU stack ->
framewise projection -> log-softmax, trained with the reference's own
log-space CTC loss. Params are a nested dict in the reference's layouts:
conv weights (taps, in, out); GRU ``w_x`` (d_in, 3H), ``w_h`` (H, 3H),
``b`` (3H,), gate order r, z, n, no hidden bias.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.models.layers import dense_init, dtype_of, layer_norm

Params = Dict[str, Any]

BLANK = 0  # CTC blank id (vocab id 0 reserved)
NEG = -1e30


def init_gru(gen, d_in: int, d_hidden: int, dtype, device) -> Params:
    return {
        "w_x": dense_init(gen, (d_in, 3 * d_hidden), dtype, device),
        "w_h": dense_init(gen, (d_hidden, 3 * d_hidden), dtype, device),
        "b": torch.zeros((3 * d_hidden,), dtype=dtype, device=device),
    }


def gru_scan(p: Params, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """x: (B, T, d_in) -> (B, T, H); the explicit per-step scan."""
    B, T, _ = x.shape
    H = p["w_h"].shape[0]
    xz = x @ p["w_x"] + p["b"]  # (B, T, 3H)
    h = torch.zeros((B, H), dtype=x.dtype, device=x.device)
    outs = [None] * T
    steps = range(T - 1, -1, -1) if reverse else range(T)
    for t in steps:
        xz_t = xz[:, t]
        rzn_h = h @ p["w_h"]
        r = torch.sigmoid(xz_t[:, :H] + rzn_h[:, :H])
        z = torch.sigmoid(xz_t[:, H : 2 * H] + rzn_h[:, H : 2 * H])
        n = torch.tanh(xz_t[:, 2 * H :] + r * rzn_h[:, 2 * H :])
        h = (1 - z) * n + z * h
        outs[t] = h
    return torch.stack(outs, dim=1)


def init_ds2(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    dtype = dtype_of(cfg.param_dtype)
    F_, H, V = cfg.frontend_dim, cfg.d_model, cfg.vocab_size

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    p: Params = {
        "conv1_w": dense_init(gen, (11, F_, H), dtype, device),
        "conv1_b": zeros(H),
        "conv2_w": dense_init(gen, (11, H, H), dtype, device),
        "conv2_b": zeros(H),
        "ln1_w": ones(H),
        "ln1_b": zeros(H),
        "ln2_w": ones(H),
        "ln2_b": zeros(H),
        "out_w": dense_init(gen, (2 * H, V), dtype, device),
        "out_b": zeros(V),
    }
    grus = []
    d_in = H
    for _ in range(cfg.n_layers):
        grus.append({
            "fwd": init_gru(gen, d_in, H, dtype, device),
            "bwd": init_gru(gen, d_in, H, dtype, device),
            "ln_w": ones(2 * H),
            "ln_b": zeros(2 * H),
        })
        d_in = 2 * H
    p["gru"] = grus
    return p


def _conv_time(x, w, b, stride: int):
    """1-D conv over time with JAX's ``padding="SAME"``. x: (B, T, Cin);
    w: (K, Cin, Cout). SAME pads (out - 1) * stride + K - T in total,
    the smaller half on the left: 4 left / 5 right for K = 11, stride 2
    and an even T."""
    T, K = x.shape[1], w.shape[0]
    out_len = -(-T // stride)
    total = max((out_len - 1) * stride + K - T, 0)
    left = total // 2
    xt = F.pad(x.transpose(1, 2), (left, total - left))
    y = F.conv1d(xt, w.permute(2, 1, 0), stride=stride)
    return y.transpose(1, 2) + b


def ds2_logits(params: Params, frames: torch.Tensor, cfg: ArchConfig):
    """frames: (B, T, F) -> log-probs (B, T//4, V)."""
    x = frames.to(dtype_of(cfg.compute_dtype))
    x = torch.relu(layer_norm(_conv_time(x, params["conv1_w"], params["conv1_b"], 2),
                              params["ln1_w"], params["ln1_b"]))
    x = torch.relu(layer_norm(_conv_time(x, params["conv2_w"], params["conv2_b"], 2),
                              params["ln2_w"], params["ln2_b"]))
    for g in params["gru"]:
        fwd = gru_scan(g["fwd"], x)
        bwd = gru_scan(g["bwd"], x, reverse=True)
        x = layer_norm(torch.cat([fwd, bwd], dim=-1), g["ln_w"], g["ln_b"])
    logits = x @ params["out_w"] + params["out_b"]
    return torch.log_softmax(logits.to(torch.float32), dim=-1)


def ctc_loss(
    log_probs: torch.Tensor,  # (B, T, V) log-softmaxed
    labels: torch.Tensor,  # (B, L) int, 0 = padding (blank id is also 0)
    input_lengths: torch.Tensor,  # (B,)
    label_lengths: torch.Tensor,  # (B,)
) -> torch.Tensor:
    """Mean over the batch of the per-label-normalised negative
    log-likelihood (the reference's log-space forward algorithm)."""
    B, T, V = log_probs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = log_probs.device
    labels = labels.to(torch.int64)
    ext = torch.zeros((B, S), dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels
    can_skip = torch.zeros((B, S), dtype=torch.bool, device=dev)
    can_skip[:, 2:] = (ext[:, 2:] != BLANK) & (ext[:, 2:] != ext[:, :-2])
    neg = torch.full((B, S), NEG, dtype=log_probs.dtype, device=dev)
    neg1 = torch.full((B, 1), NEG, dtype=log_probs.dtype, device=dev)
    neg2 = torch.full((B, 2), NEG, dtype=log_probs.dtype, device=dev)

    def get_lp(t):  # (B, S) label log-probs at frame t
        return torch.gather(log_probs[:, t], 1, ext)

    has_label = label_lengths > 0
    alpha = torch.cat([
        log_probs[:, 0, BLANK : BLANK + 1],
        torch.where(has_label, get_lp(0)[:, 1], neg[:, 1]).unsqueeze(1),
        neg[:, 2:],
    ], dim=1)
    input_lengths = input_lengths.to(dev)
    for t in range(1, T):
        prev1 = torch.cat([neg1, alpha[:, :-1]], dim=1)
        prev2 = torch.cat([neg2, alpha[:, :-2]], dim=1)
        prev2 = torch.where(can_skip, prev2, neg)
        merged = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        alpha_new = merged + get_lp(t)
        alpha = torch.where((t < input_lengths)[:, None], alpha_new, alpha)

    last = 2 * label_lengths.to(torch.int64)
    idx_b = torch.arange(B, device=dev)
    ll = torch.logaddexp(
        alpha[idx_b, last],
        torch.where(has_label, alpha[idx_b, torch.clamp_min(last - 1, 0)], neg[:, 0]),
    )
    return -torch.mean(ll / torch.clamp_min(label_lengths.to(torch.float32), 1.0))


def ds2_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig):
    """batch: frames (B,T,F), labels (B,L), frame_len (B,), label_len (B,)."""
    lp = ds2_logits(params, batch["frames"], cfg)
    in_len = torch.clamp_max(torch.div(batch["frame_len"], 4, rounding_mode="floor"),
                             lp.shape[1])
    loss = ctc_loss(lp, batch["labels"], in_len, batch["label_len"])
    return loss, {"ce": loss.detach()}


def ds2_greedy_decode(params: Params, frames, cfg: ArchConfig) -> torch.Tensor:
    """Greedy CTC decode -> (B, T') token ids, blanks/repeats marked 0."""
    lp = ds2_logits(params, frames, cfg)
    ids = lp.argmax(dim=-1)
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    keep = (ids != BLANK) & (ids != prev)
    return torch.where(keep, ids, torch.zeros_like(ids))
