"""The Mamba-2 hybrid LM in plain float32 (zamba2-2.7b's family).

``n_layers`` Mamba-2 blocks in segments of ``attn_every``; after each
segment one shared attention + SwiGLU block, the same weights at every
application, reads ``concat([hidden, token embedding]) @ in_proj``.

A Mamba-2 block (one group of B and C for all heads):
  z, xBC, dt = split(x @ in_proj); xBC = silu(causal depthwise conv(xBC))
  dt = softplus(dt + dt_bias); A = -exp(A_log)
  h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T;  y_t = h_t C_t + D x_t
  out = rms_norm(y * silu(z)) @ out_proj
The scan is the SSD block decomposition of the Mamba-2 paper (arXiv:2405.21060,
its minimal listing) in chunks of ``SSD_CHUNK``: within a chunk the
decay-masked products, between chunks the states' recurrence.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench import flops
from perfbench.reference import common as C
from perfbench.reference.layout import Leaf

SSD_CHUNK = 128


def dims(cfg):
    di = cfg["d_inner"]
    H = cfg["ssm_heads"]
    return di, H, di // H, cfg["ssm_state"], cfg["ssm_conv"]


def layout(cfg):
    d, V, F_ = cfg["d_model"], cfg["vocab_size"], cfg["d_ff"]
    H_, KV, Dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    di, H, _, N, K = dims(cfg)
    ns, ev = cfg["n_layers"] // cfg["attn_every"], cfg["attn_every"]
    dt = cfg["param_dtype"]
    f32 = "float32"
    return {
        "embed": Leaf((V, d), dt, "embed"),
        "segments": {
            "norm": Leaf((ns, ev, d), dt, "ones", 2),
            "mamba": {
                "in_proj": Leaf((ns, ev, d, 2 * di + 2 * N + H), dt, "dense", 2),
                "conv_w": Leaf((ns, ev, K, di + 2 * N), dt, "conv", 2),
                "conv_b": Leaf((ns, ev, di + 2 * N), dt, "zeros", 2),
                "A_log": Leaf((ns, ev, H), f32, "a_log", 2),
                "D": Leaf((ns, ev, H), f32, "ones", 2),
                "dt_bias": Leaf((ns, ev, H), f32, "dt_bias", 2),
                "gate_norm": Leaf((ns, ev, di), dt, "ones", 2),
                "out_proj": Leaf((ns, ev, di, d), dt, "dense", 2),
            },
        },
        "shared": {
            "attn_norm": Leaf((d,), dt, "ones"),
            "mlp_norm": Leaf((d,), dt, "ones"),
            "attn": {"wq": Leaf((d, H_ * Dh), dt, "dense"),
                     "wk": Leaf((d, KV * Dh), dt, "dense"),
                     "wv": Leaf((d, KV * Dh), dt, "dense"),
                     "wo": Leaf((H_ * Dh, d), dt, "dense")},
            "mlp": {"w_gate": Leaf((d, F_), dt, "dense"),
                    "w_up": Leaf((d, F_), dt, "dense"),
                    "w_down": Leaf((F_, d), dt, "dense")},
            "in_proj": Leaf((2 * d, d), dt, "dense"),
        },
        "final_norm": Leaf((d,), dt, "ones"),
        "lm_head": Leaf((d, V), dt, "dense"),
    }


def matrix_params(cfg) -> int:
    """Matrix params a token passes: every Mamba-2 block's in and out
    projections, the shared block's at each application, and the head."""
    d = cfg["d_model"]
    di, H, _, N, _ = dims(cfg)
    mamba = d * (2 * di + 2 * N + H) + di * d
    shared = flops.attention_block_params(cfg) + 3 * d * cfg["d_ff"] + 2 * d * d
    apps = cfg["n_layers"] // cfg["attn_every"]
    return cfg["n_layers"] * mamba + apps * shared + d * cfg["vocab_size"]


def applications(cfg):
    """How often a step's forward runs each timed layer."""
    return {"attention": cfg["n_layers"] // cfg["attn_every"], "ssd": cfg["n_layers"]}


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., L) -> (..., L, L): sum of a over (j, i] where i >= j, else -inf."""
    c = torch.cumsum(a, dim=-1)
    s = c[..., :, None] - c[..., None, :]
    keep = torch.ones(a.shape[-1], a.shape[-1], dtype=torch.bool, device=a.device).tril()
    return s.masked_fill(~keep, float("-inf"))


def ssd(X, Adt, Bm, Cm, chunk: int = SSD_CHUNK):
    """y (b, T, h, p) of h_t = exp(Adt_t) h_{t-1} + X_t B_t^T, y_t = h_t C_t,
    h_0 = 0. X (b, T, h, p) = dt x, Adt (b, T, h) = dt A, Bm and Cm (b, T, n)."""
    b, T, h, p = X.shape
    n = Bm.shape[-1]
    pad = (-T) % chunk
    if pad:  # zero input and zero decay after the end change nothing before it
        X, Adt, Bm, Cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (X, Adt, Bm, Cm))
    c = (T + pad) // chunk
    X = X.reshape(b, c, chunk, h, p)
    A = Adt.reshape(b, c, chunk, h).permute(0, 3, 1, 2)  # (b, h, c, l)
    Bm = Bm.reshape(b, c, chunk, n)
    Cm = Cm.reshape(b, c, chunk, n)
    A_cum = torch.cumsum(A, dim=-1)

    # 1. within each chunk: y_l = sum_{s <= l} (C_l . B_s) exp(A(s, l]) X_s
    Lm = torch.exp(_segsum(A)).permute(0, 2, 1, 3, 4)  # (b, c, h, l, s)
    scores = Cm @ Bm.transpose(-1, -2)  # (b, c, l, s)
    Y_diag = (scores[:, :, None] * Lm) @ X.permute(0, 1, 3, 2, 4)  # (b, c, h, l, p)

    # 2. each chunk's final state from a zero start
    decay = torch.exp(A_cum[..., -1:] - A_cum).permute(0, 2, 1, 3)  # (b, c, h, l)
    Xd = X.permute(0, 1, 3, 4, 2) * decay[:, :, :, None, :]  # (b, c, h, p, l)
    states = Xd @ Bm[:, :, None]  # (b, c, h, p, n)

    # 3. the states entering each chunk
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    dchunk = torch.exp(_segsum(F.pad(A_cum[..., -1], (1, 0))))  # (b, h, c + 1, c + 1)
    entering = torch.einsum("bhzc,bchpn->bzhpn", dchunk, states)[:, :-1]

    # 4. the entering states' share of each output
    Y_off = (Cm[:, :, None] @ entering.transpose(-1, -2))  # (b, c, h, l, p)
    Y_off = Y_off * torch.exp(A_cum).permute(0, 2, 1, 3)[..., None]
    Y = (Y_diag + Y_off).permute(0, 1, 3, 2, 4).reshape(b, c * chunk, h, p)
    return Y[:, :T]


def _conv(x, w, bias):
    """Causal depthwise conv: x (B, T, C), taps w (K, C), the last tap on x_t."""
    K, Cn = w.shape
    y = F.conv1d(F.pad(x.transpose(1, 2), (K - 1, 0)), w.t()[:, None, :], bias, groups=Cn)
    return y.transpose(1, 2)


def mamba2(p, x, cfg, prec: C.Prec):
    di, H, P, N, _ = dims(cfg)
    Bsz, T, _ = x.shape
    zxbcdt = prec.mm(x, p["in_proj"])
    z, xBC, dt = zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * N], zxbcdt[..., 2 * di + 2 * N:]
    xBC = F.silu(_conv(xBC, p["conv_w"], p["conv_b"]))
    xs = xBC[..., :di].reshape(Bsz, T, H, P)
    Bm, Cm = xBC[..., di:di + N], xBC[..., di + N:]
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = ssd(xs * dt[..., None], dt * A, Bm, Cm) + xs * p["D"][:, None]
    y = C.rms_norm(y.reshape(Bsz, T, di) * F.silu(z), p["gate_norm"], cfg["norm_eps"])
    return prec.mm(y, p["out_proj"])


def _mamba_layer(norm, p, x, cfg, prec):
    return x + mamba2(p, C.rms_norm(x, norm, cfg["norm_eps"]), cfg, prec)


def _shared(p, x, x0, cfg, prec):
    eps = cfg["norm_eps"]
    inp = prec.mm(torch.cat([x, x0], dim=-1), p["in_proj"])
    x = x + C.attention(p["attn"], C.rms_norm(inp, p["attn_norm"], eps), cfg, prec)
    return x + C.swiglu(p["mlp"], C.rms_norm(x, p["mlp_norm"], eps), prec)


def _at(tree, i, j):
    return ({k: _at(v, i, j) for k, v in tree.items()} if isinstance(tree, dict)
            else tree[i, j])


def nll_sum(p, tokens, cfg, prec: C.Prec, remat: bool = True):
    """Summed next-token loss of ``tokens`` (B, S) under f32 params ``p``."""
    run = (lambda f, *a: checkpoint(f, *a, use_reentrant=False)) if remat else \
        (lambda f, *a: f(*a))
    x = p["embed"][tokens.long()]
    x0 = x
    ev = cfg["attn_every"]
    for s in range(cfg["n_layers"] // ev):
        for i in range(ev):
            x = run(_mamba_layer, p["segments"]["norm"][s, i],
                    _at(p["segments"]["mamba"], s, i), x, cfg, prec)
        x = run(_shared, p["shared"], x, x0, cfg, prec)
    h = C.rms_norm(x, p["final_norm"], cfg["norm_eps"])
    return C.nll_sum(h, p["lm_head"], tokens, prec)
