"""Plain float32 pieces of the reference: norms, RoPE, causal attention,
the SwiGLU MLP, the next-token cross-entropy, and the matrix products'
operand precision.

Every product goes through ``Prec.mm``. ``Prec("f32")`` is the reference:
float32 operands and accumulation, TF32 off. ``Prec("fp8")`` is the
benchmark's control, the precision step below the configurations' bf16:
each operand rounded to float8 e4m3 with one scale a tensor (its largest
magnitude to 448) before the float32 product; the gradient passes the
rounding unchanged. Nothing here imports the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

FP8_MAX = 448.0  # the largest float8 e4m3 value


def tf32_off() -> None:
    """The reference's float32 products in full float32 (the legacy flags,
    which the program sets too: torch refuses a mix with the newer API)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        amax = t.detach().abs().amax().clamp_min(1e-30)
        scale = FP8_MAX / amax
        return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale

    @staticmethod
    def backward(ctx, g):
        return g


@dataclass(frozen=True)
class Prec:
    mode: str = "f32"  # "f32" | "fp8"

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return _RoundFp8.apply(t) if self.mode == "fp8" else t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, self.q(a), self.q(b))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions 0..S-1 on x (B, S, H, D): the two halves of each
    head rotate by position x theta^(-i / (D/2)), i < D/2."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def causal_attention(q, k, v, prec: Prec) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) over keys at or before the query) v, every
    head whole: q, k, v (B, S, H, D) -> (B, S, H * D). Query heads share a
    key head in groups (H / KV)."""
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    if rep > 1:
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    s = prec.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    return prec.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, H * D)


def attention(p, x, cfg, prec: Prec) -> torch.Tensor:
    """The attention block: q/k/v projections, RoPE, causal attention, the
    output projection."""
    B, S, _ = x.shape
    H, KV, Dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = prec.mm(x, p["wq"]).reshape(B, S, H, Dh)
    k = prec.mm(x, p["wk"]).reshape(B, S, KV, Dh)
    v = prec.mm(x, p["wv"]).reshape(B, S, KV, Dh)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    return prec.mm(causal_attention(q, k, v, prec), p["wo"])


def swiglu(p, x, prec: Prec) -> torch.Tensor:
    g = prec.mm(x, p["w_gate"])
    return prec.mm(g * torch.sigmoid(g) * prec.mm(x, p["w_up"]), p["w_down"])


def nll_sum(h: torch.Tensor, head: torch.Tensor, tokens: torch.Tensor, prec: Prec) -> torch.Tensor:
    """Sum over rows and positions t < S - 1 of -log softmax(h_t head)[token t + 1]."""
    logits = prec.mm(h[:, :-1], head)
    gold = logits.gather(-1, tokens[:, 1:, None].long())[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()
