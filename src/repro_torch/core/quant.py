"""Uniform symmetric quantization — the data-plane primitive (the JAX
package's ``core/quant.py`` and the ``sr_dither`` hash of its
``kernels/ota_fused.py``).

Parity rules, so that symbols and scales are bit-identical to the
reference's jitted programs:

- the dither runs in int64 with a 32-bit mask after every multiply and
  shift (PyTorch has no uint32 shift on the CPU);
- the reference divides by a compile-time constant (``amax / qmax``),
  which XLA rewrites into a multiply by the constant's f32 reciprocal;
  the port multiplies by that reciprocal too (``_recip``);
- the uplink's ``qmax = exp2(f32(b - 1)) - 1`` is folded by XLA as
  ``exp(ln2 * (b - 1))`` in f32, which is not an integer for many widths
  (32766.984375 at 16 bits); ``ref_qmax`` reproduces that value;
- every other division is a correctly rounded f32 division of two
  tensors on one device (PyTorch on CUDA turns a division by a *CPU
  scalar* into a multiply by its reciprocal, which can differ in the
  last bit);
- round-to-nearest is half-to-even (``torch.round``).
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.packing import wire_kind
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten

Tree = Any

_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9  # Weyl increment decorrelating client rows

_STORAGE_DTYPE = {
    "int4": torch.int8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
}


def qrange(bits: int) -> int:
    """Symmetric integer range: values in [-qmax, qmax]."""
    return 2 ** (bits - 1) - 1


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32) without int64 overflow:
    the constant is split in 16-bit halves, every partial < 2^49."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def sr_dither(seed, rows, pos) -> torch.Tensor:
    """Positional uniform dither u in [0, 1) for stochastic rounding.

    murmur3 finalizer of ``pos ^ (seed + GOLDEN * row)`` over uint32
    values held in int64 tensors (broadcastable). The top 24 bits of the
    hash, times 2^-24: exact in f32 and strictly below 1.
    """
    seed = torch.as_tensor(seed, dtype=torch.int64) & _MASK32
    rows = torch.as_tensor(rows, dtype=torch.int64, device=seed.device) & _MASK32
    pos = torch.as_tensor(pos, dtype=torch.int64)
    seed, rows = seed.to(pos.device), rows.to(pos.device)
    h = pos ^ ((seed + _mul32(rows, _GOLDEN)) & _MASK32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _f32(x: float, like) -> torch.Tensor:
    """A 0-d f32 tensor on ``like``'s device (an operand that is never a
    CPU scalar; the CPU where ``like`` is a Python number), filled by a
    kernel: no blocking host-to-device copy."""
    dev = like.device if isinstance(like, torch.Tensor) else torch.device("cpu")
    return torch.full((), x, dtype=torch.float32, device=dev)


def ref_qmax(bits: int) -> float:
    """The uplink grid's qmax as the reference's jitted program computes
    ``exp2(f32(bits - 1)) - 1``: exp(f32(ln2) * (bits - 1)) in f32."""
    p = np.float32(np.float32(math.log(2)) * np.float32(bits - 1))
    return float(np.float32(np.float32(math.exp(float(p))) - np.float32(1.0)))


def _recip(qmax: float, like: torch.Tensor) -> torch.Tensor:
    """f32(1 / qmax), the multiplier XLA substitutes for ``/ qmax``."""
    return _f32(float(np.float32(1.0) / np.float32(qmax)), like)


def quantize(
    x: torch.Tensor, bits: int, *, generator: Optional[torch.Generator] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric quantization -> (q int32, scale f32 0-d).

    Round-to-nearest; with ``generator`` the rounding is stochastic
    (unbiased) against ``torch.rand`` of x's shape drawn from it on x's
    device. The reference takes a ``jax.random`` key there, whose bits
    PyTorch cannot reproduce: the two agree in distribution, not in bits.
    """
    if bits >= 32:
        return x.to(torch.float32), torch.ones((), device=x.device)
    qmax = _f32(float(qrange(bits)), x)
    amax = x.abs().max().to(torch.float32)
    scale = torch.clamp_min(amax, 1e-12) * _recip(qrange(bits), x)
    scaled = x.to(torch.float32) / scale
    if generator is not None:
        floor = torch.floor(scaled)
        rnd = torch.rand(x.shape, generator=generator, dtype=torch.float32, device=x.device)
        q = floor + (rnd < (scaled - floor)).to(torch.float32)
    else:
        q = torch.round(scaled)
    q = torch.minimum(torch.maximum(q, -qmax), qmax)
    return q.to(torch.int32), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    if bits >= 32:
        return q.to(torch.float32)
    return q.to(torch.float32) * scale


def fake_quant(
    x: torch.Tensor, bits: int, *, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """quantize -> dequantize (the client-side model degradation at b)."""
    if bits >= 32:
        return x
    q, scale = quantize(x, bits, generator=generator)
    return dequantize(q, scale, bits).to(x.dtype)


class _SteFakeQuant(torch.autograd.Function):
    """Fake-quant forward, identity (straight-through) backward."""

    @staticmethod
    def forward(ctx, x, bits):
        return fake_quant(x, bits)

    @staticmethod
    def backward(ctx, g):
        return g, None


def ste_fake_quant(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Fake-quant with straight-through gradients (QAT local training)."""
    return _SteFakeQuant.apply(x, bits)


def quantize_row_sr(
    row: torch.Tensor,
    bits: int,
    sr_seed: int,
    row_index: int,
    block: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Client-side uplink quantization of one flat packed row.

    Stochastic rounding against ``sr_dither(sr_seed, row_index, pos)``.
    Returns (q, scale): q int8 for bits <= 8, int16/int32 up to 16/31
    bits; the f32 row itself (scale 1) for bits >= 32 and bits <= 1.
    ``block`` > 0 (and < M) gives one scale per ``block`` symbols, an
    (n_blocks,) vector; otherwise scale is the () per-row scalar.
    """
    row = row.to(torch.float32)
    kind = wire_kind(bits)
    if kind == "float32":
        return row, torch.ones((), device=row.device)
    qmax = _f32(ref_qmax(bits), row)
    recip = _recip(ref_qmax(bits), row)
    M = row.shape[0]
    if 0 < block < M:
        n_blocks = -(-M // block)
        pad = n_blocks * block - M
        padded = torch.nn.functional.pad(row, (0, pad)) if pad else row
        amax = padded.reshape(n_blocks, block).abs().amax(dim=1)
        scale = torch.clamp_min(amax, 1e-12) * recip
        scale_cols = scale.repeat_interleave(block)[:M]
    else:
        amax = row.abs().max()
        scale = torch.clamp_min(amax, 1e-12) * recip
        scale_cols = scale
    pos = torch.arange(M, dtype=torch.int64, device=row.device)
    u = sr_dither(int(sr_seed), int(row_index), pos)
    scaled = row / scale_cols
    floor = torch.floor(scaled)
    q = floor + (u < (scaled - floor)).to(torch.float32)
    q = torch.minimum(torch.maximum(q, -qmax), qmax)
    return q.to(_STORAGE_DTYPE[kind]), scale


# ---------------------------------------------------------------------------
# quantized optimizer/server state
# ---------------------------------------------------------------------------

# symbols per scale for resident quantized state (the wire's QUANT_BLOCK)
STATE_BLOCK = 256


def quantize_state(x: torch.Tensor, *, bits: int = 8, block: int = STATE_BLOCK):
    """Blockwise symmetric quantization of one resident state tensor.

    ``x`` is flattened and split into ``block``-value runs (the last one
    ragged); each run is rounded to nearest on its own amax/qmax grid,
    ``scale = max(amax, 1e-12) / qmax`` (a multiply by ``_recip``, as in
    the reference's jitted program). Returns (q int8 in x's shape, scale
    (n_blocks,) f32 in flattened order); ``block`` <= 0 or >= size gives
    one per-tensor scale.
    """
    if not 2 <= bits <= 8:
        raise ValueError(f"int8 storage class: 2..8 bits, got {bits}")
    flat = x.to(torch.float32).reshape(-1)
    M = flat.shape[0]
    qmax = _f32(float(qrange(bits)), flat)
    recip = _recip(float(qrange(bits)), flat)
    if 0 < block < M:
        n_blocks = -(-M // block)
        pad = n_blocks * block - M
        padded = torch.nn.functional.pad(flat, (0, pad)) if pad else flat
        amax = padded.reshape(n_blocks, block).abs().amax(dim=1)
        scale = torch.clamp_min(amax, 1e-12) * recip
        cols = scale.repeat_interleave(block)[:M]
    else:
        scale = (torch.clamp_min(flat.abs().max(), 1e-12) * recip).reshape(1)
        cols = scale[0]
    q = torch.minimum(torch.maximum(torch.round(flat / cols), -qmax), qmax)
    return q.to(torch.int8).reshape(x.shape), scale


def dequantize_state(q: torch.Tensor, scale: torch.Tensor, *,
                     block: int = STATE_BLOCK) -> torch.Tensor:
    """Inverse of ``quantize_state``: q * scale[block], in q's shape."""
    flat = q.reshape(-1).to(torch.float32)
    scale = torch.atleast_1d(scale.to(torch.float32))
    if scale.shape[0] > 1:
        bid = torch.arange(flat.shape[0], device=flat.device) // block
        flat = flat * scale[torch.clamp_max(bid, scale.shape[0] - 1)]
    else:
        flat = flat * scale[0]
    return flat.reshape(q.shape)


# ---------------------------------------------------------------------------
# tree-level helpers (client model / update quantization)
# ---------------------------------------------------------------------------


def quantize_tree(
    tree: Tree, bits: int, *, generator: Optional[torch.Generator] = None
) -> Tuple[Tree, Tree]:
    """Quantize every leaf per-tensor -> (q_tree, scale_tree). One
    ``generator`` is consumed leaf by leaf in flatten order."""
    leaves, structure = tree_flatten(tree)
    pairs = [quantize(leaf, bits, generator=generator) for leaf in leaves]
    return (
        tree_unflatten(structure, [q for q, _ in pairs]),
        tree_unflatten(structure, [s for _, s in pairs]),
    )


def dequantize_tree(q_tree: Tree, scale_tree: Tree, bits: int) -> Tree:
    return tree_map(lambda q, s: dequantize(q, s, bits), q_tree, scale_tree)


def fake_quant_tree(
    tree: Tree, bits: int, *, generator: Optional[torch.Generator] = None
) -> Tree:
    if bits >= 32:
        return tree
    return tree_map(lambda leaf: fake_quant(leaf, bits, generator=generator), tree)


def quant_error(x: torch.Tensor, bits: int) -> torch.Tensor:
    """RMS relative quantization error (used by perf/accuracy priors)."""
    fq = fake_quant(x, bits)
    return torch.sqrt(torch.mean((x - fq) ** 2)) / torch.clamp_min(
        torch.sqrt(torch.mean(x**2)), 1e-12
    )
