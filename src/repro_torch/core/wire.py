"""Symmetric wire codec: one encode/decode facade for both legs (the JAX
package's ``core/wire.py`` plus the row-major int4 pack of its
``kernels/ops.py``).

- ``encode_row``: stochastic-quantize a flat f32 row at ``bits`` with the
  positional dither stream (``quant.quantize_row_sr``) and bit-pack the
  symbols into a ``PackedRow`` — int4 two symbols per byte, int8/16/32
  above, the f32 row itself for ``bits`` >= 32.
- ``decode_row``: reconstruct q * scale[block], the same math the
  aggregation kernel applies in-pass.

Uplink rows encode with the round's ``sr_seed`` at their cohort row; the
downlink broadcast encodes once with the round's ``dl_seed`` at row 0 and
every client decodes the same row to bit-identical params.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch import obs
from repro_torch.core import packing, quant


def pack_int4_rows(q: torch.Tensor) -> torch.Tensor:
    """Row-major int4 pack: (..., M) values in [-8, 7] -> (..., ceil(M/2))
    uint8; the low nibble holds the even index. int8 wraps to its low
    four bits (two's complement), as the reference's uint8 cast does."""
    M = q.shape[-1]
    if M % 2:
        q = torch.nn.functional.pad(q, (0, 1))
    q16 = q.to(torch.int16)
    lo = q16[..., 0::2] & 0x0F
    hi = q16[..., 1::2] & 0x0F
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4_rows(packed: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """Inverse of ``pack_int4_rows``: (..., P) uint8 -> (..., n) int8,
    low nibble first, sign-extended."""
    lo = (packed & 0x0F).to(torch.int8)
    hi = ((packed >> 4) & 0x0F).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    out = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], 2 * packed.shape[-1])
    return out if n is None else out[..., :n]


def encode_row(
    row: torch.Tensor,
    bits: int,
    seed: int,
    row_index: int,
    *,
    block: int = 0,
) -> packing.PackedRow:
    """Encode one flat f32 row into its wire form at ``bits``."""
    q, scale = quant.quantize_row_sr(row, bits, seed, row_index, block=block)
    if packing.wire_kind(bits) == "int4":
        q = pack_int4_rows(q)
    qblock = block if int(scale.numel()) > 1 else 0
    out = packing.PackedRow(data=q, scale=scale, bits=int(bits), qblock=qblock)
    if obs.is_enabled() and out.kind != "float32":
        # quantization-MSE proxy: E[scale^2] / 12 per symbol (a device
        # sync, so telemetry mode only)
        s = scale.reshape(-1).to(torch.float32)
        obs.metrics.observe(
            "wire.quant_mse_proxy", float((s * s).mean()) / 12.0, kind=out.kind
        )
    return out


def decode_row(row: packing.PackedRow, n: Optional[int] = None) -> torch.Tensor:
    """Reconstruct the f32 row a ``PackedRow`` encodes (q * scale[block])."""
    if row.kind == "float32":
        out = row.data.to(torch.float32)
        return out if n is None else out[:n]
    q = row.data
    if row.kind == "int4":
        q = unpack_int4_rows(q)
    q = q.to(torch.float32)
    scales = row.scale.reshape(-1).to(torch.float32)
    if row.qblock > 0 and scales.shape[0] > 1:
        bid = torch.arange(q.shape[0], device=q.device) // row.qblock
        out = q * scales[bid.clamp_max(scales.shape[0] - 1)]
    else:
        out = q * scales[0]
    return out if n is None else out[:n]


def decode_broadcast(
    row: packing.PackedRow,
    base: Optional[torch.Tensor] = None,
    n: Optional[int] = None,
) -> torch.Tensor:
    """Client-side downlink reconstruction: an f32 broadcast carries the
    absolute params; a quantized one the delta against ``base``."""
    decoded = decode_row(row, n)
    if row.kind == "float32":
        return decoded
    assert base is not None, "quantized broadcast needs the current replica"
    return base.to(torch.float32)[: decoded.shape[0]] + decoded


def wire_bytes(rows: Sequence[packing.PackedRow]) -> int:
    """Total bytes the encoded rows occupy on the wire."""
    return int(sum(r.wire_nbytes for r in rows))
