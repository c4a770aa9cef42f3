"""Mixed-precision Over-the-Air aggregation, packed barrier path (the JAX
package's ``core/ota.py``: ``ota_aggregate_packed`` with ``PackedRow``
inputs on the ideal channel).

One round: the cohort's wire rows are grouped by (storage class, qblock)
in the reference's order (a stable sort on ``(KIND_RANK, qblock)``); the
first group's superpose *is* the accumulator and every later group folds
into it (a left-associated sum, ``kernels/ota_fused.py``); the receiver
AWGN is calibrated to the aggregate's norm and added; the result unpacks
to the update tree.

Randomness comes through the round-draws seam (``RoundDraws``): the
uplink and downlink dither seeds, the channel coin-flip and the AWGN
normals. ``TorchRoundDraws`` draws them from a ``torch.Generator`` on the
device; a caller (a parity test) may hand in any other draws, such as the
reference's own ``jax.random`` streams, which PyTorch cannot reproduce.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.core import packing, wire
from repro_torch.kernels import ota_fused as kota

Tree = Any


@dataclasses.dataclass(frozen=True)
class OTAConfig:
    snr_db: float = 20.0
    fade_threshold: float = 0.1  # |h|^2 truncation threshold
    max_bits: int = 32


class RoundDraws:
    """One round's random draws (the seam the reference's round key fills).

    ``sr_seed``/``dl_seed``: uint32 dither seeds of the uplink and the
    downlink; ``channel(K, fade_threshold)`` -> (|h| (K,), participate
    (K,) bool) over the reporting rows; ``awgn(n)`` -> n standard
    normals.
    """

    sr_seed: int
    dl_seed: int

    def channel(self, k: int, fade_threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def awgn(self, n: int) -> torch.Tensor:
        raise NotImplementedError


class TorchRoundDraws(RoundDraws):
    """Draws from a ``torch.Generator`` on ``device`` seeded by ``seed``."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        seeds = torch.randint(
            0, 2**32, (2,), generator=self.gen, device=self.device, dtype=torch.int64
        ).tolist()
        self.sr_seed, self.dl_seed = int(seeds[0]), int(seeds[1])

    def channel(self, k, fade_threshold):
        h = torch.randn((2, k), generator=self.gen, device=self.device)
        h = h * math.sqrt(0.5)
        h2 = h[0] ** 2 + h[1] ** 2
        return torch.sqrt(h2), h2 >= fade_threshold

    def awgn(self, n):
        return torch.randn((n,), generator=self.gen, device=self.device)


def round_channel(
    draws: RoundDraws, weights: torch.Tensor, *, cfg: OTAConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Channel draw + FedAvg weight renormalisation -> (habs, participate, w)."""
    habs, participate = draws.channel(int(weights.shape[0]), cfg.fade_threshold)
    w = weights.to(torch.float32) * participate.to(torch.float32)
    w = w / torch.clamp_min(w.sum(), 1e-12)
    return habs, participate, w


def _awgn_epilogue(
    draws: RoundDraws, acc: torch.Tensor, *, cfg: OTAConfig, n_valid: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Receiver AWGN on the combined aggregate: noise std set so that the
    per-element SNR matches ``cfg.snr_db`` (padding is exact zeros)."""
    sumsq = (acc * acc).sum()
    nv = torch.tensor(float(n_valid), dtype=torch.float32, device=acc.device)
    noise_std = torch.sqrt(sumsq / nv * (10 ** (-cfg.snr_db / 10)))
    noise = draws.awgn(n_valid).to(device=acc.device, dtype=torch.float32)
    return acc[:n_valid] + noise_std * noise, noise_std


def _group_rows(rows: Sequence[packing.PackedRow]):
    """Stable-sort rows by (storage class, qblock) -> groups.

    Returns (kinds, datas, scales, perm): kinds a tuple of (kind, qblock)
    keys, datas/scales the stacked (Kg, ...) symbol and (Kg, n_blocks)
    scale matrices, perm the cohort rows in group order.
    """

    def _key(i):
        return (packing.KIND_RANK[rows[i].kind], rows[i].qblock)

    order = sorted(range(len(rows)), key=_key)
    kinds, datas, scales, perm = [], [], [], []
    i = 0
    while i < len(order):
        kind, qblock = rows[order[i]].kind, rows[order[i]].qblock
        grp = [j for j in order[i:] if _key(j) == _key(order[i])]
        kinds.append((kind, qblock))
        datas.append(torch.stack([rows[j].data for j in grp]))
        scales.append(torch.stack([rows[j].scale.reshape(-1) for j in grp]))
        perm.extend(grp)
        i += len(grp)
    return tuple(kinds), tuple(datas), tuple(scales), perm


def _fold_groups(acc, kinds, datas, scales, wg, *, gains=None) -> torch.Tensor:
    """Fold grouped rows into the running superposition ``acc``.

    ``acc`` None starts a fresh accumulator: the first group's superpose
    is the state, every later group folds in, in group order. ``wg`` and
    ``gains`` are in group order.
    """
    with obs.span("fold", groups=len(kinds)):
        off = 0
        for (kind, qblock), data, scale in zip(kinds, datas, scales):
            kg = scale.shape[0]
            obs.metrics.inc("ota.rows", kg, kind=kind)
            wseg = wg[off : off + kg]
            gseg = None if gains is None else gains[off : off + kg]
            off += kg
            packed4 = kind == "int4"
            if acc is None:
                acc = kota.ota_superpose(
                    data, scale, wseg, gains=gseg, qblock=qblock, packed4=packed4
                )
            else:
                acc = kota.ota_fold(
                    acc, data, scale, wseg, gains=gseg, qblock=qblock, packed4=packed4
                )
    return acc


def _aggregate_rows_flat(
    draws, datas, scales, perm, weights, *, kinds, cfg, gains=None, n_valid
):
    """Aggregate grouped rows: channel draw, group folds, AWGN epilogue.

    Returns (y (n_valid,), habs, participate, noise_std, acc) with ``acc``
    the pre-noise (M,) aggregate.
    """
    if gains is None:
        habs, participate, w = round_channel(draws, weights, cfg=cfg)
        gg = None
    else:
        gains = gains.to(torch.float32)
        participate = gains > 0
        habs = None
        w = weights.to(torch.float32) * participate.to(torch.float32)
        w = w / torch.clamp_min(w.sum(), 1e-12)
        gg = gains[perm]
    idx = torch.as_tensor(perm, dtype=torch.int64, device=w.device)
    acc = _fold_groups(None, kinds, datas, scales, w[idx], gains=gg)
    with obs.span("finalize"):
        y, noise_std = _awgn_epilogue(draws, acc, cfg=cfg, n_valid=n_valid)
    return y, habs, participate, noise_std, acc


@dataclasses.dataclass
class AggregateInfo(Mapping):
    """Typed per-aggregation report; a ``Mapping`` over its present
    (non-None) fields, so ``info["uplink_bytes"]`` works."""

    noise_std: float
    n_participating: Optional[int] = None
    participation: Optional[list] = None
    channel_abs: Optional[list] = None
    channel_gains: Optional[list] = None
    uplink_bytes: Optional[int] = None
    uplink_bytes_f32: Optional[int] = None
    downlink_bytes: Optional[int] = None

    def _present(self) -> Dict[str, Any]:
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None
        }

    def __getitem__(self, key: str) -> Any:
        return self._present()[key]

    def __iter__(self):
        return iter(self._present())

    def __len__(self) -> int:
        return len(self._present())

    def publish(self, registry=None) -> None:
        m = registry or obs.metrics.REGISTRY
        m.inc("ota.aggregations")
        m.set_gauge("ota.noise_std", self.noise_std)
        if self.uplink_bytes is not None:
            m.inc("ota.uplink_bytes", self.uplink_bytes)
        if self.n_participating is not None:
            m.set_gauge("ota.n_participating", self.n_participating)
        if self.participation:
            k = len(self.participation)
            n_trunc = k - sum(bool(p) for p in self.participation)
            m.set_gauge("ota.truncation_rate", n_trunc / k)
            if n_trunc:
                m.inc("ota.rows_truncated", n_trunc)


def ota_aggregate_packed(
    draws: RoundDraws,
    rows: Sequence[packing.PackedRow],
    bits: Optional[Sequence[int]],
    weights,
    layout: packing.Layout,
    cfg: OTAConfig = OTAConfig(),
    *,
    gains=None,
) -> Tuple[Tree, AggregateInfo]:
    """Aggregate pre-packed client rows; unpack the result per ``layout``.

    ``gains``: optional (K,) per-row channel gains in cohort order; they
    replace the coin-flip and ride inside the superpose/fold passes.
    The pre-noise aggregate of the last call stays in
    ``ota_aggregate_packed.last_acc`` for checks.
    """
    if not packing.is_packed_rows(rows):
        raise TypeError("the port aggregates PackedRow cohorts only")
    if bits is not None:
        assert [int(b) for b in bits] == [r.bits for r in rows], (
            "bits arg disagrees with PackedRow.bits"
        )
    device = rows[0].data.device
    kinds, datas, scales, perm = _group_rows(rows)
    w_in = torch.as_tensor(weights, dtype=torch.float32).to(device)
    g_in = None if gains is None else torch.as_tensor(gains).to(device)
    y, habs, participate, noise_std, acc = _aggregate_rows_flat(
        draws, datas, scales, perm, w_in, kinds=kinds, cfg=cfg, gains=g_in,
        n_valid=layout.size,
    )
    ota_aggregate_packed.last_acc = acc
    part = participate.cpu()
    info = AggregateInfo(
        noise_std=float(noise_std),
        n_participating=int(part.sum()),
        participation=[bool(p) for p in part],
        channel_abs=None if habs is None else [float(h) for h in habs.cpu()],
        channel_gains=None if g_in is None else [float(g) for g in g_in.cpu()],
        uplink_bytes=wire.wire_bytes(rows),
        uplink_bytes_f32=4 * layout.padded_size * len(rows),
    )
    info.publish()
    return packing.unpack(y, layout, cast=False), info


ota_aggregate_packed.last_acc = None


def aggregate_plain(
    rows: Sequence[packing.PackedRow], w: torch.Tensor, gains=None
) -> torch.Tensor:
    """The pre-noise aggregate of ``rows`` with final weights ``w`` (cohort
    order), computed with the plain version of every group pass — the
    comparison for the kernel path."""
    kinds, datas, scales, perm = _group_rows(rows)
    idx = torch.as_tensor(perm, dtype=torch.int64, device=w.device)
    wg = w[idx]
    gg = None if gains is None else gains[idx]
    acc = None
    off = 0
    for (kind, qblock), data, scale in zip(kinds, datas, scales):
        kg = scale.shape[0]
        acc = kota.superpose_plain(
            data, scale, wg[off : off + kg],
            gains=None if gg is None else gg[off : off + kg],
            qblock=qblock, packed4=kind == "int4", acc=acc,
        )
        off += kg
    return acc


def final_weights(participation: List[bool], weights, device) -> torch.Tensor:
    """The renormalised combining weights a round used, from its
    participation mask (the same ops as ``round_channel``)."""
    w = torch.as_tensor(weights, dtype=torch.float32).to(device)
    p = torch.as_tensor(participation, dtype=torch.float32).to(device)
    w = w * p
    return w / torch.clamp_min(w.sum(), 1e-12)
