"""Mixed-precision Over-the-Air aggregation (the JAX package's
``core/ota.py``): the packed barrier path, the one-shot f32 path, and the
streaming accumulator.

- **Packed rows** (``ota_aggregate_packed`` on ``PackedRow`` inputs): the
  cohort's wire rows are grouped by (storage class, qblock) in the
  reference's order (a stable sort on ``(KIND_RANK, qblock)``); the first
  group's superpose *is* the accumulator and every later group folds into
  it (a left-associated sum, ``kernels/ota_fused.py``); the receiver AWGN
  is calibrated to the aggregate's norm and added; the result unpacks to
  the update tree.
- **The f32 matrix** (``ota_aggregate_flat``, reached by ``ota_aggregate``
  on update trees): one pass quantizes every row in place against the
  round's dither, dequantizes, superposes and returns the aggregate's
  sum of squares, which calibrates the AWGN.
- **Streaming** (``OtaAccumulator``): waves of packed rows fold into one
  persistent accumulator through the same group folds; a single wave in
  cohort order is the barrier aggregate bit for bit.
- **Sharded** (``mesh=`` on ``ota_aggregate_packed`` and
  ``OtaAccumulator``, a ``launch.mesh.DataMesh``): each group pass splits
  the symbol axis into column chunks, one a shard on its device, and the
  chunks concatenate before the epilogue, bit for bit the unsharded fold
  (``_fold_groups``).
- **The per-tree oracle** (``ota_aggregate_pertree``): the reference's
  legacy per-client, per-leaf loop, the readable specification of the
  f32 path, kept for equivalence checks.

``use_kernel`` (on ``ota_aggregate_flat``, ``ota_aggregate_packed``,
``ota_aggregate`` and ``OtaAccumulator``) takes the reference's keyword:
False runs the kernels' plain PyTorch versions on any device, a CUDA
tensor included, and launches nothing; True or None dispatch by device
(``kernels/_build.on_card``): a CUDA tensor launches the kernel or raises,
a CPU tensor runs the plain version (the port's stand-in for the
reference's interpret-mode kernel).

Randomness comes through the round-draws seam (``RoundDraws``): the
uplink and downlink dither seeds, the channel coin-flip, the fading
magnitudes and the AWGN normals. ``TorchRoundDraws`` draws them from
``torch.Generator`` streams; a caller (a parity test) may hand in any
other draws, such as the reference's own ``jax.random`` streams, which
PyTorch cannot reproduce.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.core import channel as chan
from repro_torch.core import packing, wire
from repro_torch.core.quant import _f32, qrange, ref_qmax, sr_dither
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.kernels import ota_fused as kota

Tree = Any

# stream tags of TorchRoundDraws (the fading stream's is channel.CHANNEL_STREAM)
_COIN_STREAM = 0xC01F
_NOISE_STREAM = 0xA3C5


@dataclasses.dataclass(frozen=True)
class OTAConfig:
    snr_db: float = 20.0
    fade_threshold: float = 0.1  # |h|^2 truncation threshold
    max_bits: int = 32


def mix_stream(*parts: int) -> int:
    """Hash-combine stream coordinates into one 32-bit RNG seed
    (Boost-style avalanche mix)."""
    h = 0
    for p in parts:
        h ^= (int(p) & 0xFFFFFFFF) + 0x9E3779B9 + \
            ((h << 6) & 0xFFFFFFFF) + (h >> 2)
        h &= 0xFFFFFFFF
    return h


class RoundDraws:
    """One round's random draws (the seam the reference's round key fills).

    ``sr_seed``/``dl_seed``: uint32 dither seeds of the uplink and the
    downlink; ``channel(K, fade_threshold)`` -> (|h| (K,), participate
    (K,) bool), the ideal channel's coin-flip over the reporting rows;
    ``fading_habs(n, pathloss_spread_db)`` -> |h| (n,), the fading
    channel's magnitudes over the selected cohort; ``awgn(n)`` -> n
    standard normals. Each is its own stream: drawing one never shifts
    another.
    """

    sr_seed: int
    dl_seed: int

    def channel(self, k: int, fade_threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def fading_habs(self, n: int, pathloss_spread_db: float) -> torch.Tensor:
        raise NotImplementedError

    def awgn(self, n: int) -> torch.Tensor:
        raise NotImplementedError


class TorchRoundDraws(RoundDraws):
    """Draws from ``torch.Generator`` streams, each a pure function of
    ``seed`` and its stream tag (a repeated call returns the same draw):
    the dither seeds from a generator on ``device`` seeded with ``seed``;
    the coin-flip and the fading magnitudes (K values each) from host
    generators, so that the channel realisation (participation,
    truncation, the planner's channel features) is the same on every
    device; the AWGN (M values) from a generator on ``device``."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        seeds = torch.randint(
            0, 2**32, (2,), generator=gen, device=self.device, dtype=torch.int64
        ).tolist()
        self.sr_seed, self.dl_seed = int(seeds[0]), int(seeds[1])

    def _gen(self, tag: int, device="cpu") -> torch.Generator:
        gen = torch.Generator(device=device)
        gen.manual_seed(mix_stream(self.seed, tag))
        return gen

    def channel(self, k, fade_threshold):
        h = torch.randn((2, k), generator=self._gen(_COIN_STREAM)) * math.sqrt(0.5)
        h2 = h[0] * h[0] + h[1] * h[1]
        return torch.sqrt(h2).to(self.device), (h2 >= fade_threshold).to(self.device)

    def fading_habs(self, n, pathloss_spread_db):
        gen = self._gen(chan.CHANNEL_STREAM)
        h = torch.randn((2, n), generator=gen) * math.sqrt(0.5)
        h2 = h[0] * h[0] + h[1] * h[1]
        if pathloss_spread_db > 0.0:
            shadow_db = torch.randn((n,), generator=gen) * pathloss_spread_db
            h2 = h2 * 10.0 ** (shadow_db / 10.0)
        return torch.sqrt(h2).to(self.device)

    def awgn(self, n):
        gen = self._gen(_NOISE_STREAM, self.device)
        return torch.randn((n,), generator=gen, device=self.device)


def round_channel(
    draws: RoundDraws, weights: torch.Tensor, *, cfg: OTAConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Channel draw + FedAvg weight renormalisation -> (habs, participate, w)."""
    habs, participate = draws.channel(int(weights.shape[0]), cfg.fade_threshold)
    return habs, participate, chan.combine_weights(weights, participate.to(weights.device))


def _awgn_epilogue(
    draws: RoundDraws, acc: torch.Tensor, *, cfg: OTAConfig, n_valid: int, sumsq=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Receiver AWGN on the combined aggregate: noise std set so that the
    per-element SNR matches ``cfg.snr_db`` (padding is exact zeros).
    ``sumsq``: the aggregate's sum of squares where a kernel already
    produced it (the f32 path); computed here otherwise."""
    if sumsq is None:
        sumsq = (acc * acc).sum()
    nv = torch.tensor(float(n_valid), dtype=torch.float32, device=acc.device)
    noise_std = torch.sqrt(sumsq / nv * (10 ** (-cfg.snr_db / 10)))
    noise = draws.awgn(n_valid).to(device=acc.device, dtype=torch.float32)
    return acc[:n_valid] + noise_std * noise, noise_std


def _client_grid(bits: Sequence[int], amax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row analog grid (scale (K,), qmax (K,)) from the bits and each
    row's amax. qmax == 0 marks an unquantized (bits >= 32) row, scale 1.

    qmax is the reference's compiled ``exp2(f32(b - 1)) - 1`` (``ref_qmax``,
    not an integer for many widths), evaluated on the host; the scale is a
    true f32 division of two device tensors.
    """
    qmax = torch.tensor(
        [ref_qmax(int(b)) if int(b) < 32 else 0.0 for b in bits],
        dtype=torch.float32,
        device=amax.device,
    )
    scale = torch.clamp_min(amax.to(torch.float32), 1e-12) / torch.clamp_min(qmax, 1.0)
    scale = torch.where(qmax > 0, scale, torch.ones_like(scale))
    return scale, qmax


def quantize_uplink(
    row: torch.Tensor,
    bits: int,
    sr_seed: int,
    row_index: int,
    *,
    block: int = 0,
) -> packing.PackedRow:
    """Modulate one client's flat packed row onto the wire: a thin alias
    of ``wire.encode_row``. ``row_index`` is the client's row in the
    round's cohort; ``block`` > 0 ships blockwise scales
    (``packing.QUANT_BLOCK`` is the FL default)."""
    return wire.encode_row(row, bits, sr_seed, row_index, block=block)


def dequantize_uplink(row: packing.PackedRow, n: Optional[int] = None) -> torch.Tensor:
    """Reconstruct the f32 row a ``PackedRow`` encodes (q * scale[block]):
    a thin alias of ``wire.decode_row``; ``n`` trims to the logical
    (unpadded) length."""
    return wire.decode_row(row, n)


def ota_aggregate_flat(
    draws: RoundDraws,
    X: torch.Tensor,
    bits: Sequence[int],
    weights,
    *,
    cfg: OTAConfig,
    n_valid: int,
    use_kernel: Optional[bool] = None,
):
    """One-shot OTA aggregation of the flat (K, M) f32 client-update matrix.

    Rows are zero-padded packed updates; ``n_valid`` is the real parameter
    count. The in-pass quantize-superpose kernel (its plain version with
    ``use_kernel=False``) returns the pre-noise aggregate and its sum of
    squares, which the AWGN epilogue uses as is.
    Returns (y (n_valid,), habs, participate, noise_std, acc).
    """
    X = X.to(torch.float32)
    w_in = torch.as_tensor(weights, dtype=torch.float32).to(X.device)
    habs, participate, w = round_channel(draws, w_in, cfg=cfg)
    scale, qmax = _client_grid(bits, X.abs().amax(dim=1))
    qs = kota.quantize_superpose_plain if use_kernel is False else kota.ota_quantize_superpose
    acc, sumsq = qs(X, scale, qmax, w, draws.sr_seed)
    with obs.span("finalize"):
        y, noise_std = _awgn_epilogue(draws, acc, cfg=cfg, n_valid=n_valid, sumsq=sumsq)
    return y, habs, participate, noise_std, acc


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


def _fold_group(acc, data, scale, wseg, gseg, kind, qblock, use_kernel):
    """One storage group's superpose (``acc`` None) or fold onto ``acc``."""
    kw = dict(gains=gseg, qblock=qblock, packed4=kind == "int4")
    if use_kernel is False:
        return kota.superpose_plain(data, scale, wseg, acc=acc, **kw)
    if acc is None:
        return kota.ota_superpose(data, scale, wseg, **kw)
    return kota.ota_fold(acc, data, scale, wseg, **kw)


def _shard_chunk(M: int, n_shards: int, kinds) -> int:
    """Columns of one shard's chunk in the sharded fold: ceil(M / n_shards)
    rounded up to the lcm of 2 and every blockwise qblock, so each scale
    block and each int4 byte stays inside one chunk."""
    align = 2
    for _, qblock in kinds:
        if qblock > 0:
            align = math.lcm(align, int(qblock))
    mc = -(-M // n_shards)
    return -(-mc // align) * align


def _pad_cols(x: torch.Tensor, width: int, value=0) -> torch.Tensor:
    """x (R, c) padded on the right to ``width`` columns of ``value``."""
    pad = width - x.shape[1]
    if pad <= 0:
        return x
    return torch.cat([x, torch.full((x.shape[0], pad), value, dtype=x.dtype, device=x.device)],
                     dim=1)


def _col_chunk(x: torch.Tensor, lo: int, width: int, value, device) -> torch.Tensor:
    """Columns [lo, lo + width) of x, padded past its end with ``value``,
    as a contiguous tensor on ``device`` (a copy unless it is all of x)."""
    part = _pad_cols(x[:, min(lo, x.shape[1]) : lo + width], width, value)
    return part.contiguous().to(device)


def _fold_groups(acc, kinds, datas, scales, wg, *, gains=None, mesh=None,
                 use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Fold grouped rows into the running superposition ``acc``.

    ``acc`` None starts a fresh accumulator: the first group's superpose
    is the state, every later group folds in, in group order. ``wg`` and
    ``gains`` are in group order. ``use_kernel=False`` runs the plain
    version (``superpose_plain``) on any device.

    ``mesh`` (a ``launch.mesh.DataMesh``) splits the symbol (column) axis
    over its shards, the reference's ``_fold_groups_sharded``. Every output
    column is its own sum over the K rows, so each shard runs the same
    group passes on its chunk of ``_shard_chunk`` columns and the combine
    is a concatenation: the result is the unsharded fold's bit for bit.
    Chunks past the rows' end are zero symbols with unit scales, the
    layout's own padding. Shard s's chunk moves to ``mesh.devices[s]``; the
    running state stays a list of per-shard chunks between groups and is
    gathered onto ``devices[0]`` (in shard order, trimmed to M) only after
    the last group, so the AWGN epilogue's sum of squares sees the
    unsharded vector. No mesh is one chunk: the tensors as they are, no
    copies. One launch a group a shard.
    """
    devices = (None,) if mesh is None else mesh.devices
    n_shards = len(devices)
    M = 0 if acc is None else acc.shape[0]
    for (kind, _), data in zip(kinds, datas):
        M = max(M, data.shape[1] * (2 if kind == "int4" else 1))
    mc = _shard_chunk(M, n_shards, kinds)

    def cut(x, s, width, value):
        return x if mesh is None else _col_chunk(x, s * width, width, value, devices[s])

    def to(x, dev):
        return x if x is None or dev is None else x.to(dev)

    span = (obs.span("shard_fold", shards=n_shards, groups=len(kinds), chunk=mc)
            if n_shards > 1 else obs.span("fold", groups=len(kinds)))
    with span:
        running = ([None] * n_shards if acc is None
                   else [cut(acc.reshape(1, -1), s, mc, 0.0).reshape(-1) for s in range(n_shards)])
        off = 0
        for (kind, qblock), data, scale in zip(kinds, datas, scales):
            kg = scale.shape[0]
            obs.metrics.inc("ota.rows", kg, kind=kind)
            wseg = wg[off : off + kg]
            gseg = None if gains is None else gains[off : off + kg]
            off += kg
            width = mc // 2 if kind == "int4" else mc
            blockwise = qblock > 0 and scale.shape[1] > 1
            for s, dev in enumerate(devices):
                sc_s = cut(scale, s, mc // qblock, 1.0) if blockwise else to(scale, dev)
                running[s] = _fold_group(running[s], cut(data, s, width, 0), sc_s,
                                         to(wseg, dev), to(gseg, dev), kind, qblock, use_kernel)
        if mesh is None:
            return running[0]
        out = torch.cat([r.to(devices[0]) for r in running])
    return out[:M] if out.shape[0] != M else out


def _aggregate_rows_flat(
    draws, datas, scales, perm, weights, *, kinds, cfg, gains=None, n_valid, mesh=None,
    use_kernel=None
):
    """Aggregate grouped rows: channel draw, group folds, AWGN epilogue.

    With ``gains`` the physical channel replaces the coin-flip:
    participation is gains > 0 and the weights renormalise over the
    survivors (``channel.combine_weights``). ``mesh``: the folds shard
    their symbol axis over it; the epilogue runs on the gathered aggregate.
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
        w = chan.combine_weights(weights, gains)
        gg = gains[perm]
    idx = torch.as_tensor(perm, dtype=torch.int64, device=w.device)
    acc = _fold_groups(None, kinds, datas, scales, w[idx], gains=gg, mesh=mesh,
                       use_kernel=use_kernel)
    with obs.span("finalize"):
        y, noise_std = _awgn_epilogue(draws, acc, cfg=cfg, n_valid=n_valid)
    return y, habs, participate, noise_std, acc


def staleness_weights(delays, grace: float, *, gamma: float = 0.5) -> torch.Tensor:
    """Staleness discount gamma ** (delay / grace) for rows arriving
    ``delays`` seconds after the trigger, clipped to [gamma, 1]."""
    d = torch.as_tensor(delays, dtype=torch.float32)
    g = torch.tensor(max(float(grace), 1e-9), dtype=torch.float32)
    p = torch.pow(torch.tensor(gamma, dtype=torch.float32), d / g)
    return torch.clamp(p, min(gamma, 1.0), 1.0)


@dataclasses.dataclass
class AggregateInfo(Mapping):
    """Typed per-aggregation report; a ``Mapping`` over its present
    (non-None) fields, so ``info["uplink_bytes"]`` works."""

    noise_std: float
    n_participating: Optional[int] = None
    participation: Optional[list] = None
    channel_abs: Optional[list] = None  # the coin-flip channel's |h| draws
    channel_gains: Optional[list] = None  # the fading channel's gains
    n_truncated: Optional[int] = None
    n_folded: Optional[int] = None  # rows a streaming accumulator folded
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
        if self.n_folded is not None:
            m.inc("ota.rows_folded", self.n_folded)
        if self.n_participating is not None:
            m.set_gauge("ota.n_participating", self.n_participating)
        if self.participation:
            k = len(self.participation)
            n_trunc = (
                self.n_truncated
                if self.n_truncated is not None
                else k - sum(bool(p) for p in self.participation)
            )
            m.set_gauge("ota.truncation_rate", n_trunc / k)
            if n_trunc:
                m.inc("ota.rows_truncated", n_trunc)
        if self.channel_gains:
            alive = [g for g in self.channel_gains if g > 0]
            if alive:
                m.set_gauge("ota.mean_misalignment", sum(1.0 - g for g in alive) / len(alive))


class OtaAccumulator:
    """Persistent superposition accumulator of a streaming round.

    ``fold`` takes one wave of ``PackedRow`` uplinks with their final
    combining weights (channel-masked and renormalised by the caller),
    optional staleness discounts and channel gains, groups it like the
    barrier path and folds each group into the running (padded_size,)
    state through the superpose/fold kernels. ``finalize`` runs the AWGN
    epilogue and unpacks. One wave in cohort order with ``round_channel``
    weights is ``ota_aggregate_packed`` bit for bit; later waves
    left-associate onto the state. ``use_kernel`` as the module's
    docstring says. ``mesh`` (``launch.mesh.make_data_mesh``): every fold
    shards its symbol axis over it, bit for bit the unsharded fold; the
    state is kept gathered on ``mesh.devices[0]`` and split again at the
    next fold.
    """

    def __init__(self, layout: packing.Layout, cfg: OTAConfig = OTAConfig(), *,
                 mesh=None, use_kernel: Optional[bool] = None):
        self.layout = layout
        self.cfg = cfg
        self.mesh = mesh
        self.use_kernel = use_kernel
        self.reset()

    def reset(self) -> None:
        """Clear the running state (fresh round)."""
        self._acc: Optional[torch.Tensor] = None
        self.n_folded = 0
        self.wire_bytes = 0

    @property
    def accumulator(self) -> torch.Tensor:
        """The running pre-noise aggregate (zeros before any fold)."""
        if self._acc is None:
            return torch.zeros((self.layout.padded_size,), dtype=torch.float32)
        return self._acc

    def fold(
        self, rows: Sequence[packing.PackedRow], weights, *, staleness=None, gains=None
    ) -> "OtaAccumulator":
        """Fold one wave into the state; a wave whose gains are all 0 adds
        exact zeros. Returns self."""
        if len(rows) == 0:
            return self
        device = rows[0].data.device
        w = torch.as_tensor(weights, dtype=torch.float32).to(device)
        if staleness is not None:
            for s in staleness:
                obs.metrics.observe("stream.staleness_discount", float(s))
            w = w * torch.as_tensor(staleness, dtype=torch.float32).to(device)
        kinds, datas, scales, perm = _group_rows(rows)
        idx = torch.as_tensor(perm, dtype=torch.int64, device=device)
        g = None if gains is None else torch.as_tensor(gains).to(device, torch.float32)[idx]
        self._acc = _fold_groups(self._acc, kinds, datas, scales, w[idx], gains=g,
                                 mesh=self.mesh, use_kernel=self.use_kernel)
        self.n_folded += len(rows)
        self.wire_bytes += wire.wire_bytes(rows)
        return self

    def finalize(self, draws: RoundDraws) -> Tuple[Tree, AggregateInfo]:
        """AWGN epilogue on the accumulated superposition -> (update tree
        with f32 leaves, ``AggregateInfo``); the state stays intact."""
        assert self._acc is not None, "finalize() before any fold()"
        with obs.span("finalize"):
            y, noise_std = _awgn_epilogue(
                draws, self._acc, cfg=self.cfg, n_valid=self.layout.size
            )
        info = AggregateInfo(
            noise_std=float(noise_std),
            n_folded=self.n_folded,
            uplink_bytes=self.wire_bytes,
            uplink_bytes_f32=4 * self.layout.padded_size * self.n_folded,
        )
        info.publish()
        return packing.unpack(y, self.layout, cast=False), info


def _participation_info(participate, noise_std, **kw) -> AggregateInfo:
    part = participate.cpu()
    return AggregateInfo(
        noise_std=float(noise_std),
        n_participating=int(part.sum()),
        participation=[bool(p) for p in part],
        **kw,
    )


def ota_aggregate_packed(
    draws: RoundDraws,
    X,
    bits: Optional[Sequence[int]],
    weights,
    layout: packing.Layout,
    cfg: OTAConfig = OTAConfig(),
    *,
    gains=None,
    mesh=None,
    use_kernel: Optional[bool] = None,
) -> Tuple[Tree, AggregateInfo]:
    """Aggregate flat client updates; unpack the result per ``layout``.

    ``X``: a sequence of ``PackedRow`` (quantized at the client; the pass
    only dequantizes), or the (K, M) f32 matrix (quantized inside the pass
    against ``draws.sr_seed``, ``ota_aggregate_flat``). ``gains``: optional
    (K,) per-row channel gains in cohort order, packed rows only; they
    replace the coin-flip and ride inside the superpose/fold passes.
    ``mesh``: optional ``launch.mesh.DataMesh``, packed rows only: the
    folds shard their symbol axis over it, bit for bit the unsharded
    aggregate (the epilogue runs on the gathered accumulator).
    The pre-noise aggregate of the last call stays in
    ``ota_aggregate_packed.last_acc`` for checks.
    """
    if not packing.is_packed_rows(X):
        if gains is not None:
            raise ValueError("gains= is a packed-uplink feature (PackedRow cohorts only)")
        if mesh is not None:
            raise ValueError("mesh= is a packed-uplink feature (PackedRow cohorts only)")
        if bits is None:
            raise ValueError("the f32 matrix needs the per-row bits")
        y, habs, participate, noise_std, acc = ota_aggregate_flat(
            draws, X, bits, weights, cfg=cfg, n_valid=layout.size, use_kernel=use_kernel
        )
        info = _participation_info(
            participate, noise_std, channel_abs=[float(h) for h in habs.cpu()]
        )
    else:
        rows: Sequence[packing.PackedRow] = X
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
            n_valid=layout.size, mesh=mesh, use_kernel=use_kernel,
        )
        wire_kw = dict(
            uplink_bytes=wire.wire_bytes(rows),
            uplink_bytes_f32=4 * layout.padded_size * len(rows),
        )
        if g_in is None:
            info = _participation_info(
                participate, noise_std, channel_abs=[float(h) for h in habs.cpu()], **wire_kw
            )
        else:
            info = _participation_info(
                participate, noise_std,
                n_truncated=int((~participate).sum()),
                channel_gains=[float(g) for g in g_in.cpu()],
                **wire_kw,
            )
    ota_aggregate_packed.last_acc = acc
    info.publish()
    return packing.unpack(y, layout, cast=False), info


ota_aggregate_packed.last_acc = None


def ota_aggregate(
    draws: RoundDraws,
    updates: Sequence[Tree],
    bits: Sequence[int],
    weights,
    cfg: OTAConfig = OTAConfig(),
    *,
    layout: Optional[packing.Layout] = None,
    use_kernel: Optional[bool] = None,
) -> Tuple[Tree, AggregateInfo]:
    """Aggregate client update trees over the simulated OTA channel.

    Packs the trees once into the (K, M) matrix and runs the one-shot f32
    path (``ota_aggregate_flat``). ``updates`` may also be ``PackedRow``
    wire rows; then ``layout`` is required.
    """
    if packing.is_packed_rows(updates):
        assert layout is not None, "packed rows need an explicit layout"
        return ota_aggregate_packed(draws, updates, bits, weights, layout, cfg,
                                    use_kernel=use_kernel)
    if layout is None:
        layout = packing.make_layout(updates[0])
    X = packing.pack_batch(updates, layout)
    return ota_aggregate_packed(draws, X, bits, weights, layout, cfg, use_kernel=use_kernel)


def ota_aggregate_pertree(
    draws: RoundDraws,
    updates: Sequence[Tree],
    bits: Sequence[int],
    weights,
    cfg: OTAConfig = OTAConfig(),
) -> Tuple[Tree, AggregateInfo]:
    """Reference oracle: the legacy per-client, per-leaf loop.

    The same semantics as the flat path (the same ``sr_dither`` uniforms,
    evaluated over the flat layout and sliced per leaf; the same AWGN
    draw; one analog grid per update) in O(clients x leaves) eager ops.
    The grid is the reference's eager one: ``max(amax, 1e-12) / qrange(b)``,
    a true division by the exact integer, where the flat path multiplies
    by the reciprocal of ``ref_qmax``; a symbol on a rounding boundary can
    therefore land one step apart between the two.
    """
    n = len(updates)
    layout = packing.make_layout(updates[0])
    leaves0, structure = tree_flatten(updates[0])
    device = leaves0[0].device
    w_in = torch.as_tensor(weights, dtype=torch.float32).to(device)
    habs, participate, w = round_channel(draws, w_in, cfg=cfg)

    positions = torch.arange(layout.padded_size, dtype=torch.int64, device=device)
    agg_leaves = [torch.zeros(l.shape, dtype=torch.float32, device=device) for l in leaves0]
    for i in range(n):
        leaves_i = [l.to(torch.float32) for l in tree_leaves(updates[i])]
        b = int(bits[i])
        if b >= 32:
            dq_leaves = leaves_i
        else:
            qmax = _f32(float(qrange(b)), leaves_i[0])
            amax = torch.stack([l.abs().max() for l in leaves_i]).max()
            scale = torch.clamp_min(amax, 1e-12) / qmax
            u_full = sr_dither(draws.sr_seed, i, positions)
            dq_leaves = []
            for leaf, off, size, shape in zip(
                leaves_i, layout.offsets, layout.sizes, layout.shapes
            ):
                u = u_full[off : off + size].reshape(shape)
                scaled = leaf / scale
                floor = torch.floor(scaled)
                q = floor + (u < (scaled - floor)).to(torch.float32)
                q = torch.minimum(torch.maximum(q, -qmax), qmax)
                dq_leaves.append(q * scale)
        wi = w[i]
        agg_leaves = [a + wi * l for a, l in zip(agg_leaves, dq_leaves)]

    total = _f32(float(layout.size), agg_leaves[0])
    agg_norm2 = sum((l * l).sum() for l in agg_leaves)
    noise_std = torch.sqrt(agg_norm2 / total * 10 ** (-cfg.snr_db / 10))
    n_full = draws.awgn(layout.size).to(device=device, dtype=torch.float32)
    noisy = [
        a + noise_std * n_full[off : off + size].reshape(a.shape)
        for a, off, size in zip(agg_leaves, layout.offsets, layout.sizes)
    ]
    info = _participation_info(
        participate, noise_std, channel_abs=[float(h) for h in habs.cpu()]
    )
    return tree_unflatten(structure, noisy), info


def channel_uses(
    bits: Sequence[int], n_params: int, cfg: OTAConfig = OTAConfig()
) -> int:
    """OTA channel uses for one aggregation round: mixed-precision
    modulation shares symbols across precisions, so the round costs
    n_params symbols whatever the clients' bits (it does not sum over
    clients)."""
    return n_params


def digital_uplink_bits(bits: Sequence[int], n_params: int) -> int:
    """Baseline comparison: digital per-client uplink cost (sums over clients)."""
    return int(sum(int(b) * n_params for b in bits))


def aggregate_plain(
    rows: Sequence[packing.PackedRow], w: torch.Tensor, gains=None, acc=None
) -> torch.Tensor:
    """The pre-noise aggregate of ``rows`` with final weights ``w`` (cohort
    order), folded onto ``acc`` (None: a fresh state) with the plain
    version of every group pass — the comparison for the kernel path."""
    kinds, datas, scales, perm = _group_rows(rows)
    idx = torch.as_tensor(perm, dtype=torch.int64, device=w.device)
    wg = w[idx]
    gg = None if gains is None else gains[idx]
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
    participation mask (``round_channel``'s ops)."""
    return chan.combine_weights(weights, torch.as_tensor(participation).to(device))
