"""The MP-OTA-FL server (the JAX package's ``fl/server.py``): client
selection, context/hardware drift, RAG precision planning, local training
at the planned precision, packed OTA aggregation, the FedAvgM step with
the wire-coded downlink broadcast, and feedback into the RAG databases.

Two round loops share those stages:

- ``FLServer.run_round``, the synchronous barrier: every client trains,
  then one aggregation.
- ``StreamingFLServer.run_round``, the buffered round: every uplink gets a
  simulated arrival time (``fl/client.LatencyModel``), aggregation fires
  on cohort-fill or deadline (``plan_stream``), rows inside the grace
  window fold in late with a staleness discount, all into one
  ``core/ota.OtaAccumulator``. With no deadline and a full fill target it
  is the barrier round bit for bit.

On the fading channel (``FLConfig.channel_model == "fading"``) the round
samples a ``core/channel.ChannelState`` over the selected cohort before
training: truncated clients skip the round, the survivors' receive gains
ride inside the superpose/fold kernels, and each device's realised SNR
and truncation rate become planner features for the next round.

The round key of the reference becomes a round-draws seam
(``core.ota.RoundDraws``): ``draws(seed * 131 + rnd, device)`` gives the
round's dither seeds, channel draws and AWGN normals. The default draws
from ``torch.Generator`` streams; a caller may inject any other source,
such as the reference's own draws.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import ArchConfig, FLConfig, get_arch
from repro_torch.core import channel as chanmod
from repro_torch.core import ota, packing, wire
from repro_torch.core.ota import mix_stream
from repro_torch.core.profiling.hardware import make_fleet
from repro_torch.core.profiling.planner import (
    BasePlanner,
    RAGPlanner,
    UnifiedTierPlanner,
    plan_round,
)
from repro_torch.core.profiling.users import (
    drift_device,
    drift_user,
    make_users,
    satisfaction_score,
    true_performance,
)
from repro_torch.core.tree import tree_map
from repro_torch.data.voice import Utterance, batchify, make_client_shard, make_eval_set
from repro_torch.device import resolve_device
from repro_torch.fl.client import FLClient, LatencyModel
from repro_torch.models.deepspeech2 import ctc_loss, ds2_greedy_decode, ds2_logits
from repro_torch.models.registry import build_model
from repro_torch.optim.optimizers import state_nbytes

Tree = Any
DrawsFactory = Callable[[int, torch.device], ota.RoundDraws]


def make_planner(cfg: FLConfig, device=None) -> BasePlanner:
    if cfg.planner == "unified":
        return UnifiedTierPlanner()
    if cfg.planner == "rag":
        return RAGPlanner(strategy=cfg.strategy, seed=cfg.seed, device=device)
    if cfg.planner == "rag_energy":
        return RAGPlanner(
            strategy=cfg.strategy, energy_priority=8.0, seed=cfg.seed, device=device
        )
    raise ValueError(f"unknown planner {cfg.planner!r}")


def round_rng(seed: int, rnd: int, salt: int = 1237) -> np.random.RandomState:
    """Seeded per-round numpy RNG (dropout draws, latency draws, ...)."""
    return np.random.RandomState(mix_stream(seed, rnd, salt))


def round_drift_rng(seed: int, rnd: int) -> random.Random:
    """Seeded per-round stdlib RNG for the context/hardware drift stage."""
    return random.Random(mix_stream(seed, rnd, 7919))


@dataclasses.dataclass
class RoundLog:
    """Typed per-round report; ``publish`` pushes it into ``obs.metrics``."""

    round: int
    bits: Dict[int, int]
    mean_satisfaction: float
    mean_energy: float
    n_participating: int
    train_loss: float
    uplink_bytes: int = 0
    downlink_bytes: int = 0

    def publish(self, registry=None) -> "RoundLog":
        m = registry or obs.metrics.REGISTRY
        m.inc("fl.rounds")
        m.inc("fl.uplink_bytes", self.uplink_bytes)
        m.inc("fl.downlink_bytes", self.downlink_bytes)
        m.set_gauge("fl.n_participating", self.n_participating)
        if not math.isnan(self.train_loss):
            m.set_gauge("fl.train_loss", self.train_loss)
        m.set_gauge("fl.mean_satisfaction", self.mean_satisfaction)
        m.set_gauge("fl.mean_energy", self.mean_energy)
        return self


class FLServer:
    """Owns the global model and runs the federated rounds.

    ``device=None`` is the CUDA card (raises without one); pass
    ``device="cpu"`` for the plain PyTorch path. ``init_params``: a
    params tree (for example ``convert.params_from_numpy`` of the
    reference's weights); None draws random weights from ``cfg.seed``.
    ``draws``: the round-draws factory (default ``ota.TorchRoundDraws``).
    ``last_round`` keeps the last aggregation's inputs for checks.
    """

    def __init__(
        self,
        fl_cfg: FLConfig,
        arch: Optional[ArchConfig] = None,
        *,
        device=None,
        shard_size: int = 24,
        init_params: Optional[Tree] = None,
        draws: Optional[DrawsFactory] = None,
    ):
        self.device = resolve_device(device)
        self.cfg = fl_cfg
        self.arch = arch or get_arch("deepspeech2")
        self.model = build_model(self.arch)
        self.users = make_users(fl_cfg.n_clients, seed=fl_cfg.seed)
        self.fleet = make_fleet(fl_cfg.n_clients, seed=fl_cfg.seed)
        self.clients = [
            FLClient(
                u,
                s,
                make_client_shard(u, base_size=shard_size, seed=fl_cfg.seed),
                self.model,
            )
            for u, s in zip(self.users, self.fleet)
        ]
        self.planner = make_planner(fl_cfg, self.device)
        if init_params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(fl_cfg.seed)
            self.params = self.model.init(gen, self.device)
        else:
            self.params = tree_map(lambda t: t.to(self.device), init_params)
        self.draws: DrawsFactory = draws or ota.TorchRoundDraws
        self.layout = packing.make_layout(self.params)
        # ``_master``: the f32 optimizer-side params; ``_bcast``: what the
        # clients reconstructed from the last downlink broadcast
        self._master = packing.pack(self.params, self.layout)
        self._bcast = self._master
        self.last_broadcast: Optional[packing.PackedRow] = None
        self.last_downlink_bytes = 0
        if fl_cfg.channel_model == "fading":
            self.channel: Optional[chanmod.ChannelModel] = chanmod.ChannelModel(
                chanmod.ChannelConfig(
                    fade_threshold=fl_cfg.fade_threshold,
                    power_budget=fl_cfg.tx_power_budget,
                    pathloss_spread_db=fl_cfg.pathloss_spread_db,
                )
            )
        elif fl_cfg.channel_model == "ideal":
            self.channel = None
        else:
            raise ValueError(f"unknown channel_model {fl_cfg.channel_model!r}")
        self._chan_hist: Dict[int, List[int]] = {}  # id -> [n_truncated, n_seen]
        self.last_channel: Optional[chanmod.ChannelState] = None
        self.last_round: Dict[str, Any] = {}
        self.round_logs: List[RoundLog] = []

    def _log_round(self, log: RoundLog) -> RoundLog:
        self.round_logs.append(log.publish())
        return log

    def select(self, rnd: int) -> List[int]:
        n = self.cfg.n_clients
        k = self.cfg.clients_per_round
        start = (rnd * k) % n
        return [(start + i) % n for i in range(k)]

    def _apply_drift(self, rnd: int, users, specs) -> None:
        drift_rng = round_drift_rng(self.cfg.seed, rnd)
        for u in users:
            drift_user(u, drift_rng)
        for s in specs:
            drift_device(s, drift_rng)

    def _plan(self, users, specs):
        decisions = plan_round(self.planner.plan_cohort(users, specs))
        bits = {d.user_id: d.bits for d in decisions}
        return decisions, bits

    def _train_cohort(self, decisions, ids: List[int], rnd: int, sr_seed: int,
                      chan_state: Optional[chanmod.ChannelState] = None):
        """Local training at the planned precision (stragglers drop out).

        Returns (deltas, weights, losses, active_ids, row_gains),
        ``deltas[j]`` the wire row of uplink row j. ``chan_state``: the
        round's channel over the cohort (None: ideal); truncated clients
        skip training, and ``row_gains[j]`` is row j's receive gain (None
        on the ideal channel).
        """
        deltas, weights, losses, active_ids = [], [], [], []
        row_gains: Optional[List[float]] = None
        gains_np = habs_np = None
        if chan_state is not None:
            row_gains = []
            gains_np = chan_state.gains.cpu().numpy()
            habs_np = chan_state.habs.cpu().numpy()
        drop_rng = round_rng(self.cfg.seed, rnd)
        for pos, (d, i) in enumerate(zip(decisions, ids)):
            if gains_np is not None and gains_np[pos] <= 0.0:
                continue  # deep fade: truncated, planned around
            if self.cfg.dropout_prob and drop_rng.rand() < self.cfg.dropout_prob:
                continue
            chan_kw = {}
            if gains_np is not None:
                chan_kw = dict(channel_gain=float(gains_np[pos]),
                               channel_habs=float(habs_np[pos]))
            delta, m = self.clients[i].local_update(
                self.params,
                d.bits,
                local_steps=self.cfg.local_steps,
                local_batch=self.cfg.local_batch,
                lr=self.cfg.lr,
                seed=self.cfg.seed * 97 + rnd,
                fedprox_mu=self.cfg.fedprox_mu,
                layout=self.layout,
                sr_seed=sr_seed,
                uplink_row=len(deltas),
                quant_block=self.cfg.quant_block,
                **chan_kw,
            )
            deltas.append(delta)
            if row_gains is not None:
                row_gains.append(m["channel_gain"])
            contrib = 1.0
            if d.levels:
                sel = next((l for l in d.levels if l.bits == d.bits), None)
                if sel is not None:
                    contrib = sel.contribution
            weights.append(m["n_samples"] * contrib)
            losses.append(m["loss_last"])
            active_ids.append(i)
        return deltas, weights, losses, active_ids, row_gains

    def _sample_round_channel(self, draws: ota.RoundDraws, ids: List[int]):
        """This round's channel over the full selected cohort (None on the
        ideal channel). Records each device's realised radio state
        (``channel_snr_db`` EMA, running ``truncation_rate``): planner
        features for the next round."""
        if self.channel is None:
            return None
        with obs.span("channel_sample", cohort=len(ids)):
            state = self.channel.sample(draws, len(ids))
        snr = state.snr_db(self.cfg.snr_db).cpu().numpy()
        trunc = state.truncated.cpu().numpy()
        for pos, i in enumerate(ids):
            hist = self._chan_hist.setdefault(i, [0, 0])
            hist[0] += int(trunc[pos])
            hist[1] += 1
            spec = self.fleet[i]
            spec.truncation_rate = hist[0] / hist[1]
            prev = spec.channel_snr_db
            spec.channel_snr_db = (
                float(snr[pos]) if prev is None else 0.7 * prev + 0.3 * float(snr[pos])
            )
        self.last_channel = state
        return state

    def _gains_tensor(self, row_gains) -> Optional[torch.Tensor]:
        if row_gains is None:
            return None
        return torch.tensor(row_gains, dtype=torch.float32, device=self.device)

    def _apply_update(self, agg: Tree, draws: ota.RoundDraws) -> None:
        """FedAvgM on the flat f32 master, then the wire-coded broadcast
        (f32 passthrough at ``downlink_bits`` >= 32, else the delta
        against the fleet's replica, encoded once with ``dl_seed``)."""
        with obs.span("optimizer"):
            u = packing.pack(agg, self.layout)
            if self.cfg.server_momentum > 0.0:
                if not hasattr(self, "_velocity"):
                    self._velocity = torch.zeros_like(u, dtype=torch.float32)
                v = self.cfg.server_momentum * self._velocity.to(torch.float32) + u
                self._velocity = (
                    v.to(torch.bfloat16) if self.cfg.quantize_server_state else v
                )
                u = v
            self._master = self._master + u

        with obs.span("broadcast_encode", bits=self.cfg.downlink_bits):
            if packing.wire_kind(self.cfg.downlink_bits) == "float32":
                payload = self._master
            else:
                payload = self._master - self._bcast
            row = wire.encode_row(
                payload,
                self.cfg.downlink_bits,
                draws.dl_seed,
                0,
                block=self.cfg.downlink_block,
            )
            self._bcast = wire.decode_broadcast(row, self._bcast)
            self.last_broadcast = row
            self.last_downlink_bytes = row.wire_nbytes
            self.params = packing.unpack(self._bcast, self.layout)

    def model_params_fn(self):
        return self.params

    @property
    def server_state_nbytes(self) -> int:
        v = getattr(self, "_velocity", None)
        return 0 if v is None else state_nbytes(v)

    def _observe_feedback(self, decisions, users, specs):
        sats, energies = [], []
        for d, u, s in zip(decisions, users, specs):
            sat = satisfaction_score(u, s, d.bits)
            perf = true_performance(u, s, d.bits)
            self.planner.observe_feedback(u, s, d.bits, sat, perf)
            sats.append(sat)
            energies.append(perf["energy"])
        return sats, energies

    def run_round(self, rnd: int) -> RoundLog:
        with obs.span("round", round=rnd):
            ids = self.select(rnd)
            users = [self.users[i] for i in ids]
            specs = [self.fleet[i] for i in ids]
            with obs.span("plan", cohort=len(ids)):
                self._apply_drift(rnd, users, specs)
                decisions, bits = self._plan(users, specs)

            draws = self.draws(self.cfg.seed * 131 + rnd, self.device)
            chan_state = self._sample_round_channel(draws, ids)
            with obs.span("client_train"):
                deltas, weights, losses, active_ids, row_gains = self._train_cohort(
                    decisions, ids, rnd, draws.sr_seed, chan_state
                )
            if not deltas:  # everyone dropped or truncated: no aggregation
                return self._log_round(RoundLog(rnd, bits, 0.0, 0.0, 0, float("nan")))

            gains = self._gains_tensor(row_gains)
            agg, info = ota.ota_aggregate_packed(
                draws,
                deltas,
                [bits[self.users[i].user_id] for i in active_ids],
                weights,
                self.layout,
                ota.OTAConfig(snr_db=self.cfg.snr_db),
                gains=gains,
            )
            self.last_round = {"rows": deltas, "weights": weights, "gains": gains,
                               "info": info, "draws": draws}
            self.last_uplink_bytes = info["uplink_bytes"]
            self._apply_update(agg, draws)
            info.downlink_bytes = self.last_downlink_bytes
            with obs.span("feedback"):
                sats, energies = self._observe_feedback(decisions, users, specs)

            return self._log_round(
                RoundLog(
                    round=rnd,
                    bits=bits,
                    mean_satisfaction=float(np.mean(sats)),
                    mean_energy=float(np.mean(energies)),
                    n_participating=info["n_participating"],
                    train_loss=float(np.mean(losses)),
                    uplink_bytes=info["uplink_bytes"],
                    downlink_bytes=self.last_downlink_bytes,
                )
            )

    def run(self, n_rounds: Optional[int] = None, *, verbose: bool = False):
        for r in range(n_rounds or self.cfg.n_rounds):
            log = self.run_round(r)
            if verbose:
                print(
                    f"round {r:3d} loss={log.train_loss:.3f} "
                    f"sat={log.mean_satisfaction:.3f} "
                    f"energy={log.mean_energy:.3f} "
                    f"clients={log.n_participating}"
                )
        return self.round_logs

    @torch.no_grad()
    def evaluate(
        self,
        eval_set: Optional[List[Utterance]] = None,
        batch: int = 24,
        with_loss: bool = False,
    ) -> Dict[str, float]:
        """Per-category char accuracy (and CTC loss with ``with_loss``)."""
        eval_set = eval_set or make_eval_set(seed=self.cfg.seed + 999)
        correct: Dict[str, int] = {}
        total: Dict[str, int] = {}
        loss_sum: Dict[str, float] = {}
        loss_n: Dict[str, int] = {}
        for i in range(0, len(eval_set), batch):
            chunk = eval_set[i : i + batch]
            if len(chunk) < batch:
                chunk = list(chunk) + [chunk[-1]] * (batch - len(chunk))
            b = batchify(chunk, max_frames=320, max_labels=40)
            frames = torch.from_numpy(b["frames"]).to(self.device)
            ids = ds2_greedy_decode(self.params, frames, self.arch).cpu().numpy()
            if with_loss:
                lp = ds2_logits(self.params, frames, self.arch)
                in_len = torch.clamp_max(
                    torch.from_numpy(b["frame_len"] // 4).to(self.device), lp.shape[1]
                )
                labels = torch.from_numpy(b["labels"]).to(self.device)
                label_len = torch.from_numpy(b["label_len"]).to(self.device)
                for j, u in enumerate(chunk):
                    lj = float(
                        ctc_loss(
                            lp[j : j + 1],
                            labels[j : j + 1],
                            in_len[j : j + 1],
                            label_len[j : j + 1],
                        )
                    )
                    loss_sum[u.category] = loss_sum.get(u.category, 0.0) + lj
                    loss_n[u.category] = loss_n.get(u.category, 0) + 1
            for j, u in enumerate(chunk):
                dec = [t for t in ids[j] if t != 0]
                ref = list(u.label_ids)
                n = max(len(ref), 1)
                m = sum(1 for a, b_ in zip(dec, ref) if a == b_)
                correct[u.category] = correct.get(u.category, 0) + m
                total[u.category] = total.get(u.category, 0) + n
        out = {c: correct.get(c, 0) / max(total.get(c, 1), 1) for c in total}
        if with_loss:
            for c in loss_sum:
                out["loss_" + c] = loss_sum[c] / max(loss_n[c], 1)
        return out


# ---------------------------------------------------------------------------
# streaming rounds: event-driven buffered aggregation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """One round's arrival plan (``plan_stream``): ``on_time``/``late``/
    ``lost`` partition the uplink-row indices, ``staleness`` is aligned
    with ``late``; the aggregation fires at ``t_trigger`` and the round
    ends at ``t_close`` (the trigger or the last counted late arrival)."""

    on_time: Tuple[int, ...]
    late: Tuple[int, ...]
    lost: Tuple[int, ...]
    staleness: Tuple[float, ...]
    t_trigger: float
    t_close: float

    @property
    def counted(self) -> Tuple[int, ...]:
        """All folded row indices, in cohort (uplink-row) order."""
        return tuple(sorted(self.on_time + self.late))


def plan_stream(
    times: Sequence[float],
    *,
    fill: int,
    deadline: Optional[float] = None,
    grace: float = 0.0,
    gamma: float = 0.5,
) -> StreamPlan:
    """Plan one buffered round from simulated arrival times (``inf`` =
    never reports). The aggregation fires at the earlier of the
    ``fill``-th arrival and ``deadline``; if neither happens it fires at
    the last finite arrival (the barrier). Rows within ``grace`` seconds
    after the trigger fold late with the discount ``gamma ** (lag /
    grace)``; later ones are lost."""
    t = [float(x) for x in times]
    finite = sorted(x for x in t if math.isfinite(x))
    t_fill = finite[fill - 1] if 0 < fill <= len(finite) else math.inf
    t_trigger = t_fill if deadline is None else min(t_fill, float(deadline))
    if not math.isfinite(t_trigger):
        t_trigger = finite[-1] if finite else 0.0
    g = max(float(grace), 1e-9)
    on_time, late, lost, stale = [], [], [], []
    for j, x in enumerate(t):
        if x <= t_trigger:
            on_time.append(j)
        elif x <= t_trigger + grace:
            late.append(j)
            stale.append(min(1.0, max(min(gamma, 1.0), gamma ** ((x - t_trigger) / g))))
        else:
            lost.append(j)
    t_close = max([t_trigger] + [t[j] for j in late])
    return StreamPlan(
        tuple(on_time), tuple(late), tuple(lost), tuple(stale), t_trigger, t_close
    )


@dataclasses.dataclass
class StreamRoundLog(RoundLog):
    sim_seconds: float = 0.0  # simulated wall-clock of the round
    n_on_time: int = 0
    n_late: int = 0
    n_lost: int = 0

    def publish(self, registry=None) -> "StreamRoundLog":
        m = registry or obs.metrics.REGISTRY
        super().publish(m)
        m.inc("stream.on_time", self.n_on_time)
        m.inc("stream.late", self.n_late)
        m.inc("stream.lost", self.n_lost)
        m.set_gauge("stream.sim_seconds", self.sim_seconds)
        return self


class StreamingFLServer(FLServer):
    """Event-driven buffered round loop (FedBuff-style).

    The select/drift/plan/train stages and their draws are ``FLServer``'s.
    Each uplink then gets a simulated arrival time (``latency``); the
    aggregation triggers on cohort-fill (``fill_fraction``) or
    ``deadline_s``, rows inside ``grace_s`` after it fold in with the
    ``staleness_gamma`` discount, and everything folds into one
    ``ota.OtaAccumulator``. The channel and the weight renormalisation run
    once, over the counted rows in cohort order, so with the defaults
    (full fill, no deadline, no latency dropouts) the round is
    ``FLServer.run_round`` bit for bit. ``last_round["waves"]`` keeps each
    fold's rows, weights, staleness and gains for checks.
    """

    def __init__(
        self,
        fl_cfg: FLConfig,
        arch: Optional[ArchConfig] = None,
        *,
        fill_fraction: float = 1.0,
        deadline_s: Optional[float] = None,
        grace_s: float = 0.0,
        staleness_gamma: float = 0.5,
        latency: Optional[LatencyModel] = None,
        **kw,
    ):
        super().__init__(fl_cfg, arch, **kw)
        self.fill_fraction = fill_fraction
        self.deadline_s = deadline_s
        self.grace_s = grace_s
        self.staleness_gamma = staleness_gamma
        self.latency = latency if latency is not None else LatencyModel()

    def _sample_arrivals(self, deltas, active_ids: List[int], rnd: int) -> List[float]:
        """Simulated arrival time per uplink row (inf = never reports)."""
        lat_rng = round_rng(self.cfg.seed, rnd, salt=4099)
        times = []
        for r, i in zip(deltas, active_ids):
            t = self.latency.sample(self.fleet[i], lat_rng, uplink_bytes=r.wire_nbytes)
            if self.latency.dropped(self.fleet[i], lat_rng):
                t = math.inf
            times.append(t)
        return times

    def run_round(self, rnd: int) -> StreamRoundLog:
        with obs.span("round", round=rnd):
            return self._run_round_inner(rnd)

    def _run_round_inner(self, rnd: int) -> StreamRoundLog:
        ids = self.select(rnd)
        users = [self.users[i] for i in ids]
        specs = [self.fleet[i] for i in ids]
        with obs.span("plan", cohort=len(ids)):
            self._apply_drift(rnd, users, specs)
            decisions, bits = self._plan(users, specs)

        draws = self.draws(self.cfg.seed * 131 + rnd, self.device)
        chan_state = self._sample_round_channel(draws, ids)
        with obs.span("client_train"):
            deltas, weights, losses, active_ids, row_gains = self._train_cohort(
                decisions, ids, rnd, draws.sr_seed, chan_state
            )
        if not deltas:  # everyone dropped or truncated: no aggregation
            return self._log_round(StreamRoundLog(rnd, bits, 0.0, 0.0, 0, float("nan")))

        times = self._sample_arrivals(deltas, active_ids, rnd)
        n = len(deltas)
        fill = n if self.fill_fraction >= 1.0 else max(1, math.ceil(self.fill_fraction * n))
        plan = plan_stream(
            times, fill=fill, deadline=self.deadline_s, grace=self.grace_s,
            gamma=self.staleness_gamma,
        )
        self.last_times, self.last_plan = times, plan
        counted = list(plan.counted)
        if not counted:  # every uplink lost in the air: no aggregation
            return self._log_round(StreamRoundLog(
                rnd, bits, 0.0, 0.0, 0, float("nan"), sim_seconds=plan.t_close, n_lost=n
            ))

        # channel + renormalisation over the counted rows, in cohort order
        ocfg = ota.OTAConfig(snr_db=self.cfg.snr_db)
        w_counted = torch.tensor([weights[j] for j in counted], dtype=torch.float32,
                                 device=self.device)
        g_counted = self._gains_tensor(
            None if row_gains is None else [row_gains[j] for j in counted]
        )
        if g_counted is None:
            _, participate, w = ota.round_channel(draws, w_counted, cfg=ocfg)
        else:
            participate = g_counted > 0
            w = chanmod.combine_weights(w_counted, g_counted)

        pos = {j: p for p, j in enumerate(counted)}

        def _wave(idx, staleness=None):
            sel = torch.tensor([pos[j] for j in idx], dtype=torch.int64, device=self.device)
            return dict(rows=[deltas[j] for j in idx], weights=w[sel], staleness=staleness,
                        gains=None if g_counted is None else g_counted[sel])

        if plan.late:  # the on-time wave at the trigger, then the late wave
            stale = dict(zip(plan.late, plan.staleness))
            late_sorted = sorted(plan.late)
            waves = [_wave(sorted(plan.on_time)),
                     _wave(late_sorted, [stale[j] for j in late_sorted])]
        else:  # one wave: the barrier fold
            waves = [dict(rows=[deltas[j] for j in counted], weights=w, staleness=None,
                          gains=g_counted)]
        acc = ota.OtaAccumulator(self.layout, ocfg)
        for wave in waves:
            acc.fold(wave["rows"], wave["weights"], staleness=wave["staleness"],
                     gains=wave["gains"])
        agg, info = acc.finalize(draws)
        self.last_round = {
            "rows": [deltas[j] for j in counted], "weights": w_counted, "gains": g_counted,
            "waves": waves, "acc": acc.accumulator, "info": info, "draws": draws,
        }
        self.last_uplink_bytes = info["uplink_bytes"]
        self._apply_update(agg, draws)
        info.downlink_bytes = self.last_downlink_bytes
        with obs.span("feedback"):
            sats, energies = self._observe_feedback(decisions, users, specs)

        return self._log_round(
            StreamRoundLog(
                round=rnd,
                bits=bits,
                mean_satisfaction=float(np.mean(sats)),
                mean_energy=float(np.mean(energies)),
                n_participating=int(participate.sum()),
                train_loss=float(np.mean([losses[j] for j in counted])),
                uplink_bytes=info["uplink_bytes"],
                downlink_bytes=self.last_downlink_bytes,
                sim_seconds=plan.t_close,
                n_on_time=len(plan.on_time),
                n_late=len(plan.late),
                n_lost=len(plan.lost),
            )
        )
