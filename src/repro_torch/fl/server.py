"""The MP-OTA-FL server (the JAX package's ``fl/server.py``, synchronous
round): client selection, context/hardware drift, RAG precision
planning, local training at the planned precision, packed OTA
aggregation, the FedAvgM step with the wire-coded downlink broadcast, and
feedback into the RAG databases.

The round key of the reference becomes a round-draws seam
(``core.ota.RoundDraws``): ``draws(seed * 131 + rnd, device)`` gives the
round's dither seeds, channel coin-flip and AWGN normals. The default
draws from a ``torch.Generator`` on the device; a caller may inject any
other source, such as the reference's own draws.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import ArchConfig, FLConfig, get_arch
from repro_torch.core import ota, packing, wire
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
from repro_torch.fl.client import FLClient
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


def _mix_stream(*parts: int) -> int:
    """Hash-combine stream coordinates into one 32-bit RNG seed
    (Boost-style avalanche mix)."""
    h = 0
    for p in parts:
        h ^= (int(p) & 0xFFFFFFFF) + 0x9E3779B9 + \
            ((h << 6) & 0xFFFFFFFF) + (h >> 2)
        h &= 0xFFFFFFFF
    return h


def round_rng(seed: int, rnd: int, salt: int = 1237) -> np.random.RandomState:
    """Seeded per-round numpy RNG (dropout draws, latency draws, ...)."""
    return np.random.RandomState(_mix_stream(seed, rnd, salt))


def round_drift_rng(seed: int, rnd: int) -> random.Random:
    """Seeded per-round stdlib RNG for the context/hardware drift stage."""
    return random.Random(_mix_stream(seed, rnd, 7919))


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

    def _train_cohort(self, decisions, ids: List[int], rnd: int, sr_seed: int):
        """Local training at the planned precision (stragglers drop out).
        Returns (deltas, weights, losses, active_ids), ``deltas[j]`` the
        wire row of uplink row j."""
        deltas, weights, losses, active_ids = [], [], [], []
        drop_rng = round_rng(self.cfg.seed, rnd)
        for d, i in zip(decisions, ids):
            if self.cfg.dropout_prob and drop_rng.rand() < self.cfg.dropout_prob:
                continue
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
            )
            deltas.append(delta)
            contrib = 1.0
            if d.levels:
                sel = next((l for l in d.levels if l.bits == d.bits), None)
                if sel is not None:
                    contrib = sel.contribution
            weights.append(m["n_samples"] * contrib)
            losses.append(m["loss_last"])
            active_ids.append(i)
        return deltas, weights, losses, active_ids

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
            with obs.span("client_train"):
                deltas, weights, losses, active_ids = self._train_cohort(
                    decisions, ids, rnd, draws.sr_seed
                )
            if not deltas:
                return self._log_round(RoundLog(rnd, bits, 0.0, 0.0, 0, float("nan")))

            agg, info = ota.ota_aggregate_packed(
                draws,
                deltas,
                [bits[self.users[i].user_id] for i in active_ids],
                weights,
                self.layout,
                ota.OTAConfig(snr_db=self.cfg.snr_db),
            )
            self.last_round = {"rows": deltas, "weights": weights, "info": info}
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
