"""FL client: local training at the planned precision, then the uplink
encode (the JAX package's ``fl/client.py``).

``local_update`` runs local SGD steps on the model fake-quantized to the
planned bits (straight-through gradients), packs the parameter delta
onto the federation's flat layout, and — given the round's dither seed —
quantizes and bit-packs it into the wire row. Batch draws come from
``np.random.RandomState(seed * 1009 + user_id)``, as in the reference.
The module also holds the seeded ``LatencyModel``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import packing, wire
from repro_torch.core.profiling.hardware import DeviceSpec
from repro_torch.core.profiling.users import UserTruth
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data.voice import ClientShard, batchify
from repro_torch.launch.steps import make_quantized_train_step
from repro_torch.models.registry import Model
from repro_torch.optim import sgd

Tree = Any

# one step function per (arch, bits, lr, fedprox_mu), shared by the clients
_STEP_CACHE: Dict[Tuple[str, int, float, float], Tuple[Callable, Any]] = {}

UPLINK_MBPS: Dict[str, float] = {
    "flagship_phone": 20.0,
    "midrange_phone": 10.0,
    "smart_speaker": 8.0,
    "iot_hub": 2.0,
    "laptop": 40.0,
}


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """Seeded per-round client latency + dropout simulation: lognormal
    compute time over the device's flops, plus the packed row's wire
    bytes over the device class's link rate. All draws come from the
    caller's ``numpy.random.RandomState``."""

    work_flops: float = 5e9
    sigma: float = 0.6
    net_sigma: float = 0.25
    low_battery_slowdown: float = 2.0
    drop_prob: float = 0.0

    @classmethod
    def with_tail(cls, p95_over_p50: float, **kw) -> "LatencyModel":
        return cls(sigma=math.log(p95_over_p50) / 1.645, **kw)

    def p95_over_p50(self) -> float:
        return float(np.exp(1.645 * self.sigma))

    def sample(
        self, spec: DeviceSpec, rng: np.random.RandomState, *, uplink_bytes: int
    ) -> float:
        compute = self.work_flops / (spec.cpu_gflops * 1e9)
        if spec.power_state == "low_battery":
            compute *= self.low_battery_slowdown
        compute *= rng.lognormal(0.0, self.sigma)
        rate = UPLINK_MBPS.get(spec.device_class, 10.0) * 1e6 / 8.0
        uplink = (uplink_bytes / rate) * rng.lognormal(0.0, self.net_sigma)
        return float(compute + uplink)

    def dropped(self, spec: DeviceSpec, rng: np.random.RandomState) -> bool:
        p = self.drop_prob
        if spec.power_state == "low_battery":
            p = min(1.0, 2.0 * p)
        return p > 0 and bool(rng.rand() < p)


@dataclasses.dataclass
class FLClient:
    user: UserTruth
    spec: DeviceSpec
    shard: ClientShard
    model: Model

    def _step_fn(self, bits: int, lr: float, fedprox_mu: float = 0.0):
        key = (self.model.cfg.name, bits, lr, fedprox_mu)
        if key not in _STEP_CACHE:
            opt = sgd(lr)
            step = make_quantized_train_step(self.model, opt, bits, fedprox_mu=fedprox_mu)
            _STEP_CACHE[key] = (step, opt)
        return _STEP_CACHE[key]

    def local_update(
        self,
        global_params: Tree,
        bits: int,
        *,
        local_steps: int = 4,
        local_batch: int = 8,
        lr: float = 5e-4,
        seed: int = 0,
        max_frames: int = 320,
        max_labels: int = 40,
        fedprox_mu: float = 0.0,
        layout: Optional[packing.Layout] = None,
        sr_seed: Optional[int] = None,
        uplink_row: int = 0,
        quant_block: int = 0,
        channel_gain: Optional[float] = None,
        channel_habs: Optional[float] = None,
    ) -> Tuple[Any, Dict[str, float]]:
        """Run local steps; return (delta, metrics).

        With ``layout`` the delta is the packed (padded_size,) f32 row;
        with ``sr_seed`` too it is the ``PackedRow`` wire row at ``bits``
        (row ``uplink_row`` of the round's dither stream, blockwise scales
        every ``quant_block`` symbols). Without ``layout``: the delta tree.
        ``channel_gain``/``channel_habs``: this round's channel state for the
        client, echoed into the metrics (the radio report beside the row).
        """
        step, opt = self._step_fn(bits, lr, fedprox_mu)
        device = tree_leaves(global_params)[0].device
        state = {
            "params": global_params,
            "opt": opt.init(global_params),
            "step": 0,
        }
        if fedprox_mu > 0.0:
            state["anchor"] = global_params
        rng = np.random.RandomState(seed * 1009 + self.user.user_id)
        losses = []
        utts = self.shard.utterances
        for _ in range(local_steps):
            idx = rng.randint(0, len(utts), size=min(local_batch, len(utts)))
            batch = batchify(
                [utts[i] for i in idx], max_frames=max_frames, max_labels=max_labels
            )
            batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        delta = tree_map(
            lambda new, old: new.to(torch.float32) - old.to(torch.float32),
            state["params"],
            global_params,
        )
        if layout is not None:
            delta = packing.pack(delta, layout)
            if sr_seed is not None:
                with obs.span("uplink_encode", bits=bits):
                    delta = wire.encode_row(
                        delta, bits, sr_seed, uplink_row, block=quant_block
                    )
        metrics = {
            "loss_first": losses[0],
            "loss_last": losses[-1],
            "n_samples": len(utts),
        }
        if channel_gain is not None:
            metrics["channel_gain"] = float(channel_gain)
        if channel_habs is not None:
            metrics["channel_habs"] = float(channel_habs)
        return delta, metrics
