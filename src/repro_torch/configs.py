"""Configs of the port: the DeepSpeech2 architecture, the FL experiment
and the precision levels.

The fields and defaults are those of the JAX package's ``configs/base.py``
and ``configs/deepspeech2_paper.py``, cut to what the federated round
reads. Every config is a frozen dataclass, so configs hash and compare.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

# symbols per f32 scale on the uplink wire (blockwise scales)
QUANT_BLOCK = 256


@dataclass(frozen=True)
class ArchConfig:
    """The architecture fields the DeepSpeech2 model reads."""

    name: str
    family: str  # "ds2" is the only family of the port so far
    n_layers: int
    d_model: int
    vocab_size: int
    frontend_dim: int = 0
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class PrecisionLevel:
    """One selectable client precision level (see the JAX package's
    ``configs/base.py`` for the model behind each curve)."""

    bits: int

    @property
    def rel_energy(self) -> float:
        compute = (self.bits / 32.0) ** 0.9
        overhead = (self.bits / 32.0) ** 0.45
        return 0.55 * compute + 0.45 * overhead

    @property
    def rel_latency(self) -> float:
        return 0.5 * (self.bits / 32.0) + 0.5 * (self.bits / 32.0) ** 0.5

    @property
    def rel_accuracy(self) -> float:
        return {4: 0.75, 8: 0.93, 16: 0.99, 32: 1.0}[self.bits]

    @property
    def noise_sensitivity(self) -> float:
        return {4: 0.35, 8: 0.15, 16: 0.05, 32: 0.02}[self.bits]


PRECISION_LEVELS: Tuple[PrecisionLevel, ...] = tuple(
    PrecisionLevel(b) for b in (4, 8, 16, 32)
)
BITS_TO_LEVEL = {p.bits: p for p in PRECISION_LEVELS}


@dataclass(frozen=True)
class FLConfig:
    n_clients: int = 100
    clients_per_round: int = 20
    n_rounds: int = 100
    local_steps: int = 4
    local_batch: int = 8
    lr: float = 5e-4
    strategy: str = "fedavg"  # fedavg | class_equal | majority_centric
    planner: str = "rag"  # rag | unified | rag_energy
    snr_db: float = 20.0
    quant_block: int = QUANT_BLOCK
    seed: int = 0
    # physical OTA channel (core/channel.py): "ideal" is the coin-flip +
    # AWGN path; "fading" draws per-client Rayleigh gains with truncated
    # channel inversion under the transmit power budget
    channel_model: str = "ideal"  # ideal | fading
    fade_threshold: float = 0.1  # |h|^2 truncation threshold
    tx_power_budget: float = 100.0  # per-client max transmit power P
    pathloss_spread_db: float = 0.0  # log-normal shadowing std (dB)
    downlink_bits: int = 32
    downlink_block: int = QUANT_BLOCK
    dropout_prob: float = 0.0
    fedprox_mu: float = 0.0
    server_momentum: float = 0.0
    quantize_server_state: bool = False


def deepspeech2() -> ArchConfig:
    """The paper's DeepSpeech2-style ASR model: 3 bi-GRU layers of 256,
    80 mel features, a 64-symbol vocabulary (arXiv:1512.02595)."""
    return ArchConfig(
        name="deepspeech2",
        family="ds2",
        n_layers=3,
        d_model=256,
        vocab_size=64,
        frontend_dim=80,
    )


ARCH_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {"deepspeech2": deepspeech2}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_REGISTRY)}")
    return ARCH_REGISTRY[name]()
