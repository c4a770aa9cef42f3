"""Physical OTA channel: block fading, truncated channel inversion under a
transmit power budget, and the resulting misalignment (the JAX package's
``core/channel.py``).

Per client k and round the channel magnitude |h_k| is Rayleigh, optionally
times a log-normal shadowing term. Clients with |h_k|^2 below
``fade_threshold`` cannot invert their channel and are truncated (gain 0,
excluded from the FedAvg renormalisation). Survivors pre-scale by
rho / |h_k|, capped at sqrt(power_budget); a capped client arrives with
gain g_k = |h_k| a_k / rho < 1. The per-row gain vector rides inside the
superpose/fold kernels as their gains column.

The module draws nothing: ``ChannelModel.sample`` takes the round's draws
(``core.ota.RoundDraws.fading_habs``), whose fading stream is separate
from the dither seeds, the coin-flip and the AWGN, so turning the channel
on leaves those unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

# stream tag of the fading draw (mixed into the round seed)
CHANNEL_STREAM = 0x0C4A17
_TINY = 1e-12


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """fade_threshold: truncation threshold on |h_k|^2; rho: the common
    alignment amplitude at the receiver; power_budget: per-client maximum
    transmit power P (amplitude capped at sqrt(P)); pathloss_spread_db:
    std (dB) of the log-normal shadowing on the channel power, 0 = none."""

    fade_threshold: float = 0.1
    rho: float = 1.0
    power_budget: float = 100.0
    pathloss_spread_db: float = 0.0


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class ChannelState:
    """One round's channel over a K-client cohort: habs (K,) |h_k|, gains
    (K,) receive gain in [0, 1] (0 = truncated), tx_amp (K,) transmit
    amplitude (0 when truncated)."""

    habs: torch.Tensor
    gains: torch.Tensor
    tx_amp: torch.Tensor

    @property
    def truncated(self) -> torch.Tensor:
        return self.gains <= 0

    @property
    def n_truncated(self) -> int:
        return int(self.truncated.sum())

    @property
    def misalignment(self) -> torch.Tensor:
        """(K,) 1 - g_k over survivors, 0 for truncated clients."""
        zero = torch.zeros_like(self.gains)
        return torch.where(self.truncated, zero, 1.0 - self.gains)

    def snr_db(self, snr_db: float) -> torch.Tensor:
        """(K,) effective receive SNR (dB): the receiver SNR shifted by the
        realised channel power, the planner's channel feature."""
        h2 = torch.clamp_min(self.habs * self.habs, _TINY)
        return _f32(snr_db, h2) + 10.0 * torch.log10(h2)


def state_from_habs(habs, *, cfg: ChannelConfig) -> ChannelState:
    """Truncated channel inversion of realised magnitudes (draw-free).

    A client exactly at the threshold participates (``>=``). The division
    by the constant rho is a multiply by its f32 reciprocal, as in the
    reference's compiled program.
    """
    habs = torch.as_tensor(habs, dtype=torch.float32)
    participate = habs * habs >= cfg.fade_threshold
    inv = _f32(cfg.rho, habs) / torch.clamp_min(habs, _TINY)
    cap = torch.sqrt(_f32(cfg.power_budget, habs))
    tx_amp = torch.where(participate, torch.minimum(inv, cap), torch.zeros_like(habs))
    recip_rho = float(np.float32(1.0) / np.float32(cfg.rho))
    gains = habs * tx_amp * _f32(recip_rho, habs)
    return ChannelState(habs=habs, gains=gains, tx_amp=tx_amp)


def combine_weights(weights, gains) -> torch.Tensor:
    """FedAvg renormalisation over the surviving clients (gain > 0, or a
    True participation flag) on ``gains``' device; an all-truncated cohort
    gives all-zero weights, not NaN."""
    gains = torch.as_tensor(gains)
    w = torch.as_tensor(weights, dtype=torch.float32).to(gains.device)
    w = w * (gains > 0).to(torch.float32)
    return w / torch.clamp_min(w.sum(), _TINY)


class ChannelModel:
    """Per-round physical channel: ``sample(draws, K)`` turns the round's
    fading draw into a ``ChannelState``. Stateless between rounds, so the
    barrier and the streaming loops see the same state for the same
    draws."""

    def __init__(self, cfg: ChannelConfig = ChannelConfig()):
        self.cfg = cfg

    def sample(self, draws, n_clients: int) -> ChannelState:
        habs = draws.fading_habs(n_clients, self.cfg.pathloss_spread_db)
        return state_from_habs(habs, cfg=self.cfg)

    def combine_weights(self, weights, state: ChannelState) -> torch.Tensor:
        return combine_weights(weights, state.gains)

    def uncontrolled_gains(self, state: ChannelState) -> torch.Tensor:
        """Receive gains with no power control: every client at the full
        budget amplitude, |h_k| sqrt(P) / rho."""
        amp = torch.sqrt(_f32(self.cfg.power_budget, state.habs))
        return state.habs * amp / _f32(self.cfg.rho, state.habs)


def split_survivors(state: ChannelState) -> Tuple[torch.Tensor, torch.Tensor]:
    """(surviving row indices, truncated row indices) as int64 tensors."""
    trunc = state.truncated.cpu().tolist()
    keep = [i for i, t in enumerate(trunc) if not t]
    drop = [i for i, t in enumerate(trunc) if t]
    return torch.tensor(keep, dtype=torch.int64), torch.tensor(drop, dtype=torch.int64)
