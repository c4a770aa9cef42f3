"""Simulated users: ground-truth preferences, contexts, and the
satisfaction oracle.

Every simulated user has *hidden* ground truth the planners never see:
sensitivity weights w_f over {accuracy, energy, latency} (Gaussian, per the
paper's §IV-A "Gaussian distributed sensitivity"), an operational context
(paper Table I factors), and a task-category mixture. Planners observe only
interview transcripts and RAG retrievals; the oracle scores what they chose.

Satisfaction oracle = the paper's Eq. (3) evaluated with the TRUE weights
and the TRUE context-modulated performance at the assigned precision.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List

from repro_torch.configs import BITS_TO_LEVEL
from repro_torch.core.profiling.hardware import DeviceSpec

LOCATIONS = ["bedroom", "living_room", "kitchen", "office", "outdoor"]
# Table I: location -> input noise level (0 = quiet, 1 = very noisy)
LOCATION_NOISE = {
    "bedroom": 0.1,
    "living_room": 0.7,
    "kitchen": 0.6,
    "office": 0.3,
    "outdoor": 0.9,
}
TIMES = ["daytime", "nighttime"]
TIME_NOISE = {"daytime": 0.6, "nighttime": 0.2}
TIME_QUANTITY = {"daytime": 0.8, "nighttime": 0.3}
FREQUENCIES = ["low", "medium", "high"]
FREQ_QUANTITY = {"low": 0.2, "medium": 0.5, "high": 0.9}
CATEGORIES = ["entertainment", "smart_home", "general_query", "personal_request"]
# paper Table II global mixture
CATEGORY_PROBS = [0.327, 0.160, 0.319, 0.194]

FACTORS = ("accuracy", "energy", "latency")


@dataclasses.dataclass
class UserTruth:
    user_id: int
    weights: Dict[str, float]  # sensitivity w_f, sums to 1
    location: str
    interaction_time: str
    frequency: str
    category_mix: Dict[str, float]  # personal task-type distribution
    chattiness: float  # how much the user reveals in interviews (0..1)

    @property
    def noise_level(self) -> float:
        noise = 0.6 * LOCATION_NOISE[self.location]
        return min(1.0, noise + 0.4 * TIME_NOISE[self.interaction_time])

    @property
    def data_quantity(self) -> float:
        quantity = 0.5 * FREQ_QUANTITY[self.frequency]
        return quantity + 0.5 * TIME_QUANTITY[self.interaction_time]

    def context_features(self) -> Dict[str, float]:
        f = {
            "loc_" + self.location: 1.0,
            "time_" + self.interaction_time: 1.0,
            "freq_" + self.frequency: 1.0,
        }
        for c, p in self.category_mix.items():
            f["cat_" + c] = p
        return f


_WEIGHT_MEANS = {"accuracy": 1.25, "energy": 0.9, "latency": 0.85}


def _gaussian_weights(rng: random.Random) -> Dict[str, float]:
    """Gaussian-distributed sensitivities (paper §IV-A), clipped positive,
    normalised. Accuracy skews higher — voice assistants that mishear are
    the dominant complaint cause."""
    raw = {f: max(0.05, rng.gauss(_WEIGHT_MEANS[f], 0.45)) for f in FACTORS}
    s = sum(raw.values())
    return {f: v / s for f, v in raw.items()}


def make_users(n: int, seed: int = 0) -> List[UserTruth]:
    rng = random.Random(seed + 1)
    users = []
    for i in range(n):
        # per-user Dirichlet-ish category mixture centred on Table II
        alpha = [p * 6 for p in CATEGORY_PROBS]
        draws = [rng.gammavariate(a, 1.0) for a in alpha]
        tot = sum(draws)
        mix = {c: d / tot for c, d in zip(CATEGORIES, draws)}
        users.append(
            UserTruth(
                user_id=i,
                weights=_gaussian_weights(rng),
                location=rng.choices(LOCATIONS, [0.25, 0.3, 0.15, 0.2, 0.1])[0],
                interaction_time=rng.choices(TIMES, [0.65, 0.35])[0],
                frequency=rng.choices(FREQUENCIES, [0.3, 0.4, 0.3])[0],
                category_mix=mix,
                chattiness=rng.uniform(0.4, 1.0),
            )
        )
    return users


# ---------------------------------------------------------------------------
# performance model at precision level q (ground truth, context-modulated)
# ---------------------------------------------------------------------------


# Device-class deviations from the analytic priors — reality the planner
# can only learn through the Hardware-Quantization-Performance DB (a
# smart speaker's far-field mic array is noise-robust; an IoT hub's DSP
# handles low-bit inference poorly; flagship NPUs have fast int8 paths).
_CLASS_ACC_DEV = {
    "smart_speaker": {4: +0.06, 8: +0.04, 16: 0.0, 32: 0.0},
    "iot_hub": {4: -0.10, 8: -0.05, 16: 0.0, 32: 0.0},
    "flagship_phone": {4: +0.03, 8: +0.03, 16: 0.0, 32: 0.0},
}
_CLASS_LAT_DEV = {
    "flagship_phone": {4: -0.08, 8: -0.08, 16: -0.04, 32: 0.0},
    "iot_hub": {4: +0.05, 8: +0.05, 16: 0.0, 32: 0.0},
}


def true_performance(user: UserTruth, spec: DeviceSpec, bits: int) -> Dict[str, float]:
    """Realised (accuracy_utility, energy_cost, latency_cost), all in [0,1].

    Accuracy degrades faster at low precision in noisy contexts (quantized
    ASR is less robust to noise); energy/latency follow the analytic model
    scaled by device efficiency, plus device-class deviations the analytic
    priors do NOT capture (the HQP database's reason to exist).
    """
    lvl = BITS_TO_LEVEL[bits]
    noise = user.noise_level
    acc = lvl.rel_accuracy - lvl.noise_sensitivity * noise
    acc += _CLASS_ACC_DEV.get(spec.device_class, {}).get(bits, 0.0)
    acc = max(0.0, min(1.0, acc))
    # energy cost relative to running this device at 32-bit
    dev_scale = spec.energy_per_mac_pj / 3.0
    energy = min(1.0, lvl.rel_energy * (0.8 + 0.2 * dev_scale))
    # latency: slower devices feel quantization relief more
    speed = 250.0 / max(spec.cpu_gflops, 1.0)
    latency = lvl.rel_latency * (0.7 + 0.3 * min(speed, 2.0) / 2.0)
    latency += _CLASS_LAT_DEV.get(spec.device_class, {}).get(bits, 0.0)
    latency = max(0.0, min(1.0, latency))
    return {"accuracy": acc, "energy": energy, "latency": latency}


def eq3_score(
    weights: Dict[str, float],
    perf: Dict[str, float],
    *,
    contribution: float = 1.0,
    energy_priority: float = 1.0,
) -> float:
    """The paper's reward-penalty model, Eqs (1)-(3) — shared by the
    oracle (true weights, C_q=1) and the planner (estimates).

    Rewards R_f(q): accuracy utility, energy *saving* (1-E), latency
    *saving* (1-L) — the benefits of operating at level q.
    Penalties P_f(q): accuracy loss, energy cost (scaled by the server's
    energy-priority knob), latency cost.

        Score = C_q * sum_f w_f R_f  -  sum_f w_f P_f
    """
    w = weights
    acc, e, lat = perf["accuracy"], perf["energy"], perf["latency"]
    r_total = contribution * (
        w["accuracy"] * acc + w["energy"] * (1.0 - e) + w["latency"] * (1.0 - lat)
    )
    p_total = (
        w["accuracy"] * (1.0 - acc)
        + w["energy"] * e * energy_priority
        + w["latency"] * lat
    )
    return r_total - p_total


def satisfaction_score(user: UserTruth, spec: DeviceSpec, bits: int) -> float:
    """Oracle satisfaction: Eq. (3) with ground-truth weights and realised
    context-modulated performance (C_q = 1, no server priority)."""
    return eq3_score(user.weights, true_performance(user, spec, bits))


def best_possible_bits(user: UserTruth, spec: DeviceSpec) -> int:
    """Oracle-optimal precision (upper bound for planner evaluation)."""
    return max(spec.supported_bits, key=lambda b: satisfaction_score(user, spec, b))


# ---------------------------------------------------------------------------
# context drift (paper §III-A: "potential context change since the last
# feedback collection")
# ---------------------------------------------------------------------------


def drift_user(
    user: UserTruth,
    rng: random.Random,
    p_move: float = 0.08,
    p_schedule: float = 0.10,
) -> bool:
    """Mutate a user's operational context in place.

    Users occasionally relocate the device (bedroom -> kitchen changes the
    noise profile) or shift usage schedule (new job -> nighttime user).
    Returns True when anything changed — the FL server uses this to
    trigger a re-interview, exactly the paper's second interview trigger.
    """
    changed = False
    if rng.random() < p_move:
        user.location = rng.choice([l for l in LOCATIONS if l != user.location])
        changed = True
    if rng.random() < p_schedule:
        user.interaction_time = (
            "nighttime" if user.interaction_time == "daytime" else "daytime"
        )
        changed = True
    if rng.random() < 0.05:
        user.frequency = rng.choice([f for f in FREQUENCIES if f != user.frequency])
        changed = True
    return changed


def drift_device(spec: DeviceSpec, rng: random.Random) -> bool:
    """Power-state transitions (the paper's third trigger: changed
    hardware specifications -> prompt the user to update context)."""
    old = spec.power_state
    r = rng.random()
    if spec.power_state == "low_battery" and r < 0.5:
        spec.power_state = "charging"
    elif spec.power_state == "charging" and r < 0.6:
        spec.power_state = "normal"
    elif spec.power_state == "normal" and r < 0.1:
        spec.power_state = rng.choice(["low_battery", "charging"])
    return spec.power_state != old
