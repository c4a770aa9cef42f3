"""Simulated client hardware fleet + hardware specification extractor.

The paper's backend has a "hardware specification extractor that collects
device hardware information based on availability and user privacy
settings". Here the fleet is simulated; the extractor exposes exactly the
fields a real agent could read (and respects a per-device privacy flag
that hides some of them, which the RAG retrieval then has to work around
— same failure mode as production).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Tuple

DEVICE_CLASSES: Dict[str, Dict] = {
    # cpu_gflops ~ sustained fp32; energy_per_mac_pj at 32-bit
    "flagship_phone": dict(
        cpu_gflops=250.0,
        ram_gb=12,
        battery_mah=5000,
        supported_bits=(4, 8, 16, 32),
        energy_per_mac_pj=3.0,
    ),
    "midrange_phone": dict(
        cpu_gflops=80.0,
        ram_gb=6,
        battery_mah=4500,
        supported_bits=(4, 8, 16),
        energy_per_mac_pj=4.5,
    ),
    "smart_speaker": dict(
        cpu_gflops=25.0,
        ram_gb=2,
        battery_mah=0,  # mains
        supported_bits=(4, 8, 16),
        energy_per_mac_pj=6.0,
    ),
    "iot_hub": dict(
        cpu_gflops=8.0,
        ram_gb=1,
        battery_mah=2000,
        supported_bits=(4, 8),
        energy_per_mac_pj=8.0,
    ),
    "laptop": dict(
        cpu_gflops=600.0,
        ram_gb=16,
        battery_mah=8000,
        supported_bits=(4, 8, 16, 32),
        energy_per_mac_pj=2.0,
    ),
}

CLASS_MIX = [
    ("flagship_phone", 0.20),
    ("midrange_phone", 0.30),
    ("smart_speaker", 0.25),
    ("iot_hub", 0.15),
    ("laptop", 0.10),
]


@dataclasses.dataclass
class DeviceSpec:
    device_id: int
    device_class: str
    cpu_gflops: float
    ram_gb: float
    battery_mah: float
    supported_bits: Tuple[int, ...]
    energy_per_mac_pj: float
    power_state: str = "normal"  # normal | low_battery | charging
    privacy_hide_specs: bool = False
    # radio state observed by the server per round (core/channel.py,
    # DESIGN.md §12): EMA of the realised per-client receive SNR and the
    # running truncation rate. Server-side measurements, so they survive
    # the privacy flag (nothing the device has to disclose).
    channel_snr_db: Optional[float] = None
    truncation_rate: float = 0.0

    def features(self) -> Dict[str, float]:
        """Numeric feature dict for RAG keys (respecting privacy flag)."""
        if self.privacy_hide_specs:
            # only the coarse class survives privacy settings
            feats = {"class_" + self.device_class: 2.0}
        else:
            # class weighted up: device-class is the dominant predictor
            # of the quantization-performance deviations the HQP DB
            # exists to learn
            feats = {
                "class_" + self.device_class: 2.0,
                "cpu_gflops": self.cpu_gflops / 600.0,
                "ram_gb": self.ram_gb / 16.0,
                "battery": (self.battery_mah or 0) / 8000.0,
                "power_" + self.power_state: 0.5,
            }
        if self.channel_snr_db is not None:
            feats["channel_snr_db"] = self.channel_snr_db / 30.0
            feats["truncation_rate"] = self.truncation_rate
        return feats


def make_fleet(n: int, seed: int = 0) -> List[DeviceSpec]:
    rng = random.Random(seed)
    classes = [c for c, _ in CLASS_MIX]
    probs = [p for _, p in CLASS_MIX]
    fleet = []
    for i in range(n):
        cls = rng.choices(classes, probs)[0]
        base = DEVICE_CLASSES[cls]

        def jitter(v):
            return v * rng.uniform(0.85, 1.15)

        fleet.append(
            DeviceSpec(
                device_id=i,
                device_class=cls,
                cpu_gflops=jitter(base["cpu_gflops"]),
                ram_gb=base["ram_gb"],
                battery_mah=base["battery_mah"],
                supported_bits=base["supported_bits"],
                energy_per_mac_pj=jitter(base["energy_per_mac_pj"]),
                power_state=rng.choices(
                    ["normal", "low_battery", "charging"], [0.7, 0.15, 0.15]
                )[0],
                privacy_hide_specs=rng.random() < 0.1,
            )
        )
    return fleet


def hardware_tier(spec: DeviceSpec) -> str:
    """The unified baseline planner's tiering (hardware capability only)."""
    if spec.cpu_gflops >= 200:
        return "high"
    if spec.cpu_gflops >= 40:
        return "mid"
    return "low"


# unified planner's assignment: each tier runs at its hardware capability
# (a hardware-only planner has no signal that would justify down-bitting)
TIER_BITS = {"high": 16, "mid": 8, "low": 8}


def max_feasible_bits(spec: DeviceSpec) -> int:
    bits = max(spec.supported_bits)
    if spec.power_state == "low_battery":
        bits = min(bits, 8)
    return bits
