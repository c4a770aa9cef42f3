"""The data mesh of the sharded data planes (the JAX package's
``launch/mesh.py``, ``make_data_mesh`` only).

The OTA fold's symbol axis and the retrieval arena's row axis place over
the ``data`` axis of a 1-D mesh (DESIGN.md §15). The reference's mesh is a
``jax.sharding.Mesh`` driven by one controller: one call places each
shard's operands on its device and returns the whole result. The port
keeps that design: a ``DataMesh`` is a tuple of devices, the sharded paths
launch each shard's work on its device from the calling process, and the
combine is a concatenation on ``devices[0]``, so no collective (and no
``torch.distributed`` process group, which takes one rank per GPU) is
needed.

The reference's pod meshes (``make_mesh``, ``make_production_mesh``,
``make_host_mesh``) serve the model zoo's sharding specs and wait for
them; its v5e constants are a TPU's numbers and are not ported (the
card's constants live in ``chip_smoke.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A 1-D mesh over the ``data`` axis: shard ``i`` lives on
    ``devices[i]``. ``shape["data"]`` is the shard count, as on the
    reference's mesh."""

    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices)}

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("data",)


def _indexed(dev: torch.device) -> torch.device:
    """``dev`` with the current CUDA device's index where it names none."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_data_mesh(n_shards: int, devices: Optional[Sequence] = None) -> DataMesh:
    """1-D mesh of ``n_shards`` shards over the ``data`` axis.

    ``devices=None`` spans the first ``n_shards`` visible CUDA devices, one
    shard a card, and raises ``ValueError`` where fewer are visible, as the
    reference does. An explicit ``devices`` lists one device a shard and may
    repeat a device: ``["cpu"] * n`` on the CPU, ``[cuda:0] * n`` on one
    card. That is the port's counterpart of the reference's
    ``--xla_force_host_platform_device_count``: the shards then share one
    device, which checks the sharded paths but buys no speed.
    """
    n = int(n_shards)
    if n < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if devices is None:
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > avail:
            raise ValueError(
                f"mesh of {n} data shards needs {n} devices but only {avail} CUDA devices "
                "visible; pass devices= to place several shards on one device")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    else:
        devs = tuple(_indexed(resolve_device(d)) for d in devices)
        if len(devs) != n:
            raise ValueError(f"mesh of {n} data shards given {len(devs)} devices")
    return DataMesh(devs)
