"""Meshes (the JAX package's ``launch/mesh.py``): the data mesh of the
sharded data planes and the model zoo's pod meshes.

The reference's mesh is a ``jax.sharding.Mesh`` driven by one controller:
one call places each shard's operands on its device and returns the whole
result. The port keeps that design. A mesh is an array of devices, the
sharded paths launch each shard's work on its device from the calling
process, and the combine is a copy back, so no collective (and no
``torch.distributed`` process group, which takes one rank per GPU) is
needed.

- ``DataMesh`` (``make_data_mesh``): the OTA fold's symbol axis and the
  retrieval arena's row axis place over the ``data`` axis of a 1-D mesh
  (DESIGN.md §15).
- ``Mesh`` (``make_mesh``, ``make_production_mesh``, ``make_host_mesh``):
  an N-D array of devices with named axes, which the sharding specs
  (``launch/sharding.py``), the MoE expert-parallel path and the dry run
  (``launch/dryrun.py``) read. A device may repeat (several shards on one
  card, or ``"cpu"``) or be ``"meta"`` (shapes only, for the dry run).

The reference's v5e constants are a TPU's numbers and are not ported; the
card's own (an H100 SXM's) are ``CARD_*`` below.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
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


# -------------------------------------------------------------- pod meshes


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An N-D mesh: shard ``idx`` (one index per axis) lives on
    ``devices[idx]``, a numpy object array of ``torch.device``s of the
    mesh's shape. ``axis_sizes``, ``shape`` and ``empty`` read as on the
    reference's mesh."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def axis_sizes(self) -> Tuple[int, ...]:
        return tuple(self.devices.shape)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def empty(self) -> bool:
        return self.devices.size == 0


def make_mesh(shape, axes, devices: Optional[Sequence] = None) -> Mesh:
    """An N-D mesh of ``shape`` with axis names ``axes``, devices in
    row-major order.

    ``devices=None`` spans the first ``prod(shape)`` visible CUDA devices,
    one shard a card, and raises ``ValueError`` where fewer are visible
    (as the reference does where the devices do not fill the mesh). An
    explicit ``devices`` lists one device a shard and may repeat a device
    (``["cpu"] * 8``, ``[cuda:0] * 4``) or name ``"meta"``.
    """
    shape = tuple(int(n) for n in shape)
    axes = tuple(axes)
    if len(shape) != len(axes) or any(n < 1 for n in shape):
        raise ValueError(f"mesh shape {shape} does not fit axes {axes}")
    n = math.prod(shape)
    if devices is None:
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > avail:
            raise ValueError(
                f"mesh {shape} needs {n} devices but only {avail} CUDA devices are visible; "
                "pass devices= to place several shards on one device")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [_indexed(resolve_device(d)) for d in devices]
        if len(devs) != n:
            raise ValueError(f"mesh {shape} of {n} shards given {len(devs)} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axes)


def _production_shape(multi_pod: bool):
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh, (16, 16) over ("data", "model"), or with
    ``multi_pod`` (2, 16, 16) over ("pod", "data", "model"): one card a
    shard, so it raises ``ValueError`` on a machine with fewer cards. The
    dry run builds the same shape on ``"meta"`` devices."""
    return make_mesh(*_production_shape(multi_pod))


def make_host_mesh() -> Mesh:
    """A (1, 1) ("data", "model") mesh on the default device (the card;
    raises without one, as every entry point). The axes exist with size 1."""
    return make_mesh((1, 1), ("data", "model"), devices=[resolve_device(None)])


# The card's rates and memory (an H100 SXM: HBM3, dense bf16 on the tensor
# cores, f32 outside them), for the bounds of the dry run and chip_smoke.py.
CARD_HBM_BYTES_PER_S = 3.35e12
CARD_BF16_FLOPS = 989e12
CARD_F32_FLOPS = 67e12
CARD_HBM_BYTES = 80 * 10**9
