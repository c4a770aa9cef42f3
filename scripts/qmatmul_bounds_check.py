#!/usr/bin/env python3
"""Row 6's routes of w TMA cannot load against guard pages: no load past w.

    python3 scripts/qmatmul_bounds_check.py [--library LIB.so]

Needs one CUDA card. A memory checker (``compute-sanitizer --tool
memcheck``) says "Device not supported" on the card this was written for,
so this check maps its own: a backed region of virtual memory with an
unmapped page of the driver's allocation granularity (2 MB on an H100) on
each side (``cuMemAddressReserve``, ``cuMemCreate``, ``cuMemMap``). Each
case's w is placed to end on the last byte of the backed region (its start
then lies 0-15 bytes off 16-byte alignment, by K N), and once to start on
its first byte, and is read through ``ops.qmatmul`` as a tensor over that memory
(``__cuda_array_interface__``): a load past either end of w leaves the
mapping and faults. Both dtypes, the decode and Hopper routes (M 4, 5 and
40), ragged and odd N (13 and 17 at a w 15 and 13 bytes off alignment), K
with a partial last k tile; each output is held
to ``kernels/qmatmul.mismatch``. ``--library`` runs the wrapper on another
build of ``csrc/qmatmul.cu`` (a planted fault of
``scripts/qmatmul_tolerance_probe.py``, which must fault here). Prints one
line a case and ``bounds cases done``; a fault ends the run with an error.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
# (M, K, N); each at both ends of the page, x one element off alignment at
# the odd M
CASES = ((5, 100, 1001), (5, 130, 1008), (5, 64, 24), (4, 4096, 12280), (4, 69, 13),
         (40, 100, 1001), (40, 130, 1009), (40, 70, 33), (40, 67, 17), (300, 4100, 1000))


class _Location(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int), ("id", ctypes.c_int)]


class _AllocProp(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int), ("requestedHandleTypes", ctypes.c_int),
                ("location", _Location), ("win32HandleMetaData", ctypes.c_void_p),
                ("allocFlags", ctypes.c_ubyte * 8)]


class _AccessDesc(ctypes.Structure):
    _fields_ = [("location", _Location), ("flags", ctypes.c_int)]


class _Raw:
    """A tensor's worth of device memory at a raw address."""

    def __init__(self, ptr: int, n: int):
        self.__cuda_array_interface__ = {"shape": (n,), "typestr": "|i1", "data": (ptr, False),
                                         "version": 2}


def guarded_region(device: int, nbytes: int):
    """(base, size): at least nbytes backed, an unmapped page on each side."""
    cu = ctypes.CDLL("libcuda.so.1")

    def ok(rc, what):
        if rc != 0:
            sys.exit(f"{what} failed: CUresult {rc}")

    prop = _AllocProp(type=1, requestedHandleTypes=0, location=_Location(1, device))
    gran = ctypes.c_size_t()
    ok(cu.cuMemGetAllocationGranularity(ctypes.byref(gran), ctypes.byref(prop), 0),
       "cuMemGetAllocationGranularity")
    page = gran.value
    size = -(-nbytes // page) * page
    va = ctypes.c_uint64()
    ok(cu.cuMemAddressReserve(ctypes.byref(va), ctypes.c_size_t(size + 2 * page),
                              ctypes.c_size_t(page), ctypes.c_uint64(0), ctypes.c_ulonglong(0)),
       "cuMemAddressReserve")
    handle = ctypes.c_uint64()
    ok(cu.cuMemCreate(ctypes.byref(handle), ctypes.c_size_t(size), ctypes.byref(prop),
                      ctypes.c_ulonglong(0)), "cuMemCreate")
    base = va.value + page
    ok(cu.cuMemMap(ctypes.c_uint64(base), ctypes.c_size_t(size), ctypes.c_size_t(0), handle,
                   ctypes.c_ulonglong(0)), "cuMemMap")
    desc = _AccessDesc(location=_Location(1, device), flags=3)  # read and write
    ok(cu.cuMemSetAccess(ctypes.c_uint64(base), ctypes.c_size_t(size), ctypes.byref(desc),
                         ctypes.c_size_t(1)), "cuMemSetAccess")
    return base, size


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--library",
                    help="a build of csrc/qmatmul.cu to run in place of the shipped one")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device is visible: the check needs one card")
    sys.path[:0] = [str(ROOT / "src")]
    from repro_torch.kernels import _build
    from repro_torch.kernels.qmatmul import kernel_design, mismatch, qmatmul, qmatmul_plain

    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)  # the context the driver calls below run in
    if args.library:
        lib = ctypes.CDLL(args.library)
        for fn, argtypes in _build.SIGNATURES["qmatmul"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _build._LIBS["qmatmul"] = lib
    base, size = guarded_region(0, max(K * N for _, K, N in CASES))
    gen = torch.Generator(device=dev).manual_seed(37)
    for dtype in (torch.bfloat16, torch.float32):
        for M, K, N in CASES:
            for end in ("last", "first"):
                ptr = base + size - K * N if end == "last" else base
                w = torch.as_tensor(_Raw(ptr, K * N), device=dev).view(K, N)
                w.copy_(torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                                      dtype=torch.int8))
                x_off = M % 2
                x = torch.randn((x_off + M * K,), generator=gen, device=dev).to(dtype)
                x = x[x_off:].view(M, K)
                scale = torch.rand((N,), generator=gen, device=dev) / 64
                out = qmatmul(x, w, scale)
                torch.cuda.synchronize()  # a load past w faults here
                mm = mismatch(out, qmatmul_plain(x, w, scale), x, w, scale)
                print(json.dumps({"dtype": str(dtype), "M": M, "K": K, "N": N, "w_at": end,
                                  "w_offset": ptr % 16, "design": kernel_design(dtype, M, N, w),
                                  "within": mm["within"], "max_ratio": mm["max_ratio"]}),
                      flush=True)
                if not mm["within"]:
                    sys.exit("beyond the rule")
    print("bounds cases done")


if __name__ == "__main__":
    main()
