#!/usr/bin/env python3
"""Readings behind the qmatmul kernel's tolerance (``kernels/qmatmul.TOL_C``).

    python3 scripts/qmatmul_tolerance_probe.py [--out chiprun_out/qmatmul_probe.json]

Needs one CUDA card. At every ``chip_smoke.QMM_CASES`` shape on Qwen3-8B's
w_gate and w_down (int8 from ``ops.quantize_weights`` of bf16 weights), the
kernel's difference from ``qmatmul_plain``, element by element, in units of
sqrt(K) 2**-24 (|x| @ |w_deq|) (``kernels/qmatmul.error_units``): the
largest, and the 50th, 99th and 99.99th percentiles; each reading names the
kernel that ran (``kernels/qmatmul.kernel_design``). Beside the sound
kernel, the same readings for planted faults, each the kernel run on one
corrupted input and held against the true plain version: one k tile of 32
weight rows dropped (``drop_k_tile``), the last weight row dropped
(``drop_k_row``), the output rounded to bf16 (``out_bf16``) and, for f32
x, x rounded to TF32's 10 mantissa bits (``x_tf32``) and x without its lo
plane (``drop_lo``: x = hi + mid, which the kernel splits into hi, mid and
a zero lo). Faults of each route's design, on its cases only: the Hopper
routes one k16 step of one 128-deep k tile skipped (``skip_k16``: 16
weight rows dropped) and the bf16 weight tile read without its 128-byte
swizzle (``b_unswizzled``: in every row k, the 16-byte chunk c of each
64-column block read from chunk c ^ (k % 8)); f32 on the Hopper route one
plane's k16 step skipped (``skip_plane_k16``: the hi plane of 16 k, x =
mid + lo there); the decode route one cluster rank's partial dropped
(``drop_rank``: the k range of rank S / 2 of ``cluster_split`` zeroed in w)
and the int8 tile its A fragments are converted from read without TMA's
swizzle (``a_unswizzled``: 16-column chunks of 128-column blocks). For f32 x, a one-hot
x of the same shape (one nonzero a row, a full 24-bit mantissa) reads the
kernel's and the ``drop_lo`` kernel's largest distance from the plain
version in ulps (``max_ulps``): the check that sees a dropped lo plane,
which the tolerance cannot.

The routes of w TMA cannot load (``--parts ldw``): the sound kernel at
Qwen3-8B's w_gate and w_down with w one byte off 16-byte alignment, at
w_gate with a ragged N (12,280) and at w_gate with a K of a partial last
tile (4,100), every ``chip_smoke.QMM_CASES`` (dtype, M), beside planted
faults of the producers that fetch w themselves, each ``csrc/qmatmul.cu``
rebuilt under ``build/qmatmul_probe/`` with one change (``LDW_FAULTS``):
the realigning
shift one byte off (``shift_off``), w's rows past K loaded and kept, not
zeroed (``rows_past_k``), the last column below N masked away
(``last_column``).

``--parts`` runs a subset (``tma``, ``ldw``). Prints one line per reading
and writes all of them as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAULTS = ("drop_k_tile", "drop_k_row", "out_bf16", "x_tf32", "drop_lo", "skip_k16",
          "b_unswizzled", "skip_plane_k16", "drop_rank", "a_unswizzled")
# the faults that only some routes' designs have, by the routes that have them
DESIGN_FAULTS = {"skip_k16": ("hopper", "hopper_f32"), "b_unswizzled": ("hopper", "hopper_f32"),
                 "skip_plane_k16": ("hopper_f32",), "drop_rank": ("decode",),
                 "a_unswizzled": ("decode",)}
F32_FAULTS = ("x_tf32", "drop_lo")
# planted faults of the producers that load w themselves: source changes of
# csrc/qmatmul.cu (each text must appear once)
LDW_FAULTS = {
    "shift_off": (("(uint32_t)k * (uint32_t)N + n0) & 15;", "(uint32_t)k * (uint32_t)N + n0 + 1) & 15;"),),
    "rows_past_k": (("hi = lo + (uintptr_t)K * N;", "hi = lo + (uintptr_t)(K + BKH) * N;"),
                    ("if (r >= 0 && k0 + r < K) {", "if (r >= 0) {"),
                    ("if (k >= K || b <= 0) o[u] = 0u;", "if (b <= 0) o[u] = 0u;")),
    "last_column": (("left = min(HT, N - n0) - 16 * c;", "left = min(HT, N - n0 - 1) - 16 * c;"),
                    ("const bool edge = N - n0 < HT || k0 + BKH > K;", "const bool edge = true;")),
}
# (weight, K, N, w's byte offset): Qwen3-8B's widths, one byte off; a
# ragged N; a K whose last 64-row tile is partial
LDW_SHAPES = (("w_gate", 4096, 12288, 1), ("w_down", 12288, 4096, 1),
              ("w_gate", 4096, 12280, 0), ("w_gate", 4100, 12288, 1))


def _tf32(x):
    """x with its mantissa rounded to 10 bits (to nearest, ties away)."""
    import torch

    b = x.view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _unswizzled(q, cols):
    """q as a kernel reads it when it reads a tile stored with the 128-byte
    swizzle (16-byte chunk c of row k of a block of 8 chunks at c ^ (k % 8))
    without the swizzle: ``cols`` columns a chunk, 8 for qmm_hopper's bf16
    weight tile, 16 for the int8 tile the decode route reads."""
    import torch

    K, N = q.shape
    n = torch.arange(N, device=q.device)
    k = torch.arange(K, device=q.device)[:, None]
    chunk = (n % (8 * cols)) // cols
    src = n - cols * chunk + cols * (chunk ^ (k % 8))  # column read for column n at row k
    src = torch.where(src < N, src, n)  # a chunk past N reads zeros as its own
    return torch.gather(q, 1, src.expand(K, N))


def faulty_inputs(x, q, s, fault):
    from repro_torch.kernels.qmatmul import cluster_split, split3_plain

    K, N = q.shape
    if fault == "drop_k_tile":
        q = q.clone()
        q[K // 2 : K // 2 + 32] = 0
    elif fault == "drop_k_row":
        q = q.clone()
        q[K - 1] = 0
    elif fault == "x_tf32":
        x = _tf32(x)
    elif fault == "drop_lo":
        hi, mid, _ = split3_plain(x)
        x = hi.float() + mid.float()
    elif fault == "skip_k16":
        q = q.clone()
        k0 = (K // 2) // 128 * 128 + 48  # the fourth k16 step of a middle k tile
        q[k0 : k0 + 16] = 0
    elif fault == "skip_plane_k16":
        hi, _, _ = split3_plain(x)
        k0 = (K // 2) // 64 * 64 + 48
        x = x.clone()
        x[:, k0 : k0 + 16] -= hi[:, k0 : k0 + 16].float()  # mid + lo, exactly
    elif fault == "drop_rank":
        import torch

        S, k_chunk = cluster_split(N, K, torch.cuda.get_device_properties(q.device)
                                   .multi_processor_count)
        q = q.clone()
        q[(S // 2) * k_chunk : (S // 2 + 1) * k_chunk] = 0
    elif fault == "b_unswizzled":
        q = _unswizzled(q, 8)
    elif fault == "a_unswizzled":
        q = _unswizzled(q, 16)
    return x, q, s


def one_hot_ulps(x, q, s) -> dict:
    """The kernel on a one-hot x of x's shape (one nonzero a row, 24
    mantissa bits, the last set), and on that x without its lo plane: each
    one's largest distance in ulps from the plain version."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.qmatmul import qmatmul_plain, split3_plain, ulps

    M, K = x.shape
    bits = (x[:, :1].abs().view(torch.int32) & 0x7FFFFF) | 1  # the mantissas of x's column 0
    bits |= torch.where(x[:, :1] < 0, -(1 << 31), 0).to(torch.int32) | (127 << 23)
    oh = torch.zeros_like(x)
    oh[torch.arange(M, device=x.device), torch.arange(M, device=x.device) * 7919 % K] = (
        bits.view(torch.float32)[:, 0])
    plain = qmatmul_plain(oh, q, s)
    hi, mid, _ = split3_plain(oh)
    return {"max_ulps": int(ulps(ops.qmatmul(oh, q, s), plain).max()),
            "drop_lo_max_ulps": int(ulps(ops.qmatmul(hi.float() + mid.float(), q, s),
                                         plain).max())}


def readings(dev) -> list:
    import torch

    import chip_smoke
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.kernels.qmatmul import TOL_C, error_units, kernel_design, qmatmul_plain
    from repro_torch.models.layers import dense_init

    gen = torch.Generator(device=dev)
    gen.manual_seed(614)
    cfg = get_arch("qwen3-8b")
    d, f = cfg.d_model, cfg.d_ff
    rows = []
    for wn, shape in (("w_gate", (d, f)), ("w_down", (f, d))):
        q, s = ops.quantize_weights(dense_init(gen, shape, torch.bfloat16, dev))
        for dt, M in chip_smoke.QMM_CASES:
            x = torch.randn((M, shape[0]), generator=gen, device=dev).to(getattr(torch, dt))
            plain = qmatmul_plain(x, q, s)
            design = kernel_design(x.dtype, M, shape[1], q)
            for variant in ("kernel",) + FAULTS:
                if variant in F32_FAULTS and dt != "float32":
                    continue
                if variant in DESIGN_FAULTS and design not in DESIGN_FAULTS[variant]:
                    continue
                xv, qv, sv = (x, q, s) if variant == "kernel" else faulty_inputs(x, q, s, variant)
                out = ops.qmatmul(xv, qv, sv)
                if variant == "out_bf16":
                    out = out.bfloat16().float()
                r = error_units(out, plain, x, q, s).flatten()
                sample = r[torch.randint(0, r.numel(), (1_000_000,), generator=gen, device=dev)]
                pct = torch.quantile(sample, torch.tensor([0.5, 0.99, 0.9999], device=dev))
                row = {"weight": wn, "dtype": dt, "M": M, "K": shape[0], "N": shape[1],
                       "design": design, "variant": variant, "max_units": float(r.max()),
                       "p50": float(pct[0]), "p99": float(pct[1]), "p9999": float(pct[2]),
                       "over_tol": int((r > TOL_C).sum()), "n": r.numel()}
                print(json.dumps(row), flush=True)
                rows.append(row)
            if dt == "float32":
                row = {"weight": wn, "dtype": dt, "M": M, "K": shape[0], "N": shape[1],
                       "design": design, "variant": "one_hot", **one_hot_ulps(x, q, s)}
                print(json.dumps(row), flush=True)
                rows.append(row)
            del x, plain
        torch.cuda.empty_cache()
    return rows


def fault_libraries() -> dict:
    """``csrc/qmatmul.cu`` with each ``LDW_FAULTS`` change, built in parallel
    under ``build/qmatmul_probe/`` and loaded as ``_build`` loads it."""
    import ctypes

    from repro_torch.kernels import _build

    out = ROOT / "build" / "qmatmul_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, changes in LDW_FAULTS.items():
        src = (_build.CSRC / "qmatmul.cu").read_text()
        for old, new in changes:
            if src.count(old) != 1:
                sys.exit(f"the source no longer has one {old!r}")
            src = src.replace(old, new)
        (out / f"qmatmul_{name}.cu").write_text(src)
        procs[name] = subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                                        str(out / f"libqmatmul_{name}.so"),
                                        str(out / f"qmatmul_{name}.cu")])
    libs = {}
    for name, proc in procs.items():
        if proc.wait(timeout=900) != 0:
            sys.exit(f"nvcc failed for the {name} fault")
        lib = ctypes.CDLL(str(out / f"libqmatmul_{name}.so"))
        for fn, argtypes in _build.SIGNATURES["qmatmul"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def ldw_readings(dev) -> list:
    """The ``_ldw`` routes at ``LDW_SHAPES`` x ``chip_smoke.QMM_CASES``: the
    sound kernel and each planted fault of its producer, in error units
    against the plain version (and the fault's largest difference from the
    sound kernel's output)."""
    import torch

    import chip_smoke
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.qmatmul import TOL_C, error_units, kernel_design, qmatmul_plain

    faults = fault_libraries()
    sound = _build.library("qmatmul")
    gen = torch.Generator(device=dev).manual_seed(615)
    rows = []
    for wn, K, N, off in LDW_SHAPES:
        # room past w for the rows_past_k fault's reads: one tile of rows
        wbuf = torch.randint(-127, 128, (off + (K + 64) * N,), generator=gen, device=dev,
                             dtype=torch.int8)
        q = wbuf[off:off + K * N].view(K, N)
        s = torch.rand((N,), generator=gen, device=dev) / 64
        for dt, M in chip_smoke.QMM_CASES:
            x = torch.randn((M, K), generator=gen, device=dev).to(getattr(torch, dt))
            plain = qmatmul_plain(x, q, s)
            design = kernel_design(x.dtype, M, N, q)
            ref = ops.qmatmul(x, q, s)
            for variant in ("kernel", *LDW_FAULTS):
                _build._LIBS["qmatmul"] = sound if variant == "kernel" else faults[variant]
                try:
                    out = ops.qmatmul(x, q, s)
                finally:
                    _build._LIBS["qmatmul"] = sound
                r = error_units(out, plain, x, q, s).flatten()
                row = {"weight": wn, "dtype": dt, "M": M, "K": K, "N": N, "w_offset": off,
                       "design": design, "variant": variant, "max_units": float(r.max()),
                       "over_tol": int((r > TOL_C).sum()), "n": r.numel(),
                       "max_abs_from_sound": float((out - ref).abs().max())}
                print(json.dumps(row), flush=True)
                rows.append(row)
            del x, plain, ref, out
        del wbuf, q
        torch.cuda.empty_cache()
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "qmatmul_probe.json"))
    ap.add_argument("--parts", default="tma,ldw")
    args = ap.parse_args()
    parts = args.parts.split(",")

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device is visible: the probe needs one card")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    res = {}
    if "tma" in parts:
        res["readings"] = readings(dev)
    if "ldw" in parts:
        res["ldw"] = ldw_readings(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    res["card"] = smi.stdout.strip().splitlines()[0]
    res["torch"] = torch.__version__
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(f"{res['card']}; probe done in {time.perf_counter() - t0:.1f} s -> {out}")


if __name__ == "__main__":
    main()
