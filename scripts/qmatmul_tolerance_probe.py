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
x, x rounded to TF32's 10 mantissa bits (``x_tf32``). Two faults of the
Hopper route's design, on its cases only: one k16 step of one 128-deep k
tile skipped (``skip_k16``: 16 weight rows dropped), and the bf16 weight
tile read without its 128-byte swizzle (``b_unswizzled``: in every row k,
the 16-byte chunk c of each 64-column block read from chunk c ^ (k % 8)).

Prints one line per reading and writes all of them as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAULTS = ("drop_k_tile", "drop_k_row", "out_bf16", "x_tf32", "skip_k16", "b_unswizzled")
HOPPER_FAULTS = ("skip_k16", "b_unswizzled")


def _tf32(x):
    """x with its mantissa rounded to 10 bits (to nearest, ties away)."""
    import torch

    b = x.view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def faulty_inputs(x, q, s, fault):
    K = q.shape[0]
    if fault == "drop_k_tile":
        q = q.clone()
        q[K // 2 : K // 2 + 32] = 0
    elif fault == "drop_k_row":
        q = q.clone()
        q[K - 1] = 0
    elif fault == "x_tf32":
        x = _tf32(x)
    elif fault == "skip_k16":
        q = q.clone()
        k0 = (K // 2) // 128 * 128 + 48  # the fourth k16 step of a middle k tile
        q[k0 : k0 + 16] = 0
    elif fault == "b_unswizzled":
        import torch

        K, N = q.shape
        n = torch.arange(N, device=q.device)
        k = torch.arange(K, device=q.device)[:, None]
        chunk = (n % 64) // 8
        src = n - 8 * chunk + 8 * (chunk ^ (k % 8))  # column read for column n at row k
        src = torch.where(src < N, src, n)  # a chunk past N reads zeros as its own
        q = torch.gather(q, 1, src.expand(K, N))
    return x, q, s


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
            design = kernel_design(x.dtype, M, shape[1], shape[0], x, q)
            for variant in ("kernel",) + FAULTS:
                if variant == "x_tf32" and dt != "float32":
                    continue
                if variant in HOPPER_FAULTS and design != "hopper":
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
            del x, plain
        torch.cuda.empty_cache()
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "qmatmul_probe.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device is visible: the probe needs one card")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    res = {"readings": readings(dev)}
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
