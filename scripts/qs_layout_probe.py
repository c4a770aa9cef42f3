#!/usr/bin/env python3
"""Readings behind the in-pass quantize-superpose kernel's choice of layout
(``csrc/ota_quantize_superpose.cu``: narrow, 2 columns a thread, under
``kernels/ota_fused._QS_WIDE_M`` columns; wide, 4 columns a thread, from
there on).

    python3 scripts/qs_layout_probe.py [--out chiprun_out/qs_layout_probe.json]

Needs one CUDA card. At the flat path's shape (K = 20 rows of the
DeepSpeech2 update, M = 4,134,912 columns, 19 rows at 8 bits and one
32-bit passthrough row) and at the cohort case of ``chip_smoke.py``
(K = 8,000, M = 262,144, bits 2/4/8/16/24/31/32 in turn), on random rows
from a seed, for each layout: the result against the plain version (acc
bit for bit, sumsq within 1e-5), the CUDA-event median of one call (host
work included) and of calls queued back to back (device time), and the
kernels' registers and blocks an SM; and the flat rows at M from 2^18 to
2^21 columns, both layouts, on both sides of the threshold. Prints one
JSON line per reading and writes all of them to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLAT_BITS = (8,) * 19 + (32,)
COHORT_BITS = (2, 4, 8, 16, 24, 31, 32)
# (name, K, M, bits in turn): the flat path, the cohort case, and the flat
# rows at narrower M on both sides of the layout threshold
CASES = (("flat", 20, 4_134_912, FLAT_BITS), ("cohort", 8000, 262_144, COHORT_BITS),
         *((f"flat M={m}", 20, m, FLAT_BITS) for m in (1 << 18, 1 << 19, 1 << 20, 1 << 21)))


def one_call_ms(fn, reps):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def queued_ms(fn, n, reps=5):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def resource_usage():
    """``cuobjdump -res-usage`` of the built library: registers, stack and
    shared memory of each kernel instantiation."""
    import shutil

    from repro_torch.kernels import _build

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([exe, "-res-usage", str(_build._lib_path("ota_quantize_superpose"))],
                         capture_output=True, text=True, check=True, timeout=120).stdout
    return [" ".join(line.split()) for line in out.splitlines() if "REG:" in line or
            "Function" in line]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "qs_layout_probe.json"))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.core import ota
    from repro_torch.kernels import _build
    from repro_torch.kernels import ota_fused as kota

    if not torch.cuda.is_available():
        sys.exit("qs_layout_probe: no CUDA card")
    dev = torch.device("cuda", 0)
    lib = _build.library("ota_quantize_superpose")
    per_sm = lib.ota_quantize_superpose_blocks_per_sm
    readings = {"device": torch.cuda.get_device_name(0), "resources": resource_usage(),
                "blocks_per_sm": {f"{name} K={K}": per_sm(wide, K) for K in (20, 4000)
                                  for wide, name in ((0, "narrow"), (1, "wide"))},
                "wide_from_m": kota._QS_WIDE_M, "cases": []}
    print(json.dumps({k: readings[k] for k in ("resources", "blocks_per_sm", "wide_from_m")}))
    for name, K, M, cycle in CASES:
        gen = torch.Generator(device=dev).manual_seed(K + M)
        x = torch.randn((K, M), generator=gen, device=dev) * 0.01
        bits = [cycle[i % len(cycle)] for i in range(K)]
        scale, qmax = ota._client_grid(bits, x.abs().amax(dim=1))
        w = torch.rand((K,), generator=gen, device=dev) / K
        acc_p, ss_p = kota.quantize_superpose_plain(x, scale, qmax, w, 0x5EED)
        for wide in (False, True):
            def call(wide=wide):
                return kota.ota_quantize_superpose(x, scale, qmax, w, 0x5EED, wide=wide)

            acc, ss = call()
            rel = abs(ss.item() - ss_p.item()) / abs(ss_p.item())
            rec = {"case": name, "K": K, "M": M, "layout": "wide" if wide else "narrow",
                   "default": wide == (M >= kota._QS_WIDE_M),
                   "acc_equal": bool(torch.equal(acc, acc_p)), "sumsq_rel": rel,
                   "ms": one_call_ms(call, args.reps if K < 1000 else 10),
                   "queued_ms": queued_ms(call, 20 if K < 1000 else 3),
                   "bound_bytes_ms": 1e3 * 4.0 * (K * M + M + 3 * K) / 3.35e12}
            readings["cases"].append(rec)
            print(json.dumps(rec))
            if not rec["acc_equal"] or rel > 1e-5:
                sys.exit(f"qs_layout_probe: {name} {rec['layout']} != plain")
        del x
        torch.cuda.empty_cache()
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(readings, indent=1))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
