#!/usr/bin/env python3
"""The decode route's two forms side by side, on one card.

    python3 scripts/qmatmul_decode_forms.py [--out chiprun_out/qmatmul_decode_forms.json]

Needs one CUDA card. Builds ``scripts/qmatmul_decode_forms.cu`` (the shipped
``csrc/qmatmul.cu`` with the shared-memory form ``qmm_decode_ss`` beside
it) into ``build/``, then at Qwen3-8B's MLP widths (w_gate 4,096 x 12,288,
w_down 12,288 x 4,096; int8 from ``ops.quantize_weights``), M = 4, bf16
and f32 x, times both forms at every cluster size S (1, 2, 4, 8; the
shipped wrapper's choice is ``kernels/qmatmul.cluster_split``): ten calls
queued behind a sleeping kernel (``chip_smoke.cuda_ms_queued``), each
form's output held to ``kernels/qmatmul.mismatch`` and to a second launch
bit for bit. Beside them, the shipped wrapper (``ops.qmatmul``) and
``torch.matmul`` on weights dequantized beforehand.

The register form (shipped) converts each k16 step's int8 bytes in the
multiplying warpgroups' registers: no bf16 tile, no proxy fence, no
conversion warpgroup. The shared-memory form writes a bf16 tile that
``wgmma`` reads; for f32 x it reads that tile once per plane.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORMS = ("register A (shipped)", "shared-memory A")


def build():
    from repro_torch.kernels import _build

    out = ROOT / "build" / "qmatmul_decode_forms" / "libforms.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
                           str(ROOT / "scripts" / "qmatmul_decode_forms.cu")],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        sys.exit(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.form_launch.argtypes = [I, I, P, P, P, P, I, I, I, I, I, P]
    return lib


def readings(lib, dev) -> list:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.kernels.qmatmul import cluster_split, mismatch, qmatmul_plain

    gen = torch.Generator(device=dev).manual_seed(3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for K, N in ((4096, 12288), (12288, 4096)):
        q, s = ops.quantize_weights(torch.randn((K, N), generator=gen, device=dev) * 0.02)
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn((4, K), generator=gen, device=dev).to(dt)
            plain = qmatmul_plain(x, q, s)
            w_deq = (q.float() * s).to(dt)
            base = {"K": K, "N": N, "dtype": str(dt).split(".")[-1], "M": 4}
            row = dict(base, variant="wrapper and library",
                       shipped_S=cluster_split(N, K, sms)[0],
                       wrapper_queued=cs.cuda_ms_queued(lambda: ops.qmatmul(x, q, s)),
                       library_queued=cs.cuda_ms_queued(lambda: torch.matmul(x, w_deq)))
            print(json.dumps(row), flush=True)
            rows.append(row)
            for form, name in enumerate(FORMS):
                for S in (1, 2, 4, 8):
                    k_chunk = -(-(-(-K // 64)) // S) * 64
                    out = torch.empty((4, N), device=dev)

                    def call():
                        rc = lib.form_launch(form, int(dt == torch.bfloat16), x.data_ptr(),
                                             q.data_ptr(), s.data_ptr(), out.data_ptr(), 4, N, K,
                                             S, k_chunk, torch.cuda.current_stream().cuda_stream)
                        if rc != 0:
                            raise RuntimeError(f"{name} at S = {S}: error {rc}")

                    call()
                    torch.cuda.synchronize()
                    first = out.clone()
                    mm = mismatch(out, plain, x, q, s)
                    row = dict(base, variant=name, S=S, queued=cs.cuda_ms_queued(call),
                               within=mm["within"], max_ratio=mm["max_ratio"],
                               bit_stable=bool(torch.equal(first, out)))
                    print(json.dumps(row), flush=True)
                    rows.append(row)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "qmatmul_decode_forms.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device is visible: the comparison needs one card")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    res = {"readings": readings(build(), torch.device("cuda", 0))}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    res["card"] = smi.stdout.strip().splitlines()[0]
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(f"{res['card']} -> {out}")


if __name__ == "__main__":
    main()
