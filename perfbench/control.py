"""The readings a training cell's limits are set from, on the chip.

    python3 perfbench/control.py --workload <name> --seeds 11,12,13 --controls 3 \
        [--out chiprun_out/control.<name>.json]

For each seed: the program's first steps at the cell's own sizes (the
set-up of a run, no window) against the float32 reference, which gives
the lower readings. For the first ``--controls`` seeds also the control,
the reference computed with float8 (e4m3) operands in every matrix
product in the program's place, and the planted fault of half the batch
left out (the reference on the first half of each batch's rows, the mean
over those), each against the float32 reference: the upper readings. A
step that returns its state unchanged reads 1 in ``change_gap`` by the
measure and needs no run. Prints one JSON line a seed and writes them all
to ``--out``.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import check, spec, weights
    from perfbench.kinds import markov_lm as K
    from perfbench.reference import common as C
    from perfbench.reference import train as ref_train

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    from repro_torch.configs import get_arch

    bench = spec.benchmark()
    wl = spec.workload(bench, args.workload)
    cfg, traffic = spec.config(wl["config"]), spec.traffic(wl["traffic"])
    dev = torch.device("cuda:0")
    ctx = K.Ctx(cfg, traffic, spec.family(cfg), traffic["batch"], traffic["seq"], dev)
    arch = get_arch(cfg["registry"])
    K.check_arch(cfg, arch)
    rows = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        opt, state, step_fn = K._program(ctx, arch, seed)
        state, prog, hosts = K._setup_steps(ctx, state, step_fn, K._feed(ctx, seed))
        K._sync(dev)
        t_prog = time.perf_counter() - t0
        del state, step_fn, opt
        K.free()
        params = weights.make(ctx.family.layout(cfg), seed, dev)

        def follow(**kw):
            t = time.perf_counter()
            out = ref_train.follow(ctx.family, cfg, traffic["optimizer"], params, hosts, dev,
                                   **kw)
            return out, time.perf_counter() - t

        ref, t_ref = follow()
        raw = {"program": prog, "reference": ref}
        row = {"seed": seed, "program": {k: v["value"] for k, v in check.gaps(prog, ref).items()},
               "program_at": {k: v["at"] for k, v in check.gaps(prog, ref).items()},
               "seconds": {"program_setup": t_prog, "reference": t_ref},
               "losses": {"program": prog["loss"], "reference": ref["loss"]}}
        if i < args.controls:
            fp8, t_fp8 = follow(prec=C.Prec("fp8"))
            half, t_half = follow(rows=traffic["batch"] // 2)
            row["control_fp8"] = {k: v["value"] for k, v in check.gaps(fp8, ref).items()}
            row["fault_half_batch"] = {k: v["value"] for k, v in check.gaps(half, ref).items()}
            row["seconds"].update(control=t_fp8, half_batch=t_half)
            raw.update(control_fp8=fp8, fault_half_batch=half)
        del params
        K.free()
        print(json.dumps(row), flush=True)
        rows.append(dict(row, raw=raw))
    if args.out:
        path = ROOT / args.out
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"workload": wl["name"], "device": torch.cuda.get_device_name(0),
                                    "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
