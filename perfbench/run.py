"""Run one cell of the benchmark and print its result as one JSON line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration, traffic, limits and metric readers are files under
``perfbench/`` found by name (``perfbench/spec.py``). The program under
test is ``repro_torch`` (``src/``), on the CUDA cards of this machine.
With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and a breakdown of the device's time.
The numbers compared to decide ``correct`` come last, on standard error
and in the line (``checks``). Without enough CUDA cards, or where the
process has loaded JAX or the JAX package, it exits non-zero and prints
no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "perfbench" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "perfbench" / "triton")
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(bench, wl, out, trace: bool):
    from perfbench import spec

    metrics = {}
    if trace:
        for m in spec.metrics_of(bench, "per_layer", wl["name"]):
            value = spec.metric_reader(m["name"])(out["records"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in spec.metrics_of(bench, "end_to_end", wl["name"]):
            metrics[m["name"]] = {"value": float(out["end_to_end"][m["name"]]),
                                  "unit": m["unit"]}
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": out["device"]}
    if trace:
        prof = out["records"]["profile"]
        line["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import spec

    bench = spec.benchmark()
    wl = spec.workload(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"needs {wl['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3

    cfg, traffic = spec.config(wl["config"]), spec.traffic(wl["traffic"])
    out = spec.kind(traffic).run(cfg, traffic, seed=args.seed, seconds=args.seconds,
                                 trace=bool(args.trace), device="cuda:0", t0=T0,
                                 limits=spec.limits(wl["name"]))
    line = result_line(bench, wl, out, bool(args.trace))

    found = forbidden_modules()
    if found:
        print(f"the process has loaded {found}: the benchmark runs the port alone",
              file=sys.stderr)
        return 4
    rec = out["records"]
    parts = ", ".join(f"{k} {v:.3f}" for k, v in rec["setup_parts"].items())
    print(f"set-up {out['end_to_end']['setup_s']:.3f} s ({parts}), window {rec['window_s']:.3f} s of "
          f"{rec['steps']} steps, reference {rec['reference_s']:.3f} s", file=sys.stderr)
    for name, c in out["checks"].items():
        at = out["gaps"][name].get("at", "")
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r}; worst at {at})",
              file=sys.stderr)
    print(f"correct = {line['correct']}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
