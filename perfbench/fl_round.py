"""One federated round of the program at the paper's settings, traced: a
measurement for the record, not a cell.

    python3 perfbench/fl_round.py [--out chiprun_out/fl_round.json]

``repro_torch.fl.FLServer``: DeepSpeech2, 100 clients, 10 a round, 4
local steps of 8 utterances, the RAG planner, the ideal channel, FedAvgM
0.9. Round 0 warms up; round 1 runs under ``torch.profiler`` (CPU and
CUDA). Prints the round's wall seconds, the device's busy seconds and
idle share, the kernels that took the most time, and the longest idle
stretches by the host operation running at their middle.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench import profiling

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    from repro_torch.configs import FLConfig
    from repro_torch.fl.server import FLServer

    cfg = FLConfig(n_clients=100, clients_per_round=10, local_steps=4, local_batch=8,
                   planner="rag", channel_model="ideal", server_momentum=0.9, seed=0)
    srv = FLServer(cfg, device="cuda")
    t = time.perf_counter()
    srv.run_round(0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        srv.run_round(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    t = time.perf_counter()
    red = profiling.reduce_profile(prof)
    out = dict(red, round_s=wall, warmup_round_s=warm_s, reduce_s=time.perf_counter() - t,
               idle_share=1.0 - red["busy_s"] / wall,
               device=torch.cuda.get_device_name(0))
    print(json.dumps(out))
    if args.out:
        (ROOT / args.out).parent.mkdir(parents=True, exist_ok=True)
        (ROOT / args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
