"""End-to-end entry point of the port: federated DeepSpeech2 training with RAG
precision planning and packed OTA aggregation, then per-category eval.

    PYTHONPATH=src python -m repro_torch.fl --rounds 12
    PYTHONPATH=src python -m repro_torch.fl --device cpu --rounds 1 --clients 4 --per-round 2
    PYTHONPATH=src python -m repro_torch.fl --device cpu --channel fading --rounds 2

The flags are those of the JAX package's ``examples/train_fl_voice.py``
(``--channel ideal|fading`` and ``--fade-threshold`` included), plus
``--device`` (default: the CUDA card).
"""

from __future__ import annotations

import argparse
import time

from repro_torch.configs import FLConfig
from repro_torch.fl.server import FLServer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.fl")
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--clients", type=int, default=24)
    ap.add_argument("--per-round", type=int, default=6)
    ap.add_argument("--local-steps", type=int, default=3)
    ap.add_argument("--planner", default="rag", choices=["rag", "unified", "rag_energy"])
    ap.add_argument(
        "--strategy", default="fedavg", choices=["fedavg", "class_equal", "majority_centric"]
    )
    ap.add_argument("--channel", default="ideal", choices=["ideal", "fading"],
                    help="physical channel model")
    ap.add_argument("--fade-threshold", type=float, default=0.1,
                    help="|h|^2 truncation threshold (fading channel)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = FLConfig(
        n_clients=args.clients, clients_per_round=args.per_round,
        n_rounds=args.rounds, local_steps=args.local_steps, local_batch=6,
        lr=2e-3, planner=args.planner, strategy=args.strategy,
        channel_model=args.channel, fade_threshold=args.fade_threshold, seed=args.seed,
    )
    srv = FLServer(cfg, shard_size=16, device=args.device)
    print(f"planner={args.planner} strategy={args.strategy} channel={args.channel} "
          f"device={srv.device} "
          f"clients={args.clients} rounds={args.rounds}")
    t0 = time.time()
    srv.run(args.rounds, verbose=True)
    print(f"\ntrained {args.rounds} rounds in {time.time() - t0:.1f}s")
    acc = srv.evaluate()
    print("per-category char accuracy:", {k: round(v, 3) for k, v in acc.items()})
    logs = srv.round_logs
    print(f"satisfaction {logs[0].mean_satisfaction:.3f} -> "
          f"{logs[-1].mean_satisfaction:.3f} | "
          f"rel energy {logs[-1].mean_energy:.3f} | "
          f"loss {logs[0].train_loss:.2f} -> {logs[-1].train_loss:.2f}")


if __name__ == "__main__":
    main()
