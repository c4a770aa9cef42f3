"""Training driver for the LMs (the JAX package's ``launch/train.py``).

CPU usage (reduced config, real steps):
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch stablelm-1.6b --reduced --steps 50 --batch 8 --seq 128

Without ``--device`` it trains on the CUDA card (and raises without one).
Markov tokens (``data/lm.py``) feed ``make_train_step`` (``lm_loss``,
autograd, global-norm clip at 1.0, AdamW on a linear-warmup cosine
schedule), donating: each step writes the train state in place, as the
reference jits its step with ``donate_argnums=(0,)``; ``--ckpt-dir`` saves the train state every ``--ckpt-every``
steps and resumes from the latest file. As in the reference, a resumed
run restarts the token stream at its first batch, a vlm model gets 8
zero patch embeddings ahead of every batch's tokens, and an audio model
gets step i's frames from ``np.random.RandomState(i)`` (standard normal,
f32).

``main(argv)`` returns the logged entries: step, loss, grad_norm, the
host-clock ms a step since the previous log (the logged loss is read
back, which synchronises), and the host ms a step spent drawing batches.
``run(parse_args(argv))`` returns the final train state beside them.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data.lm import token_batches
from repro_torch.device import resolve_device
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw, linear_warmup_cosine
from repro_torch.util import count_params


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke) variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the plain versions)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> Tuple[Dict[str, Any], List[Dict[str, float]]]:
    """Train as ``args`` say; returns (final train state, logged entries)."""
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    opt = adamw(linear_warmup_cosine(args.lr, args.warmup, args.steps))

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    state = init_train_state(model, opt, gen)
    print(f"arch={cfg.name} params={count_params(state['params']):,}")

    step_fn = make_train_step(model, opt, donate=True)  # the reference's donate_argnums=(0,)
    data = token_batches(cfg.vocab_size, args.batch, args.seq, seed=args.seed)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr is not None:
        restored, meta = mgr.restore_latest(device=dev)
        if restored is not None:
            state = restored
            print(f"restored step {meta['step']}")

    log: List[Dict[str, float]] = []
    t0 = t_last = time.perf_counter()
    start = last = int(state["step"])
    batch_s = 0.0
    for i in range(start, args.steps):
        tb = time.perf_counter()
        host = next(data)
        batch_s += time.perf_counter() - tb
        batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
        if cfg.family == "vlm":  # the reference's stub: 8 zero patch embeddings
            batch["patches"] = torch.zeros((args.batch, 8, cfg.frontend_dim),
                                           dtype=torch.float32, device=dev)
        if cfg.family == "audio":  # the reference's stub: seeded frames a step
            frames = np.random.RandomState(i).randn(args.batch, cfg.encoder_seq,
                                                    cfg.frontend_dim)
            batch["frames"] = torch.as_tensor(frames, dtype=torch.float32, device=dev)
        state, metrics = step_fn(state, batch)
        if (i + 1) % args.log_every == 0:
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            now = time.perf_counter()
            dt = (now - t0) / max(i + 1 - start, 1)
            log.append({"step": i + 1, "loss": loss, "grad_norm": gnorm,
                        "ms_per_step": (now - t_last) * 1e3 / (i + 1 - last),
                        "batch_ms": batch_s * 1e3 / (i + 1 - last)})
            t_last, last, batch_s = now, i + 1, 0.0
            print(f"step {i+1:5d} loss={loss:.4f} gnorm={gnorm:.3f} ({dt*1000:.0f} ms/step)")
        if mgr is not None and (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, state)
    print(f"done: {args.steps} steps in {time.perf_counter()-t0:.1f}s")
    return state, log


def main(argv=None) -> List[Dict[str, float]]:
    return run(parse_args(argv))[1]


if __name__ == "__main__":
    main()
