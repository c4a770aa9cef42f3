"""Batched prefill + decode driver (the JAX package's ``launch/serve.py``).

CPU usage (reduced config, real tokens):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch stablelm-1.6b --reduced --batch 4 --prompt-len 32 --gen 32

(``--arch falcon-mamba-7b``, ``--arch zamba2-2.7b`` and ``--arch
whisper-tiny`` serve the ssm, hybrid and audio families the same way.)

Without ``--device`` it runs on the CUDA card (and raises without one).
Runs prefill over a batch of synthetic prompts, then step-decodes greedily
with the KV cache (a ring-buffer window when ``--window`` is set). As the
reference, the vlm family prefills 8 zero patch embeddings (f32) ahead of
the prompt and decodes from position P, not 8 + P: the decode steps write
over the cache slots of the prompt's last 8 tokens. The audio family's
frames (B, encoder_seq, frontend_dim) f32 are drawn from the same
``RandomState`` right after the prompts, standard normal.
``serve(cfg, ...)`` is the same driver for a given ``ArchConfig`` (for
example ``cfg.with_(use_flash_kernel=True)``), optionally on given params.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig, get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.registry import build_model


@dataclasses.dataclass
class ServeResult:
    params: Any
    prompts: np.ndarray  # (B, P) int
    prefill_logits: torch.Tensor  # (B, V) f32, last prompt position
    tokens: torch.Tensor  # (B, gen) int32, greedy
    all_finite: bool  # every step's logits finite
    prefill_s: float  # prefill + cache growth, host clock, synchronised
    decode_s: float  # the gen - 1 decode steps, host clock, synchronised
    cache: Any  # after the last step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg: ArchConfig, *, batch: int = 4, prompt_len: int = 32, gen: int = 32,
          window: int = 0, seed: int = 0, device=None, params: Optional[Any] = None
          ) -> ServeResult:
    """Prefill ``batch`` prompts of ``prompt_len`` tokens (numpy seed
    ``seed``), grow the cache, decode ``gen - 1`` greedy steps. Random
    weights from a ``torch.Generator`` seeded ``seed`` unless ``params``."""
    dev = resolve_device(device)
    model = build_model(cfg)
    if model.prefill is None:
        raise ValueError(f"family {cfg.family!r} has no prefill")
    if params is None:
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        params = model.init(g, dev)

    B, P = batch, prompt_len
    rng = np.random.RandomState(seed)
    prompts = rng.randint(0, cfg.vocab_size, (B, P))
    inputs = {"tokens": torch.as_tensor(prompts, dtype=torch.int32, device=dev)}
    if cfg.family == "vlm":
        inputs["patches"] = torch.zeros((B, 8, cfg.frontend_dim), dtype=torch.float32,
                                        device=dev)
    if cfg.family == "audio":
        frames = rng.randn(B, cfg.encoder_seq, cfg.frontend_dim)
        inputs["frames"] = torch.as_tensor(frames, dtype=torch.float32, device=dev)
    total = P + gen
    window = window or 0

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = make_prefill_step(model)(params, inputs)
    # grow the cache to hold the generated tokens (attention caches only)
    if cfg.family != "ssm":
        cache = model.grow_cache(cache, window or total)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    prefill_logits = logits

    decode = make_decode_step(model, window=window)
    tok = torch.argmax(logits, dim=-1).to(torch.int32).reshape(B, 1)
    out_tokens = [tok]
    finite = torch.isfinite(logits).all()
    t0 = time.perf_counter()
    for s in range(gen - 1):
        step_batch = {"tokens": tok,
                      "pos": torch.full((B,), P + s, dtype=torch.int32, device=dev)}
        logits, cache = decode(params, cache, step_batch)
        tok = torch.argmax(logits, dim=-1).to(torch.int32).reshape(B, 1)
        out_tokens.append(tok)
        finite = finite & torch.isfinite(logits).all()
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return ServeResult(
        params=params, prompts=prompts, prefill_logits=prefill_logits,
        tokens=torch.cat(out_tokens, dim=1), all_finite=bool(finite),
        prefill_s=t_prefill, decode_s=t_decode, cache=cache,
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--window", type=int, default=0, help="sliding-window cache (0 = full)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the plain versions)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
                window=args.window, seed=args.seed, device=args.device)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} gen={args.gen}")
    print(f"prefill: {res.prefill_s * 1000:.1f} ms   "
          f"decode: {res.decode_s / max(args.gen - 1, 1) * 1000:.2f} ms/token")
    print("sample token ids:", res.tokens[0, :16].tolist())


if __name__ == "__main__":
    main()
