"""Production dry run on meta tensors (the JAX package's
``launch/dryrun.py``): every (arch x input shape) on the production mesh,
shapes only, and the roofline terms the specs imply for one card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 40 combos
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multipod # (2, 16, 16)

Where the reference lowers and compiles the jitted step under XLA, the
port runs, on ``"meta"`` tensors, the sharded steps' per-shard code (the
code that trains and serves): the train step's forward and backward
(``steps.shard_value_and_grad``), the sharded prefill's
(``steps.shard_prefill``) or the sharded decode's (``steps.shard_decode``,
against the whole batch's cache at ``cache_len_for`` placed by
``cache_spec`` on the production mesh, each unit reading its box of it):
the params of ``train_state_shapes``, one data shard's batch of
``Model.input_spec`` (each input cut by ``batch_spec``). The step runs
under one data row of the production mesh (the data axes of size 1, the
``model`` axis whole, on meta devices), which is what data shard 0
computes: the MoE takes its expert-parallel path exactly where the
reference's does, with the same per-shard token count, its expert stacks
read as each model shard's block on its device (a batch that the step
runs as one shard, ``steps.data_shards``, runs whole under the whole
mesh). The train shapes run the step's gather route (``tensor_parallel``
False, every other leaf read whole); the prefill and decode shapes its
tensor-parallel route (the attention, MLP, Mamba blocks, embedding and
head of every LM family split over ``model``, a head never split). The
bytes a device are the specs' either way.
That shows every arch builds and runs shape-correct at production size
with no memory and no card.

Each record holds the status (and the error), ``lower_s`` (the meta
run's seconds), the param counts and the analytic model FLOPs, and the
bytes each device holds of params, optimizer state, batch and cache,
reckoned from the specs on the full production mesh;
``alias_size_in_bytes``, the bytes a device that the step donates and
writes in place (the reference's XLA alias size, here from the specs:
the train state for a train shape, the cache for a decode shape, none
for a prefill); then
``t_compute_s`` (model FLOPs a device over the card's bf16 peak),
``t_memory_s`` (a device's bytes over its HBM rate) and whether a
device's state fits one card. Records append to ``--out`` (default
``build/dryrun_results.json``, which git ignores).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, ArchConfig, InputShape, get_arch
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import (CARD_BF16_FLOPS, CARD_HBM_BYTES, CARD_HBM_BYTES_PER_S,
                                     _production_shape, make_mesh)
from repro_torch.launch.steps import (data_shards, shard_decode, shard_prefill,
                                      shard_value_and_grad, train_state_shapes)
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw
from repro_torch.util import tree_size

META = torch.device("meta")


# ---------------------------------------------------------------------------
# model FLOPs (analytic)
# ---------------------------------------------------------------------------


def model_flops(cfg: ArchConfig, shape: InputShape, n_params: int,
                n_active: Optional[int] = None) -> float:
    """6·N·D for training, 2·N·D for inference (N = active params)."""
    n = n_active if (n_active and cfg.n_experts) else n_params
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch  # one token per sequence
    return 2.0 * n * tokens


def active_params(cfg: ArchConfig, n_params: int) -> int:
    """Rough active-parameter count for MoE (top-k of E experts)."""
    if not cfg.n_experts:
        return n_params
    F = cfg.moe_d_ff or cfg.d_ff
    expert_params = cfg.n_layers * cfg.n_experts * 3 * cfg.d_model * F
    active_expert = expert_params * cfg.experts_per_token / cfg.n_experts
    return int(n_params - expert_params + active_expert)


# ---------------------------------------------------------------------------
# dry-run core
# ---------------------------------------------------------------------------


def _local(inputs: Dict[str, torch.Tensor], specs: Dict[str, shd.P], mesh) -> Dict[str, Any]:
    """One data shard's piece of each input (its batch rows), as a meta
    tensor: cut over the data axes only (``mesh`` has a model axis of 1),
    since the step runs the whole model's math of its data shard."""
    return {k: torch.empty(shd.piece_shape(v.shape, specs[k], mesh), dtype=v.dtype, device=META)
            for k, v in inputs.items()}


def _run_combo(cfg: ArchConfig, shape: InputShape, mesh, row_mesh, dp_mesh) -> Dict[str, Any]:
    """Run the step on meta tensors under ``row_mesh`` on one data shard's
    inputs (cut over ``dp_mesh``, the data axes); the bytes a device of
    ``mesh`` holds of each part, by the specs."""
    model = build_model(cfg)
    nbytes = shd.tree_spec_nbytes
    batch = model.input_spec(shape)
    batch_specs = shd.batch_spec(batch, mesh)
    local = _local(batch, batch_specs, dp_mesh)
    out: Dict[str, Any] = {"bytes_batch": nbytes(batch, batch_specs, mesh), "bytes_opt": 0,
                           "bytes_cache": 0, "alias_size_in_bytes": 0}
    if shape.kind == "train":
        opt = adamw(1e-4)
        state = train_state_shapes(model, opt)
        params = state["params"]
        # optimizer state mirrors the params' sharding (ZeRO for free); the
        # pass is the gather route's (the tensor-parallel one is not run here)
        opt_specs = {k: shd.tree_param_specs(v, mesh, n_kv_heads=cfg.n_kv_heads)
                     for k, v in state["opt"].items()}
        out["bytes_opt"] = sum(nbytes(v, opt_specs[k], mesh) for k, v in state["opt"].items())
        # the donating step writes the whole train state in place
        out["alias_size_in_bytes"] = nbytes(state, {
            "params": shd.tree_param_specs(params, mesh, n_kv_heads=cfg.n_kv_heads),
            "opt": opt_specs, "step": shd.P()}, mesh)
        if data_shards(model, batch, batch_specs, mesh) > 1:
            shard_value_and_grad(model, params, local, row_mesh)
        else:  # the batch whole under the whole mesh, as the step runs it
            shard_value_and_grad(model, params, batch, mesh)
    else:
        params = model.init(None, META)
        # the tensor-parallel route's data shard 0 (the batch whole under
        # the whole mesh where the step runs it as one shard)
        n = data_shards(model, batch, batch_specs, mesh)
        shard = local if n > 1 else batch
        if shape.kind == "prefill":
            shard_prefill(model, params, shard, row_mesh if n > 1 else mesh, 0, n,
                          tensor_parallel=True)
        else:
            cache_len = model.cache_len_for(shape.seq_len)
            window = model.decode_window_for(shape.seq_len)
            cache = model.init_cache(shape.global_batch, cache_len, META)
            cache_specs = shd.cache_spec(cache, mesh)
            out.update(cache_len=cache_len, window=window,
                       bytes_cache=nbytes(cache, cache_specs, mesh))
            # the donating decode writes the cache in place
            out["alias_size_in_bytes"] = out["bytes_cache"]
            # the cache placed by its specs (which may put "data" on a
            # non-batch dim, such as enc_out's width, or W at B 1): the
            # shard reads its units' boxes from the pieces
            placed = shd.place(cache, shd.to_named(cache_specs, mesh))
            shard_decode(model, params, placed, shard, mesh, 0, n, window=window,
                         tensor_parallel=True)
    out["bytes_params"] = nbytes(
        params, shd.tree_param_specs(params, mesh, n_kv_heads=cfg.n_kv_heads), mesh)
    out["n_params"] = tree_size(params)
    return out


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False) -> Dict[str, Any]:
    cfg = get_arch(arch)
    shape = INPUT_SHAPES[shape_name]
    dims, axes = _production_shape(multi_pod)
    n_dev = math.prod(dims)
    mesh = make_mesh(dims, axes, devices=[META] * n_dev)
    row_dims = tuple(d if a == "model" else 1 for d, a in zip(dims, axes))
    row_mesh = make_mesh(row_dims, axes, devices=[META] * math.prod(row_dims))
    dp_dims = tuple(1 if a == "model" else d for d, a in zip(dims, axes))
    dp_mesh = make_mesh(dp_dims, axes, devices=[META] * math.prod(dp_dims))
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in dims),
        "multi_pod": multi_pod,
    }
    try:
        # ---- the deliverable: the full production config runs shape-correct
        t0 = time.time()
        part = _run_combo(cfg, shape, mesh, row_mesh, dp_mesh)
        record["lower_s"] = round(time.time() - t0, 2)
        record["status"] = "ok"

        # ---- analytic reference
        n_params = part.pop("n_params")
        n_act = active_params(cfg, n_params)
        record["n_params"] = int(n_params)
        record["n_active_params"] = int(n_act)
        record["model_flops"] = model_flops(cfg, shape, n_params, n_act)
        record.update(part)
        total = sum(part[k] for k in ("bytes_params", "bytes_opt", "bytes_batch", "bytes_cache"))
        record["bytes_per_device"] = total
        record["fits_card"] = total <= CARD_HBM_BYTES
        record["t_compute_s"] = record["model_flops"] / n_dev / CARD_BF16_FLOPS
        record["t_memory_s"] = total / CARD_HBM_BYTES_PER_S
        terms = {"compute": record["t_compute_s"], "memory": record["t_memory_s"]}
        record["bottleneck"] = max(terms, key=terms.get)
        return record
    except Exception as e:  # noqa: BLE001 -- we want the failure in the table
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"[:500]
        return record


LONG_SKIP: Dict[str, str] = {}  # all archs run long_500k (window cache)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--out", default="build/dryrun_results.json")
    args = ap.parse_args(argv)

    combos = []
    if args.all:
        for a in ASSIGNED_ARCHS:
            for s in INPUT_SHAPES:
                combos.append((a, s))
    else:
        combos.append((args.arch, args.shape))

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r.get("multi_pod", False))
            for r in results if r.get("status") == "ok"}

    for arch, shape in combos:
        key = (arch, shape, args.multipod)
        if key in done:
            print(f"[skip] {arch} x {shape} (cached)")
            continue
        print(f"[dryrun] {arch} x {shape} multi_pod={args.multipod} ...", flush=True)
        rec = dryrun_one(arch, shape, multi_pod=args.multipod)
        print(f"  -> {rec['status']}"
              + (f" run={rec.get('lower_s')}s bytes/device={rec.get('bytes_per_device')}"
                 f" fits={rec.get('fits_card')} bottleneck={rec.get('bottleneck')}"
                 if rec["status"] == "ok" else f" {rec.get('error', '')[:200]}"),
              flush=True)
        results = [r for r in results
                   if not (r["arch"] == arch and r["shape"] == shape
                           and r.get("multi_pod", False) == args.multipod)]
        results.append(rec)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
