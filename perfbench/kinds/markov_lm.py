"""Training cells: the program's LM train step over a seeded token stream.

Set-up builds one train state (the benchmark's weights from the seed,
the program's AdamW state) and one donating train step
(``repro_torch.launch.steps.make_train_step(..., donate=True)``), and
drives them through the job's first steps with the window's own feed.
Those steps give the program's readings: each step's loss, the first
clipped gradient's unit norms (from AdamW's first moment after one step,
m = (1 - b1) g) and the params' change after the steps. The window then
runs the same step on the same state, a freshly drawn batch a step (the
host draws it, pins it and queues its copy), the losses left on the
device until one synchronise at the end. With ``trace`` a few more steps
run under ``torch.profiler``, the config's layer probes time their layer
at the step's shapes, and the clip and AdamW update are timed on the
window's state. Last the program's state is freed and the plain
reference (``perfbench/reference``) follows the same first steps from
the same weights in float32, and ``perfbench/check.py`` compares.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Dict, Optional

import torch

from perfbench import check, flops, profiling, spec, traffic as feed, weights
from perfbench.reference import train as ref_train
from perfbench.reference.layout import leaves

PROFILED_STEPS = 3
OPTIMIZER_REPS = 3


@dataclasses.dataclass
class Ctx:
    cfg: Dict
    traffic: Dict
    family: Any
    batch: int
    seq: int
    device: torch.device


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check_arch(cfg: Dict, arch) -> None:
    """Every size the config file states equals the program's registry entry."""
    resolved = {"head_dim": arch.resolved_head_dim(), "d_inner": arch.resolved_d_inner(),
                "ssm_heads": arch.resolved_ssm_heads()}
    for f in dataclasses.fields(arch):
        if f.name in cfg and f.name not in ("name", "source"):
            have = resolved.get(f.name, getattr(arch, f.name))
            if have != cfg[f.name]:
                raise ValueError(f"config file says {f.name}={cfg[f.name]!r}, "
                                 f"the program's {arch.name} has {have!r}")


def _check_tree(params, shapes) -> None:
    mine = [(n, tuple(t.shape), t.dtype) for n, t in leaves(params)]
    theirs = [(n, tuple(t.shape), t.dtype) for n, t in leaves(shapes)]
    if mine != theirs:
        raise ValueError(f"the benchmark's param tree differs from the program's: "
                         f"{sorted(set(mine) ^ set(theirs))[:4]}")


def _feed(ctx: Ctx, seed: int):
    """next() -> (device batch, host tokens, host ms)."""
    stream = feed.token_batches(ctx.cfg["vocab_size"], ctx.traffic, seed)
    pin = ctx.device.type == "cuda"

    def nxt():
        t = time.perf_counter()
        host = next(stream)
        tokens = torch.from_numpy(host)
        if pin:
            tokens = tokens.pin_memory()
        batch = {"tokens": tokens.to(ctx.device, non_blocking=pin)}
        return batch, host, (time.perf_counter() - t) * 1e3

    return nxt


def _program(ctx: Ctx, arch, seed: int):
    from repro_torch.launch.steps import make_train_step, train_state_shapes
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw, linear_warmup_cosine

    o = ctx.traffic["optimizer"]
    model = build_model(arch)
    opt = adamw(linear_warmup_cosine(o["lr"], o["warmup"], o["total_steps"], o["min_frac"]),
                o["b1"], o["b2"], o["eps"], o["weight_decay"])
    params = weights.make(ctx.family.layout(ctx.cfg), seed, ctx.device)
    _check_tree(params, train_state_shapes(model, opt)["params"])
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=ctx.device)}
    step_fn = make_train_step(model, opt, clip_norm=o["clip_norm"], donate=True)
    return opt, state, step_fn


def _setup_steps(ctx: Ctx, state, step_fn, nxt):
    """The job's first steps through the window's call and feed; the
    program's readings of them."""
    lay = dict(leaves(ctx.family.layout(ctx.cfg)))
    b1 = ctx.traffic["optimizer"]["b1"]
    p0 = [(n, t.clone()) for n, t in leaves(state["params"])]
    losses, hosts, out = [], [], {}
    for k in range(ctx.traffic["setup_steps"]):
        batch, host, _ = nxt()
        hosts.append(host)
        state, m = step_fn(state, batch)
        losses.append(m["loss"].detach().clone())
        if k == 0:
            out["grad"] = {u: x / (1 - b1) for u, x in
                           ref_train.unit_norms(leaves(state["opt"]["m"]), lay).items()}
    params = dict(leaves(state["params"]))
    out["change"] = ref_train.unit_norms(
        ((n, params[n].float() - q.float()) for n, q in p0), lay)
    del p0
    out["loss"] = [float(x) for x in losses]
    if not feed.rows_all_differ(hosts):
        raise ValueError("two rows of the set-up steps' batches are equal")
    return state, out, hosts


def _window(ctx: Ctx, state, step_fn, nxt, seconds: float) -> Dict:
    losses, batch_ms = [], []
    dev = ctx.device
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    end = t0 + seconds
    while time.perf_counter() < end:
        batch, _, ms = nxt()
        batch_ms.append(ms)
        state, m = step_fn(state, batch)
        losses.append(m["loss"])
    _sync(dev)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    finite = int(torch.isfinite(torch.stack(losses)).sum()) if losses else 0
    return {"state": state, "steps": len(losses), "window_s": window_s, "batch_ms": batch_ms,
            "peak_bytes": int(peak), "failed": len(losses) - finite}


def _optimizer_ms(ctx: Ctx, opt, state) -> float:
    """The step's clip and donating AdamW update, on the window's state,
    between CUDA events (gradients of the params' shapes and dtypes)."""
    from repro_torch.launch.steps import _donated_update
    from repro_torch.optim.optimizers import clip_leaves

    clip = ctx.traffic["optimizer"]["clip_norm"]
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(1)
    times = []
    for _ in range(OPTIMIZER_REPS):
        grads = [torch.randn(p.shape, generator=gen, device=ctx.device, dtype=p.dtype) * 1e-3
                 for p in (t for _, t in leaves(state["params"]))]
        _sync(ctx.device)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        clip_leaves(grads, clip)
        _donated_update(opt, state, grads)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        del grads
    return sorted(times)[len(times) // 2]


def _traced(ctx: Ctx, opt, state, step_fn, nxt) -> Dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    rec: Dict[str, Any] = {}
    _sync(ctx.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            with record_function("batch"):
                batch, _, _ = nxt()
            with record_function("train_step"):
                state, _ = step_fn(state, batch)
        _sync(ctx.device)
        wall = time.perf_counter() - t0
    prof_red = profiling.reduce_profile(prof, annotations=("batch", "train_step"))
    del prof
    rec["profile"] = dict(prof_red, wall_s=wall, steps=PROFILED_STEPS)
    rec["probes"] = {name: spec.probe(name).measure(ctx) for name in ctx.cfg.get("probes", {})}
    rec["optimizer_ms"] = _optimizer_ms(ctx, opt, state)
    return rec


def free() -> None:
    """Return the card memory of what the caller has dropped."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cfg: Dict, traffic: Dict, *, seed: int, seconds: float, trace: bool,
        device, t0: float, arch=None, limits: Optional[Dict] = None) -> Dict:
    """One run of a training cell. Returns {"correct", "attempted",
    "failed", "end_to_end", "records", "device", "checks", "gaps"}."""
    from repro_torch.configs import get_arch

    device = torch.device(device)
    arch = arch if arch is not None else get_arch(cfg["registry"])
    check_arch(cfg, arch)
    ctx = Ctx(cfg, traffic, spec.family(cfg), traffic["batch"], traffic["seq"], device)
    parts = {"imports": time.perf_counter() - t0}
    opt, state, step_fn = _program(ctx, arch, seed)
    nxt = _feed(ctx, seed)
    _sync(device)
    parts["state"] = time.perf_counter() - t0 - sum(parts.values())
    state, prog, hosts = _setup_steps(ctx, state, step_fn, nxt)
    _sync(device)
    setup_s = time.perf_counter() - t0
    parts["steps"] = setup_s - sum(parts.values())

    win = _window(ctx, state, step_fn, nxt, seconds)
    state = win.pop("state")
    tokens = ctx.batch * ctx.seq
    step_flops = flops.train_step_flops(ctx.family, cfg, ctx.batch, ctx.seq)
    records: Dict[str, Any] = {"steps": win["steps"], "window_s": win["window_s"],
                               "batch_ms": win["batch_ms"], "tokens_per_step": tokens,
                               "step_flops": step_flops, "peak_flops": flops.BF16_PEAK,
                               "setup_parts": parts}
    if trace:
        records.update(_traced(ctx, opt, state, step_fn, nxt))
    del state, step_fn, opt
    free()

    t_ref = time.perf_counter()
    params = weights.make(ctx.family.layout(cfg), seed, device)
    ref = ref_train.follow(ctx.family, cfg, traffic["optimizer"], params, hosts, device)
    del params
    records["reference_s"] = time.perf_counter() - t_ref
    found = check.gaps(prog, ref)
    correct, checks = check.decide(found, limits or {})
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": win["peak_bytes"]}
    if trace:
        dev_info.update(busy_s=records["profile"]["busy_s"],
                        window_s=records["profile"]["wall_s"])
    return {
        "correct": bool(correct) and win["failed"] == 0,
        "attempted": win["steps"], "failed": win["failed"],
        "end_to_end": {"train_tokens_per_s": win["steps"] * tokens / win["window_s"],
                       "peak_gib": win["peak_bytes"] / 2**30, "setup_s": setup_s},
        "records": records, "device": dev_info, "checks": checks, "gaps": found,
        "readings": {"program": prog, "reference": ref},
    }

