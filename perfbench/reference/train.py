"""The reference's training steps: the same job as the program's first
steps, in plain float32, a block of rows at a time.

Each step: the mean next-token loss over every row's positions and its
gradients (summed over row blocks, each block's layers recomputed in
the backward), the global-norm clip, then AdamW on f32 moments with a
linear warm-up and a cosine decay; each param's new value
(p + update) is stored back in the dtype the configuration states for
it, as the program stores it. The readings are those the benchmark takes
of the program: each step's loss, the first step's clipped gradient, and
the params' change after the steps.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from perfbench.reference import common as C
from perfbench.reference.layout import leaves


def lr_at(step: int, opt: Dict) -> float:
    """Linear warm-up to ``lr`` over ``warmup`` steps, then a cosine to
    ``min_frac`` of it over the remaining ``total_steps``."""
    lr, warm, total = opt["lr"], opt["warmup"], opt["total_steps"]
    if step < warm:
        return lr * min(step / max(warm, 1), 1.0)
    t = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    fr = opt.get("min_frac", 0.1)
    return lr * (fr + (1 - fr) * 0.5 * (1 + math.cos(math.pi * t)))


def unit_norms(named, lay) -> Dict[str, float]:
    """L2 norm of each unit: every slice of a leaf's stacked axes (a
    layer), or the leaf whole."""
    out = {}
    for name, t in named:
        stack = lay[name].stack
        lead = t.shape[:stack]
        n = torch.linalg.vector_norm(t.detach().float().reshape(int(np.prod(lead)), -1), dim=1)
        for k, idx in enumerate(np.ndindex(*lead) if stack else [()]):
            out[name + "".join(f"[{i}]" for i in idx)] = float(n[k])
    return out


def _tree(named):
    tree = {}
    for name, t in named:
        node = tree
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


def follow(family, cfg: Dict, opt: Dict, params: Dict, batches: List[np.ndarray],
           device, prec: C.Prec = C.Prec("f32"), rows: int = 0) -> Dict:
    """Train ``params`` (not changed) for ``len(batches)`` steps; with
    ``rows`` each batch is cut to its first ``rows`` rows. Returns
    {"loss": [..], "grad": unit norms of the first clipped gradient,
    "change": unit norms of the params' change}."""
    C.tf32_off()
    lay = dict(leaves(family.layout(cfg)))
    p0 = [t.to(device) for _, t in leaves(params)]
    named = [(n, t.clone()) for (n, _), t in zip(leaves(params), p0)]
    m = [torch.zeros(t.shape, dtype=torch.float32, device=device) for _, t in named]
    v = [torch.zeros_like(x) for x in m]
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    per = max(1, 4096 // batches[0].shape[1])  # rows a block: some 4,096 tokens
    out = {"loss": []}
    for step, host in enumerate(batches):
        tokens = torch.as_tensor(host[:rows] if rows else host, device=device)
        live = [t.to(torch.float32, copy=True).requires_grad_(True) for _, t in named]
        tree = _tree([(n, t) for (n, _), t in zip(named, live)])
        count = tokens.shape[0] * (tokens.shape[1] - 1)
        total = 0.0
        for r in range(0, tokens.shape[0], per):
            loss = family.nll_sum(tree, tokens[r:r + per], cfg, prec) / count
            loss.backward()
            total += float(loss.detach())
        out["loss"].append(total)
        grads = [x.grad for x in live]
        del tree, live
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        scale = torch.clamp_max(opt["clip_norm"] / torch.clamp_min(norm, 1e-12), 1.0)
        t = step + 1
        lr = lr_at(step, opt)
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        with torch.no_grad():
            for k, (name, p) in enumerate(named):
                g = grads[k] * scale
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).add_(g.square(), alpha=1 - b2)
                u = -lr * (m[k] / c1) / (torch.sqrt(v[k] / c2) + eps) - lr * wd * p.float()
                p.copy_((p.float() + u).to(p.dtype))
                grads[k] = None
        if step == 0:
            out["grad"] = {k: x / (1 - b1) for k, x in
                           unit_norms(((n, x) for (n, _), x in zip(named, m)), lay).items()}
    out["change"] = unit_norms(((n, p.float() - q.float()) for (n, p), q in zip(named, p0)), lay)
    return out
