"""The dense decoder LM in plain float32 (stablelm-1.6b's family).

A layer: x += attention(rms_norm(x)); x += swiglu(rms_norm(x)). The token
embedding in, a final RMS norm, an untied head out. Params are the tree
``layout`` gives, each per-layer leaf stacked on a leading layer axis.
"""

from __future__ import annotations

from torch.utils.checkpoint import checkpoint

from perfbench import flops
from perfbench.reference import common as C
from perfbench.reference.layout import Leaf


def layout(cfg):
    nl, d, V, F = cfg["n_layers"], cfg["d_model"], cfg["vocab_size"], cfg["d_ff"]
    H, KV, Dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    dt = cfg["param_dtype"]
    return {
        "embed": Leaf((V, d), dt, "embed"),
        "layers": {
            "attn_norm": Leaf((nl, d), dt, "ones", 1),
            "mlp_norm": Leaf((nl, d), dt, "ones", 1),
            "attn": {"wq": Leaf((nl, d, H * Dh), dt, "dense", 1),
                     "wk": Leaf((nl, d, KV * Dh), dt, "dense", 1),
                     "wv": Leaf((nl, d, KV * Dh), dt, "dense", 1),
                     "wo": Leaf((nl, H * Dh, d), dt, "dense", 1)},
            "mlp": {"w_gate": Leaf((nl, d, F), dt, "dense", 1),
                    "w_up": Leaf((nl, d, F), dt, "dense", 1),
                    "w_down": Leaf((nl, F, d), dt, "dense", 1)},
        },
        "final_norm": Leaf((d,), dt, "ones"),
        "lm_head": Leaf((d, V), dt, "dense"),
    }


def matrix_params(cfg) -> int:
    """Matrix params a token passes: every block's and the head."""
    block = flops.attention_block_params(cfg) + 3 * cfg["d_model"] * cfg["d_ff"]
    return cfg["n_layers"] * block + cfg["d_model"] * cfg["vocab_size"]


def applications(cfg):
    """How often a step's forward runs each timed layer."""
    return {"attention": cfg["n_layers"]}


def _layer(lp, x, cfg, prec):
    eps = cfg["norm_eps"]
    x = x + C.attention(lp["attn"], C.rms_norm(x, lp["attn_norm"], eps), cfg, prec)
    return x + C.swiglu(lp["mlp"], C.rms_norm(x, lp["mlp_norm"], eps), prec)


def _at(tree, i):
    return {k: _at(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]


def nll_sum(p, tokens, cfg, prec: C.Prec, remat: bool = True):
    """Summed next-token loss of ``tokens`` (B, S) under f32 params ``p``."""
    x = p["embed"][tokens.long()]
    for i in range(cfg["n_layers"]):
        lp = _at(p["layers"], i)
        if remat:
            x = checkpoint(_layer, lp, x, cfg, prec, use_reentrant=False)
        else:
            x = _layer(lp, x, cfg, prec)
    h = C.rms_norm(x, p["final_norm"], cfg["norm_eps"])
    return C.nll_sum(h, p["lm_head"], tokens, prec)
