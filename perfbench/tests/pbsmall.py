"""Small cells of the benchmark for the CPU tests: each configuration's
family at a few layers and narrow widths, float32 (the program's
``reduced()`` with a small vocabulary), and a short token stream."""

from __future__ import annotations

import dataclasses
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import spec  # noqa: E402

SMALL = {
    "stablelm-1.6b": dict(vocab_size=256, d_model=64, d_ff=128),
    "zamba2-2.7b": dict(vocab_size=256, d_model=64, d_ff=128, n_layers=4, attn_every=2,
                        ssm_state=16),
}


def cfg_of(arch, base):
    """The config dict the harness reads, for a program config ``arch``."""
    d = {f.name: getattr(arch, f.name) for f in dataclasses.fields(arch)
         if isinstance(getattr(arch, f.name), (int, float, str, bool))}
    d.update(registry=arch.name, family=base["family"], head_dim=arch.resolved_head_dim(),
             d_inner=arch.resolved_d_inner(), ssm_heads=arch.resolved_ssm_heads(),
             probes=base["probes"])
    return d


def small(config_name: str, dtype: str = "float32"):
    """(arch, cfg) of a configuration cut for the CPU."""
    from repro_torch.configs import get_arch

    arch = get_arch(config_name).reduced().with_(
        **SMALL[config_name], param_dtype=dtype, compute_dtype=dtype)
    return arch, cfg_of(arch, spec.config(config_name))


def small_traffic(traffic_name: str, batch: int = 4, seq: int = 32):
    return dict(spec.traffic(traffic_name), batch=batch, seq=seq)
