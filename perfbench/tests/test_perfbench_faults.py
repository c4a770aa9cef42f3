"""A whole run of each cell on the CPU, past the harness's look for a
card, at a small size: sound, it is correct; with the timed path broken
underneath (a step that returns its state unchanged, a step over half its
batch), ``correct`` comes out false under the cell's limits."""

import copy

import pbsmall
import pytest
import torch

from perfbench import spec
from perfbench.kinds import markov_lm as K

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _unchanged(real):
    def make(model, opt, **kw):
        step = real(model, opt, **kw)
        return lambda state, batch: (state, step(copy.deepcopy(state), batch)[1])
    return make


def _half_batch(real):
    def make(model, opt, **kw):
        step = real(model, opt, **kw)

        def half(state, batch):
            t = batch["tokens"]
            return step(state, dict(batch, tokens=t[: t.shape[0] // 2]))
        return half
    return make


FAULTS = {"sound": None, "state_unchanged": _unchanged, "half_batch": _half_batch}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_is_correct_only_when_sound(cell, fault, monkeypatch):
    from repro_torch.launch import steps

    wl = spec.workload(BENCH, cell)
    arch, cfg = pbsmall.small(wl["config"])
    tr = pbsmall.small_traffic(wl["traffic"], batch=4, seq=16)
    if FAULTS[fault]:
        monkeypatch.setattr(steps, "make_train_step", FAULTS[fault](steps.make_train_step))
    out = K.run(cfg, tr, seed=2**31 + 99, seconds=0.05, trace=False, device="cpu",
                t0=0.0, arch=arch, limits=spec.limits(cell))
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["correct"] is (fault == "sound"), out["checks"]
