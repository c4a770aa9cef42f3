"""On a CUDA card: one short traced run of a cell end to end, and the
profile reduction on kernels of known length. Marked ``cuda``; each
test skips without a card (decided in the fixture)."""

import json
import subprocess
import sys

import pbsmall
import pytest

from perfbench import spec


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_a_short_traced_run_is_correct_and_reports_its_metrics(card):
    cell = "train.stablelm-1.6b.s256"
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                           "2147483659", "--seconds", "3", "--trace", "1"],
                          cwd=pbsmall.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    want = {m["name"] for m in spec.metrics_of(spec.benchmark(), "per_layer", cell)}
    assert set(line["metrics"]) == want
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert line["metrics"]["mfu.train"]["value"] < 100
    assert line["metrics"]["attn_roofline.train"]["value"] < 100


@pytest.mark.cuda
def test_the_profile_reduction_sees_the_sleeping_kernels(card):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench import profiling

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            torch.cuda._sleep(2_000_000)
        torch.cuda.synchronize()
    red = profiling.reduce_profile(prof)
    assert red["kernels"] >= 3 and 0 < red["busy_s"] <= red["span_s"]
