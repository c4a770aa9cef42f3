"""BENCHMARK.json, every file it names, and the result line's schema."""

import json
import re

import pbsmall
import pytest

from perfbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((pbsmall.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits its 43,200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_bounds():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    for m in BENCH["end_to_end"]:
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["better"] in ("lower", "higher") and UNIT.match(m["unit"])


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_file_loads_and_names_its_cuts(cfg):
    body = json.loads((pbsmall.ROOT / cfg["file"]).read_text())
    assert body["name"] == cfg["name"] and body["source"] and 1 <= len(cfg["source"]) <= 200
    assert sorted(body["reduced"]) == sorted(cfg["reduced"])
    for key in cfg["reduced"]:
        assert key in body and not key.endswith(("_dim", "_rank", "_size"))
    spec.family(body)  # its reference family exists
    for probe in body["probes"]:
        spec.probe(probe)
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files_and_reports_enough(name):
    wl = spec.workload(BENCH, name)
    assert wl["chips"] == 1 and len(wl["why"]) <= 200
    spec.config(wl["config"])
    spec.kind(spec.traffic(wl["traffic"]))
    e2e = {m["name"] for m in spec.metrics_of(BENCH, "end_to_end", name)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_of(BENCH, "per_layer", name)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_a_reader_and_moves_a_reported_metric(metric):
    read = spec.metric_reader(metric["name"])
    assert read({}) is None  # finds nothing to read: leaves the metric out
    for cell in metric["workloads"]:
        assert cell in CELLS
        e2e = {m["name"] for m in spec.metrics_of(BENCH, "end_to_end", cell)}
        assert metric["moves"] in e2e


def test_the_limits_files_name_cells_and_numbers():
    from perfbench import check

    for path in (spec.HERE / "limits").glob("*.json"):
        body = json.loads(path.read_text())
        assert path.stem in CELLS
        assert set(body["limits"]) <= set(check.NUMBERS)


def _fake_out(trace):
    rec = {"steps": 10, "window_s": 10.0, "batch_ms": [1.0, 3.0], "tokens_per_step": 8192,
           "step_flops": {"total": 1e14}, "peak_flops": 989e12,
           "profile": {"busy_s": 2.9, "wall_s": 3.0, "steps": 3, "device_ops": [["k", 1.0]],
                       "idle_gaps": [["h", 0.1]]},
           "probes": {"attention": {"step_ms": 500.0, "model_flops": 5e12}},
           "optimizer_ms": 20.0}
    return {"correct": True, "attempted": 10, "failed": 0,
            "end_to_end": {"train_tokens_per_s": 8192.0, "peak_gib": 20.0, "setup_s": 30.0},
            "records": rec, "device": {"platform": "gpu", "kind": "x", "count": 1,
                                       "memory_peak_bytes": 1},
            "checks": {"loss_gap": {"value": 1e-4, "limit": 1e-3}}}


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line_s_schema(trace):
    from perfbench import run

    line = run.result_line(BENCH, spec.workload(BENCH, CELLS[0]), _fake_out(trace), trace)
    json.dumps(line)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["metrics"]["mfu.train"]["value"] == pytest.approx(100 * 1e15 / 10 / 989e12)
        assert "ssd_share.train" not in line["metrics"]  # no scan in this cell
    else:
        assert set(line["metrics"]) == {"train_tokens_per_s", "peak_gib", "setup_s"}
