"""Parity of the port's telemetry layer with the JAX reference, on the CPU:
the same registry operations and spans give the same ``dump_telemetry``
JSONL lines (timing fields aside) and Perfetto documents of the same
shape, and the helpers (``traced``, ``disabled``, ``get``, ``reset``,
``write_bench_report``) behave as the reference's.
"""

import json

import pytest

from repro.obs import export as jexport
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro_torch import obs as tobs
from repro_torch.obs import export as texport
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace

TIMING = ("ts", "total_us", "max_us")


def _record(metrics, trace):
    """The same writes and spans into a fresh registry and tracer."""
    reg, tr = metrics.Registry(), trace.Tracer()
    reg.inc("ota.rows", 3, kind="int4")
    reg.inc("ota.rows", 2, kind="int4")
    reg.inc("ota.uplink_bytes", 1024)
    reg.set_gauge("ota.noise_std", 0.125)
    reg.set_gauge("ota.truncation_rate", 0.25)
    for v in (0.5, 1.0, 0.75):
        reg.observe("stream.staleness_discount", v)
    reg.observe("wire.quant_mse_proxy", 1e-6, kind="int8")
    tr.enable()
    with tr.span("round", r=0):
        for name in ("plan", "client_train", "fold", "fold"):
            with tr.span(name):
                pass
    with tr.span("finalize", groups=3):
        pass
    tr.disable()
    with tr.span("dropped"):
        pass
    return reg, tr


def _untimed(line):
    return {k: v for k, v in line.items() if k not in TIMING}


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_dump_telemetry_writes_the_reference_lines(tmp_path):
    jreg, jtr = _record(jmetrics, jtrace)
    treg, ttr = _record(tmetrics, ttrace)
    js = jexport.dump_telemetry(str(tmp_path / "j.jsonl"), str(tmp_path / "j.json"),
                                registry=jreg, tracer=jtr)
    ts = texport.dump_telemetry(str(tmp_path / "t.jsonl"), str(tmp_path / "t.json"),
                                registry=treg, tracer=ttr)
    assert ts["metrics"] == js["metrics"]
    assert {k: v["count"] for k, v in ts["spans"].items()} == \
        {k: v["count"] for k, v in js["spans"].items()}
    jl, tl = _lines(tmp_path / "j.jsonl"), _lines(tmp_path / "t.jsonl")
    assert [sorted(d) for d in tl] == [sorted(d) for d in jl]
    assert [_untimed(d) for d in tl] == [_untimed(d) for d in jl]
    assert {d["kind"] for d in tl} == {"counter", "gauge", "histogram", "span"}


def test_export_perfetto_has_the_reference_keys(tmp_path):
    _, jtr = _record(jmetrics, jtrace)
    _, ttr = _record(tmetrics, ttrace)
    jd = json.loads(jtr.export_perfetto())
    path = tmp_path / "trace.json"
    td = json.loads(ttr.export_perfetto(str(path)))
    assert json.loads(path.read_text()) == td
    assert sorted(td) == sorted(jd)
    assert [sorted(e) for e in td["traceEvents"]] == [sorted(e) for e in jd["traceEvents"]]
    for te, je in zip(td["traceEvents"], jd["traceEvents"]):
        assert (te["name"], te["ph"], te.get("args")) == (je["name"], je["ph"], je.get("args"))
        assert te["cat"] == "repro_torch" and je["cat"] == "repro"
    assert ttr.span_names() == jtr.span_names() == {"round", "plan", "client_train", "fold",
                                                    "finalize"}
    assert [e.name for e in ttr.events] == [e.name for e in jtr.events]
    assert [e.depth for e in ttr.events] == [e.depth for e in jtr.events]


def test_traced_and_disabled():
    @tobs.traced()
    def work(x):
        return x + 1

    @tobs.traced("named")
    def other():
        return 7

    assert work(1) == 2  # tracing off: a plain call
    with tobs.enabled() as tr:
        assert work(2) == 3 and other() == 7
        with tobs.disabled():
            assert not tobs.is_enabled()
            work(3)
            with tobs.span("hidden"):
                pass
        assert tobs.is_enabled()
    assert [e.name for e in tr.events] == [work.__wrapped__.__qualname__, "named"]
    assert tobs.get_tracer() is tr and not tobs.is_enabled()
    assert tobs.span("x") is tobs.NULL_SPAN
    assert isinstance(tr.events[0], tobs.SpanEvent) and isinstance(tr, tobs.Tracer)


def test_registry_get_and_reset():
    reg = tmetrics.Registry()
    reg.inc("a", 2, kind="x")
    reg.set_gauge("g", 0.5)
    reg.observe("h", 3.0)
    assert reg.get("a", kind="x") == 2.0 and reg.get("a") is None
    assert reg.get("a", default=-1.0) == -1.0 and reg.get("g") == 0.5
    hist = reg.get("h")
    assert hist == {"count": 1, "total": 3.0, "min": 3.0, "max": 3.0}
    hist["count"] = 99  # a copy, not the stored series
    assert reg.get("h")["count"] == 1
    reg.reset()
    assert reg.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    # the module-level aliases are the process registry's
    assert tmetrics.get == tmetrics.REGISTRY.get and tmetrics.reset == tmetrics.REGISTRY.reset
    tmetrics.inc("test_torch_obs.probe", 4)
    assert tmetrics.get("test_torch_obs.probe") >= 4.0


def test_summary_reads_the_process_globals():
    s = texport.summary()
    assert set(s) == {"metrics", "spans"}
    assert set(s["metrics"]) == {"counters", "gauges", "histograms"}


@pytest.mark.parametrize("payload", [{"b": [1, 2], "a": {"z": 1.5}}, {}])
def test_write_bench_report_writes_the_reference_file(tmp_path, payload, capsys):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jp = jexport.write_bench_report("agg", payload, str(tmp_path / "j"))
    tp = texport.write_bench_report("agg", payload, str(tmp_path / "t"))
    with open(jp) as f, open(tp) as g:
        assert g.read() == f.read()
    assert tp.endswith("/BENCH_agg.json") and "wrote" in capsys.readouterr().out


def test_jsonl_sink_appends_sorted_lines(tmp_path):
    path = str(tmp_path / "s.jsonl")
    for _ in range(2):
        with texport.JsonlSink(path, clock=lambda: 12.5) as sink:
            sink.emit("event", "x", b=1, a=2)
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines == ['{"a": 2, "b": 1, "kind": "event", "name": "x", "ts": 12.5}'] * 2
