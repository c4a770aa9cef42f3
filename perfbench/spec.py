"""``BENCHMARK.json`` and the files it names, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<workload>.json``, ``metrics/<metric>.py`` (each a ``read(rec)``
that returns the metric's number, or None where it finds nothing to
read), ``reference/<family>.py`` and ``kinds/<traffic kind>.py`` (the
driver of one kind of cell)."""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
from typing import Dict, List

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(kind: str, name: str) -> Dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def config(name: str) -> Dict:
    return _json("configs", name)


def traffic(name: str) -> Dict:
    return _json("traffic", name)


def limits(workload_name: str) -> Dict:
    path = HERE / "limits" / f"{workload_name}.json"
    return json.loads(path.read_text())["limits"] if path.exists() else {}


def family(cfg: Dict):
    return importlib.import_module(f"perfbench.reference.{cfg['family']}")


def kind(traffic_: Dict):
    return importlib.import_module(f"perfbench.kinds.{traffic_['kind']}")


def probe(name: str):
    return importlib.import_module(f"perfbench.probes.{name}")


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: Dict, section: str, workload_name: str) -> List[Dict]:
    """The metrics of ``section`` a workload reports: those that list it,
    and those that list no workloads."""
    return [m for m in bench[section]
            if "workloads" not in m or workload_name in m["workloads"]]
