"""The comparison that decides ``correct`` for a training cell.

Both sides give the same readings of the same job's first steps: each
step's loss, the unit norms (a layer's slice of a stacked leaf, or a
leaf) of the first clipped gradient, and of the params' change after the
steps. Three numbers compare them:

- ``loss_gap``: the largest |loss - ref| / |ref| over the steps;
- ``grad_gap``: the worst unit's |norm - ref norm| over the larger of
  its ref norm and the median unit's;
- ``change_gap``: the same of the change, over the units whose ref
  gradient is at least ``NOUGHT`` of the median unit's (a param whose
  gradient is nought to rounding moves under Adam by round-off alone).

Each number has a limit (``perfbench/limits/<cell>.json``, set from the
program's readings over many seeds and the control's); a number with no
limit there is printed and not compared.
"""

from __future__ import annotations

import statistics
from typing import Dict, Optional, Tuple

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
NOUGHT = 1e-3


def worst_unit(a: Dict[str, float], ref: Dict[str, float], keep=None) -> Tuple[float, str]:
    units = [u for u in ref if keep is None or u in keep]
    med = statistics.median(ref[u] for u in units)
    gap, at = 0.0, ""
    for u in units:
        g = abs(a[u] - ref[u]) / max(ref[u], med, 1e-30)
        if g > gap:
            gap, at = g, u
    return gap, at


def gaps(prog: Dict, ref: Dict) -> Dict[str, Dict]:
    """The numbers compared, each with the unit or step it was worst at."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    step = max(range(len(losses)), key=losses.__getitem__)
    med = statistics.median(ref["grad"].values())
    moved = {u for u, g in ref["grad"].items() if g >= NOUGHT * med}
    g, g_at = worst_unit(prog["grad"], ref["grad"])
    c, c_at = worst_unit(prog["change"], ref["change"], keep=moved)
    return {"loss_gap": {"value": losses[step], "at": f"step {step + 1}"},
            "grad_gap": {"value": g, "at": g_at},
            "change_gap": {"value": c, "at": c_at,
                           "left_out": sorted(set(ref["grad"]) - moved)}}


def decide(found: Dict[str, Dict], limits: Dict[str, Optional[float]]) -> Tuple[bool, Dict]:
    """(correct, {number: {"value", "limit"}}): correct where every number
    that has a limit is at or under it."""
    checks, ok = {}, True
    for name in NUMBERS:
        value, limit = found[name]["value"], limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is not None and not value <= limit:
            ok = False
    return ok, checks
