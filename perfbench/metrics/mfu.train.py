"""The whole step's share of the card's bf16 peak: the step's model FLOPs
(perfbench/flops.py) times the steps the window finished, over the
window's seconds and the peak, in %."""


def read(rec):
    if not rec.get("steps") or not rec.get("window_s"):
        return None
    rate = rec["step_flops"]["total"] * rec["steps"] / rec["window_s"]
    return 100.0 * rate / rec["peak_flops"]
