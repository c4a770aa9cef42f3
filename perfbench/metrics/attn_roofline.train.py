"""Attention's share of its roofline, in %: its causal model FLOPs a step
(forward and backward) at the bf16 peak, over its measured time a step."""


def read(rec):
    probe = rec.get("probes", {}).get("attention")
    if not probe or not probe["step_ms"]:
        return None
    return 100.0 * (probe["model_flops"] / rec["peak_flops"]) / (probe["step_ms"] / 1e3)
