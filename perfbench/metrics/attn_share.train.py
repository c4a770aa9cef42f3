"""Attention's share of a step's device time, in %: the attention probe's
time a step over the profiled steps' device busy time a step."""


def read(rec):
    probe, prof = rec.get("probes", {}).get("attention"), rec.get("profile")
    if not probe or not prof or not prof["busy_s"]:
        return None
    return 100.0 * probe["step_ms"] / (1e3 * prof["busy_s"] / prof["steps"])
