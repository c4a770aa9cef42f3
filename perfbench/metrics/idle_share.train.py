"""The device's idle share over a few profiled steady steps, in %: 1 less
the union of its kernels' intervals over the steps' wall time."""


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["wall_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])
