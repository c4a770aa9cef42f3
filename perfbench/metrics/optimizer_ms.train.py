"""Device ms of the step's global-norm clip and donating AdamW update on
the window's own state, between CUDA events."""


def read(rec):
    return rec.get("optimizer_ms")
