"""Host ms a step spends drawing its batch and queueing the batch's copy
to the card (the entry layer), the mean over the window's steps."""

import statistics


def read(rec):
    times = rec.get("batch_ms")
    return statistics.mean(times) if times else None
