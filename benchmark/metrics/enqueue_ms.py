"""enqueue_ms: the median host time to enqueue one product, over calls
each issued right after a synchronize (so the launch queue is empty)."""

import statistics


def read(ctx):
    samples = ctx.get("enqueue_s")
    if not samples:
        return None
    return statistics.median(samples) * 1e3
