"""idle_pct: the share of the traced window (from the first traced
product's first device event to the last one's end) in which no device
work runs, in percent."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
