"""roofline_pct: the least time a product could take on the card (the
larger of its bytes over the memory rate and its operations over the
float32 rate; benchmark/work.py: each stored value read once, X read
once, Y written once, and no index, so that no format can beat it) over
its whole device time, kernels and glue, from the trace, in percent."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["device_s"] <= 0:
        return None
    return 100.0 * ctx["least_s"] / (t["device_s"] / ctx["products"])
