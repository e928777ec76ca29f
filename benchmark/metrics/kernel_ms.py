"""kernel_ms: device time per product in the program's own kernels (by
name, from the trace of the traced products)."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["own_events"]:
        return None
    return t["own_s"] / ctx["products"] * 1e3
