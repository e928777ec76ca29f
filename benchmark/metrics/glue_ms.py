"""glue_ms: device time per product outside the program's own kernels
(the torch ops around them), from the trace."""


def read(ctx):
    t = ctx.get("trace")
    if not t:
        return None
    return (t["device_s"] - t["own_s"]) / ctx["products"] * 1e3
