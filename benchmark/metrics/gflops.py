"""gflops: 2 * nnz * K for each product completed in the window, over
the window's seconds (host clock; the window closes on a synchronize)."""


def read(ctx):
    if "window_s" not in ctx:
        return None
    return ctx["flops"] * ctx["products"] / ctx["window_s"] / 1e9
