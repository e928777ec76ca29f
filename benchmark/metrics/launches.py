"""launches: launches of the program's own kernels per product, by the
program's counter (``cvr_tpu_torch.ops.kernels.launches()``) over the
traced products."""


def read(ctx):
    if "launches" not in ctx:
        return None
    return ctx["launches"] / ctx["products"]
