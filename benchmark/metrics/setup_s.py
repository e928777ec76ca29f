"""setup_s: from the process's start to the first timed product (host
clock): imports, kernel builds, matrix, pack or load, upload, inputs and
warm-up."""


def read(ctx):
    return ctx.get("setup_s")
