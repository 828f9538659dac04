"""Device activities (kernels, copies, sets) of the traced window per
Krylov iteration run in it."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or not ctx.iterations:
        return None
    return len(ctx.trace.device) / ctx.iterations
