"""Device milliseconds of the Krylov loop's dense linear algebra (gemv,
gemm and bmm, dots, Cholesky, QR, LU and triangular solves, outside the
operator products) per Krylov iteration of the traced window."""


def read(ctx):
    if ctx.trace is None or not ctx.iterations:
        return None
    ms = ctx.trace.krylov_s() * 1e3
    return ms / ctx.iterations if ms > 0 else None
