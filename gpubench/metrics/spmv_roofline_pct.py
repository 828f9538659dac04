"""Share of the roofline bound reached by the single-vector operator
products (``matvec``, ``rmatvec``: K1r, K3r), over every call of the traced
window: sum of bounds / sum of the device time launched inside each call."""

from gpubench.metrics._yardstick import SINGLE, roofline_pct


def read(ctx):
    return roofline_pct(ctx, SINGLE)
