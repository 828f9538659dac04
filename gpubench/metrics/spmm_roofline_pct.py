"""Share of the roofline bound reached by the multi-RHS operator products
(``matmat``, ``rmatmat``: K2r, K4r, K2w), over every call of the traced
window: sum of bounds / sum of the device time launched inside each call."""

from gpubench.metrics._yardstick import MULTI, roofline_pct


def read(ctx):
    return roofline_pct(ctx, MULTI)
