"""100 x (1 - the union of the device activity intervals / the window),
from the stretch of requests traced for CUDA activity alone."""

from gpubench.lib import stats


def read(ctx):
    tr = ctx.device_trace
    if tr is None or not tr.device:
        return None
    return stats.idle_pct(tr.device, tr.t0, tr.t1)
