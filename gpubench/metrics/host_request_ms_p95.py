"""The 95th percentile of the request times (ms, host clock, sent to
synchronised) of the window's untraced requests: the tail where the host's
launches pace the requests (a traced idle share over 50%)."""

import numpy as np


def read(ctx):
    times = [(done - sent) * 1e3 for sent, done, _ in ctx.untraced]
    return float(np.percentile(times, 95)) if times else None
