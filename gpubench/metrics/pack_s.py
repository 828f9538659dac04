"""Seconds of the operator build (``problems.ct.ct_gpu_operators``: the
Morton relabelling, host packing and the forms on the card), on the
benchmark's own host timer around the call."""


def read(ctx):
    return ctx.timers.get("pack_s")
