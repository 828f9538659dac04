"""Shared experiment utilities: host copies, history trimming, figures.

``run()`` needs only torch and numpy; ``figures()`` imports matplotlib
when it is called (:func:`get_pyplot`)."""

from __future__ import annotations

import os

import numpy as np
import torch


def host(a):
    """A tensor (on any device) or an array as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def torch_dtype(name):
    """``"float32"`` / ``"float64"`` (or a torch dtype) as a torch dtype."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def trim(hist, niters):
    """Finite prefix of a NaN-masked history (reference's 1:k truncation)."""
    h = host(hist)[: int(niters)]
    return h[np.isfinite(h)] if np.isnan(h).any() else h


def save_figure(fig, outdir, name):
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, name)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    return path


def get_pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt
