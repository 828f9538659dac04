"""The run's surroundings: build caches inside the checkout, the card, and
the check that neither JAX nor the JAX package was loaded."""

from __future__ import annotations

import os
import subprocess
import sys

from gpubench.lib.spec import BENCH

# top-level module names a run may not hold, compared whole: the port's
# name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "hybrid_gmres_tpu")
CACHE = os.path.join(BENCH, "_cache")


def fix_caches():
    """Every build and kernel cache at a fixed path inside the checkout, set
    before torch is imported.  (The port builds its own libraries into its
    package's ``_build/``, inside the checkout too.)"""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's, JAX's helpers' or the
    JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def load_average() -> str:
    """The host's load averages over 1, 5 and 15 minutes, for the log."""
    try:
        with open("/proc/loadavg") as f:
            return " ".join(f.read().split()[:3])
    except OSError:
        return "unknown"


def card_facts(count: int) -> dict:
    """The card's name and power limit, for the result and the log."""
    import torch

    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=count, power_limit=limit.splitlines()[0] if limit
                else "unknown")


def require_cards(count: int):
    """Exit without a result unless ``count`` CUDA cards are visible: a
    measurement never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("gpubench: no CUDA card (torch.cuda.is_available() is "
                 "false); nothing measured")
    if torch.cuda.device_count() < count:
        sys.exit(f"gpubench: the cell needs {count} cards, "
                 f"{torch.cuda.device_count()} visible; nothing measured")
