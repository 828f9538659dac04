"""Multi-process initialization (PyTorch port of ``parallel/multihost.py``).

Under ``torchrun --nproc_per_node=N`` each process calls
``initialize_multihost()`` first; the mesh builders in ``mesh.py`` then see
the whole job.  Without a multi-process configuration it does nothing, so
the same scripts run everywhere.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from hybrid_gmres_tpu_torch.utils.device import require_device

_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    initialization_timeout: int | None = None,
    device="cuda",
) -> bool:
    """Initialize the default ``torch.distributed`` process group if a
    multi-process job is configured; returns True when it is initialized.

    With no arguments it reads torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``); when none
    of those is set it does nothing and returns False.  Arguments override
    the environment: ``coordinator_address`` (``host:port``),
    ``num_processes``, ``process_id``, ``initialization_timeout`` (seconds).
    ``device``: ``"cuda"`` initializes NCCL on ``cuda:<LOCAL_RANK>`` (raises
    without a card), ``"cpu"`` gloo.  A configuration that was asked for
    and fails raises: going on alone would compute partial results.
    """
    if dist.is_available() and dist.is_initialized():
        return True
    if (coordinator_address is None and num_processes is None
            and not any(v in os.environ for v in _ENV)):
        return False
    dev = require_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    if initialization_timeout is not None:
        kwargs["timeout"] = datetime.timedelta(
            seconds=initialization_timeout)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, **kwargs)
    return True


def local_shard_info(mesh, axis: str = "rows") -> dict:
    """Where this process stands in ``mesh`` (a :class:`~.mesh.Mesh`), for
    loading its operator shard locally instead of broadcasting the whole
    matrix: ``mesh_size`` (its ranks), ``local_device_ids`` (the index of
    the card this rank drives, 0 for the CPU, when it is a member of the
    mesh; else empty), ``process_index`` and ``process_count`` (this
    rank and the world size of ``torch.distributed``).

    JAX runs one process per host over many devices, so its
    ``local_device_ids`` lists every device of the host in the mesh; the
    port runs one process per card, so the list holds at most one entry,
    and the process index is the rank.  ``axis`` is accepted for the JAX
    signature and, as there, reads nothing."""
    member = mesh.index is not None
    return {
        "mesh_size": mesh.size,
        "local_device_ids": ([mesh.device.index or 0] if member else []),
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
    }
