"""Process-group meshes for row-partitioned operators (PyTorch port).

Twin of ``hybrid_gmres_tpu/parallel/mesh.py``.  Where the JAX package names
a ``jax.sharding.Mesh`` of devices and one program runs over all of them,
the port runs SPMD: one process per card, each calling the same solver, and
a :class:`Mesh` names the ``torch.distributed`` process group they share,
this process's place in it and its device.

The collectives of the JAX schedules map onto ``torch.distributed``:

  * ``psum`` -> :meth:`Mesh.all_reduce` (``all_reduce``, sum);
  * ``all_gather(tiled=True)`` -> :meth:`Mesh.all_gather`
    (``all_gather_into_tensor``);
  * ``psum_scatter(tiled=True)`` -> :meth:`Mesh.reduce_scatter`
    (``reduce_scatter_tensor``, sum);
  * ``ppermute`` by a fixed shift -> :meth:`Mesh.shift`
    (``batch_isend_irecv`` of one send and one receive).

NCCL (the default, on ``cuda:<local rank>``) takes one process per card;
``device="cpu"`` runs the same schedules on gloo, as the CPU tests do.

A 2-D mesh (:func:`make_mesh_2d`) also carries its per-axis groups,
:meth:`Mesh.axis`: ``psum(., "rows")`` over the ranks that share a column
coordinate, ``psum(., "cols")`` over those that share a row coordinate.
"""

from __future__ import annotations

import os
from collections import Counter
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from hybrid_gmres_tpu_torch.utils.device import require_device

# the single-tensor collectives under their current names (torch 2.13
# deprecates the older ones, which earlier versions alone have)
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


@dataclass
class Mesh:
    """A process group and this process's place in it.

    ``ranks``: the global ranks of the group, in mesh order; ``index``: this
    process's position among them (None when it is not a member: every
    process builds every group, as ``torch.distributed.new_group`` asks);
    ``shape``/``axis_names``: the mesh's logical shape (``(p,)`` and one
    name for a 1-D mesh).  ``calls`` counts the collectives this process
    issued, by method name; every collective is issued, at ``size`` 1 too,
    so a run on one card goes through the same NCCL calls as one on
    several."""

    group: object
    ranks: tuple
    index: int | None
    device: torch.device
    shape: tuple
    axis_names: tuple
    calls: Counter = field(default_factory=Counter)
    axes: dict = field(default_factory=dict)

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def coords(self) -> tuple | None:
        """This process's mesh coordinates (row-major over ``shape``)."""
        if self.index is None:
            return None
        out, i = [], self.index
        for extent in reversed(self.shape):
            out.append(i % extent)
            i //= extent
        return tuple(reversed(out))

    def axis(self, name: str) -> "Mesh":
        """The 1-D sub-mesh of this process along axis ``name`` of a 2-D
        mesh: the ranks that share this process's other coordinate, in
        mesh order, so that its ``index`` is this process's coordinate on
        the axis.  It has its own ``calls``: the collectives issued on it
        are counted there, not in this mesh's."""
        if name not in self.axes:
            raise ValueError(f"no axis {name!r}: this mesh has "
                             f"{list(self.axes) or 'no per-axis groups'}")
        return self.axes[name]

    def _member(self, name):
        self.calls[name] += 1
        if self.index is None:
            raise RuntimeError(f"rank {dist.get_rank()} is not a member of "
                               f"the mesh over ranks {list(self.ranks)}")

    def all_reduce(self, t):
        """Sum of ``t`` over the mesh, on every member (``psum``).

        The sum runs in place on a tensor that owns its memory: a fresh
        ``t`` (what a product or a reduction returns) comes back summed,
        with no copy.  A view (``t._base`` set: a slice, a row, an entry
        of stored state) is copied first, so the tensor it views is never
        overwritten."""
        self._member("all_reduce")
        if t._base is not None:
            t = t.clone(memory_format=torch.contiguous_format)
        else:
            t = t.contiguous()
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t):
        """The members' ``t`` (1-D or more) stacked along dimension 0 in
        mesh order (``all_gather(tiled=True)``)."""
        self._member("all_gather")
        t = t.contiguous()
        out = torch.empty((self.size * t.shape[0], *t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        _all_gather(out, t, group=self.group)
        return out

    def reduce_scatter(self, t):
        """This member's slab of the sum of ``t`` over the mesh, ``t`` cut
        into ``size`` equal slabs along dimension 0 (``psum_scatter``)."""
        self._member("reduce_scatter")
        t = t.contiguous()
        out = torch.empty((t.shape[0] // self.size, *t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        _reduce_scatter(out, t, group=self.group)
        return out

    def shift(self, t, d: int):
        """The ``t`` of the member ``d`` places further on (mod ``size``):
        every member sends its own ``t`` ``d`` places back (``ppermute``
        with the permutation ``(j + d) % p -> j``); a shift by a multiple
        of ``size`` is ``t`` itself, with no call."""
        p = self.size
        if d % p == 0:
            return t
        self._member("shift")
        t = t.contiguous()
        out = torch.empty_like(t)
        send_to = self.ranks[(self.index - d) % p]
        recv_from = self.ranks[(self.index + d) % p]
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, send_to, group=self.group),
            dist.P2POp(dist.irecv, out, recv_from, group=self.group)])
        for req in reqs:
            req.wait()
        return out


def _backend_and_device(device):
    """(backend, device): NCCL on this process's card for ``"cuda"`` (raises
    without one), gloo for ``"cpu"``."""
    dev = require_device(device)
    if dev.type == "cpu":
        return "gloo", dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported mesh device {device!r}")
    if dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                                   % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
    return "nccl", dev


def _group(ranks, backend):
    """The world group when it spans ``ranks`` with ``backend``, else a new
    group (every process must make the same calls, in the same order)."""
    world = dist.get_world_size()
    if list(ranks) == list(range(world)) and \
            dist.get_backend() == backend:
        return dist.group.WORLD
    return dist.new_group(list(ranks), backend=backend)


def _require_initialized():
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group is initialized: call "
            "initialize_multihost() under torchrun, or "
            "torch.distributed.init_process_group(...) first")


def _make(ranks, shape, axis_names, device):
    _require_initialized()
    backend, dev = _backend_and_device(device)
    group = _group(ranks, backend)
    me = dist.get_rank()
    index = ranks.index(me) if me in ranks else None
    return Mesh(group=group, ranks=tuple(ranks), index=index, device=dev,
                shape=tuple(shape), axis_names=tuple(axis_names))


def make_mesh(n_devices: int | None = None, axis_name: str = "rows",
              device="cuda") -> Mesh:
    """1-D mesh over the first ``n_devices`` ranks (default: all).
    ``device``: ``"cuda"`` (NCCL, this process's card; raises without one)
    or ``"cpu"`` (gloo).  Raises when no process group is initialized."""
    _require_initialized()
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(f"requested {n_devices} devices, have {world}")
    return _make(list(range(n_devices)), (n_devices,), (axis_name,), device)


def make_mesh_2d(shape: tuple[int, int], axis_names=("rows", "cols"),
                 device="cuda") -> Mesh:
    """2-D mesh (rows x cols) over the first ``rows * cols`` ranks, in
    row-major order (rank ``i * cols + j`` at coordinates ``(i, j)``): the
    group of all of them, this process's ``coords``, and its per-axis
    sub-meshes (:meth:`Mesh.axis`).  Every process creates every group, in
    one order (the column groups of axis 0, then the row groups of axis
    1), as ``torch.distributed.new_group`` requires; a process outside the
    mesh gets none of the sub-meshes."""
    _require_initialized()
    pr, pc = (int(v) for v in shape)
    need = pr * pc
    if need > dist.get_world_size():
        raise ValueError(f"requested {need} devices, have "
                         f"{dist.get_world_size()}")
    mesh = _make(list(range(need)), (pr, pc), axis_names, device)
    groups = {axis_names[0]: [[i * pc + j for i in range(pr)]
                              for j in range(pc)],
              axis_names[1]: [[i * pc + j for j in range(pc)]
                              for i in range(pr)]}
    for name, rank_lists in groups.items():
        for ranks in rank_lists:
            sub = _make(ranks, (len(ranks),), (name,), device)
            if sub.index is not None:
                mesh.axes[name] = sub
    return mesh


def make_replica_meshes(n_replicas: int, axis_name: str = "rows",
                        device="cuda") -> list[Mesh]:
    """Split the ranks into ``n_replicas`` disjoint 1-D meshes: a
    data-parallel serving fleet, each replica running independent sharded
    solves with no collective across replicas.  Every process builds every
    mesh; it is a member of one."""
    _require_initialized()
    world = dist.get_world_size()
    if n_replicas <= 0 or world % n_replicas:
        raise ValueError(
            f"{world} devices cannot split into {n_replicas} replicas")
    per = world // n_replicas
    return [_make(list(range(i * per, (i + 1) * per)), (per,), (axis_name,),
                  device) for i in range(n_replicas)]
