"""The rank mesh: ONE place that turns a (dp, tp) topology into process
groups, and the one place where the port calls a collective.

The counterpart of ``dynamo_tpu/utils/mesh.py``.  JAX drives every local
device from one process, and its mesh is an array of devices; the port runs
one process per rank (``torch.distributed``), so a :class:`Mesh` is the
world's ranks laid out on named axes, row-major with the LAST axis fastest:
one host's ranks are contiguous, so ``AXIS_MODEL`` (tensor parallelism) lands
within a host and ``AXIS_DATA`` spans hosts, the JAX package's layout.  A
mesh holds this rank's coordinates and one process group per axis line (the
ranks that differ only along that axis).

* :func:`build_mesh` — the mesh over the initialised world
  (``runtime/multihost.py::bootstrap``); a topology of one rank needs no
  world and gives a mesh whose collectives are the identity.
* :func:`abstract_mesh` — the same topology as axis names and sizes, with no
  ranks attached: what sharding specs are pruned against
  (``models/quant.py::prune_specs``).

The collectives (:meth:`Mesh.all_reduce`, :meth:`Mesh.all_gather`,
:meth:`Mesh.broadcast`, :meth:`Mesh.broadcast_object`,
:meth:`Mesh.ring_shift`) are the only calls into ``torch.distributed`` on the
serving path.  The backend is the world's: NCCL on CUDA, gloo on the CPU, and
gloo on CUDA only where ``DYN_MH_BACKEND=gloo`` asked for it (two ranks on
one card, which NCCL refuses).  gloo takes CUDA tensors for broadcast,
all-reduce and all-gather (torch 2.11.0+cu128, checked on an H100); its
send and receive do not (the sender aborts writing device memory to its
socket), so the ring step stages them through pinned host copies here,
explicitly.  Every gloo collective of a CUDA tensor synchronises the
stream.  Each collective adds its host seconds to
:attr:`Mesh.wait_s` (under NCCL that is the enqueue only; under gloo it is
the wait for the card and the peers too).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch

from dynamo_tpu_torch.obs.topology import AXIS_DATA, AXIS_MODEL, AXIS_SP, MESH_AXES

__all__ = ["AXIS_DATA", "AXIS_MODEL", "AXIS_SP", "MESH_AXES", "AbstractMesh", "Mesh",
           "abstract_mesh", "build_mesh"]


def _shape(topology) -> tuple[int, ...]:
    if isinstance(topology, int):
        return (topology,)
    return tuple(int(n) for n in topology)


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no ranks."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def axis_size(self, axis: str) -> int:
        """The size of ``axis``; 1 for an axis the mesh lacks (nothing is
        split over it)."""
        return self.shape.get(axis, 1)


def abstract_mesh(topology, axes: Sequence[str] = MESH_AXES) -> AbstractMesh:
    shape = _shape(topology)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh topology {shape} has {len(shape)} axes but "
                         f"{len(axes)} names {axes}")
    return AbstractMesh(axes, shape)


@dataclass(frozen=True)
class Mesh(AbstractMesh):
    """The world's ranks on named axes, seen from one rank."""

    rank: int = 0
    backend: Optional[str] = None
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    # axis -> (process group, global ranks of this rank's line, in axis order)
    lines: dict = field(default_factory=dict, compare=False)
    # host seconds spent in collectives
    stats: dict = field(default_factory=lambda: {"wait_s": 0.0}, compare=False)

    @property
    def coords(self) -> dict[str, int]:
        out, r = {}, self.rank
        for name, n in reversed(self.shape.items()):
            out[name] = r % n
            r //= n
        return {name: out[name] for name in self.axis_names}

    def axis_index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    @property
    def wait_s(self) -> float:
        return self.stats["wait_s"]

    def _group(self, axis: str):
        if axis not in self.shape:
            raise ValueError(f"axis {axis!r} not in mesh axes {self.axis_names}")
        return self.lines.get(axis, (None, [self.rank]))

    def _timed(self, fn):
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            self.stats["wait_s"] += time.perf_counter() - t0

    # ----------------------------------------------------------- collectives
    def all_reduce(self, t: torch.Tensor, axis: str = AXIS_MODEL) -> torch.Tensor:
        """The sum of ``t`` over ``axis`` in ``t``'s dtype, as the JAX
        package's all-reduce after a row-parallel product runs in the
        product's dtype.  ``t`` itself may be overwritten."""
        group, ranks = self._group(axis)
        if len(ranks) == 1:
            return t
        import torch.distributed as dist

        x = t.contiguous()
        self._timed(lambda: dist.all_reduce(x, group=group))
        return x

    def all_gather(self, t: torch.Tensor, axis: str = AXIS_MODEL, dim: int = -1) -> torch.Tensor:
        """The ranks' ``t`` along ``axis``, concatenated on ``dim`` in axis
        order."""
        group, ranks = self._group(axis)
        if len(ranks) == 1:
            return t
        import torch.distributed as dist

        src = t.contiguous()
        outs = [torch.empty_like(src) for _ in ranks]
        self._timed(lambda: dist.all_gather(outs, src, group=group))
        return torch.cat(outs, dim=dim)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank of the world (written into ``t`` in
        place elsewhere)."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        self._timed(lambda: dist.broadcast(t, src=0))
        return t

    def broadcast_object(self, obj=None):
        """Rank 0's Python object (pickled; numpy arrays travel as they are)
        on every rank of the world."""
        if self.size == 1:
            return obj
        import torch.distributed as dist

        box = [obj if self.is_root else None]
        dev = self.device if self.backend == "nccl" else torch.device("cpu")
        self._timed(lambda: dist.broadcast_object_list(box, src=0, device=dev))
        return box[0]

    def ring_shift(self, tensors: Sequence[torch.Tensor], axis: str) -> list[torch.Tensor]:
        """One step of a ring over ``axis``: each rank sends ``tensors`` to
        the next rank on the axis and returns the previous rank's (the JAX
        package's ``ppermute`` with ``perm = [(j, (j + 1) % n)]``)."""
        group, ranks = self._group(axis)
        n = len(ranks)
        if n == 1:
            return list(tensors)
        import torch.distributed as dist

        i = ranks.index(self.rank)
        nxt, prv = ranks[(i + 1) % n], ranks[(i - 1) % n]
        # gloo cannot send CUDA tensors: stage them through the host
        staged = self.backend == "gloo" and any(t.is_cuda for t in tensors)
        send = [_pinned_copy(t.contiguous()) if staged else t.contiguous() for t in tensors]
        recv = [torch.empty_like(t) for t in send]
        ops = [dist.P2POp(dist.isend, t, nxt, group) for t in send]
        ops += [dist.P2POp(dist.irecv, t, prv, group) for t in recv]

        def run():
            for work in dist.batch_isend_irecv(ops):
                work.wait()

        self._timed(run)
        if staged:
            return [r.to(t.device, non_blocking=True) for r, t in zip(recv, tensors)]
        return recv


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of CUDA tensor ``t``, complete on return."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)  # synchronous for a device-to-host copy
    return host


def build_mesh(topology, axes: Sequence[str] = MESH_AXES, *, device=None) -> Mesh:
    """The mesh of ``topology`` (an int or per-axis sizes) over the
    initialised world, with this rank's coordinates and one process group
    per axis line (every rank creates every group, in one order).  A
    topology of one rank needs no world.  ``device`` is this rank's device
    (where NCCL stages object broadcasts)."""
    base = abstract_mesh(topology, axes)
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if base.size == 1:
        return Mesh(base.axis_names, base.sizes, device=dev)
    import torch.distributed as dist

    if not dist.is_initialized():
        raise ValueError(f"mesh {base.shape} needs {base.size} ranks: no world is initialised "
                         "(runtime/multihost.py::bootstrap)")
    world = dist.get_world_size()
    if world != base.size:
        raise ValueError(f"mesh {base.shape} needs {base.size} ranks, the world has {world}")
    rank = dist.get_rank()
    grid = torch.arange(world).reshape(base.sizes)
    lines = {}
    for ax, name in enumerate(base.axis_names):
        if base.sizes[ax] == 1:
            continue
        moved = grid.movedim(ax, -1).reshape(-1, base.sizes[ax])
        for row in moved.tolist():
            group = dist.new_group(row)
            if rank in row:
                lines[name] = (group, row)
    return Mesh(base.axis_names, base.sizes, rank=rank, backend=dist.get_backend(),
                device=dev, lines=lines)
