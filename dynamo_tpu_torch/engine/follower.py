"""Shard followers: ranks 1..n-1 of a mesh, running what rank 0 broadcasts.

A port-only module: the JAX package has no counterpart, because JAX drives
every device of a host from one program (GSPMD) and the sharded steps are
one compiled program.  The port runs one process per rank (``utils/mesh.py``),
and only rank 0 runs the engine (``engine/core.py``: the scheduler, the block
manager, the sampler, the front door).  Every other rank runs
:meth:`Follower.run`: it waits in a broadcast for rank 0's next operation and
runs it on its own slice of the model and its own cache, entering the same
collectives in the same order.  Nothing here schedules, samples or touches a
generator.

The operations, tuples rank 0 broadcasts with ``Mesh.broadcast_object``:

* ``("mesh", shape)`` — lay the world out anew as a (dp, tp) mesh
  (:func:`remesh`; every rank creates the new groups);
* ``("model", spec)`` — build this rank's model
  (``models/loader.py::model_from_spec``), dropping the previous one;
* ``("engine", num_blocks, block_size, cache_dtype)`` — a fresh cache
  (``EngineCore.__init__`` sends it);
* ``("step", name, host_arrays, statics)`` — one dispatch, a
  ``engine/core.py::STEP_FNS`` function on the uploaded arrays;
* ``("scatter", block_ids, parts)`` — write this rank's kv heads of
  handed-off or restored whole blocks; ``("gather", block_ids)`` — take
  part in a gather of whole blocks onto rank 0, for a handoff out or an
  offload to the host tier;
* ``("call", "module:function", args)`` — ``function(ctx, *args)`` on every
  rank (``ctx`` is the follower: ``.mesh``, ``.model``, ``.cache``,
  ``.device``), for per-rank work that is not a dispatch (the tests' and
  ``chip_smoke.py``'s checks);
* ``("close",)`` drops the cache, ``("free",)`` the model too, ``("stop",)``
  ends the loop.

A failed operation ends the process with a non-zero exit: its peers'
collectives then raise (rank 0's next dispatch), so the world comes down.

Entry point (``run --tp N`` starts it; by hand with the ``DYN_MH_*``
variables of ``runtime/multihost.py`` set):

    python -m dynamo_tpu_torch.engine.follower [--device cuda:1|cpu]
"""

from __future__ import annotations

import argparse
import gc
import importlib
import logging
import os
import sys
from collections import Counter
from typing import Optional

import numpy as np
import torch

log = logging.getLogger("dynamo_tpu_torch.follower")

__all__ = ["Follower", "broadcast_model", "call_all", "free_followers", "stop_followers",
           "remesh", "rank_device", "mesh_from_env", "main"]


def _resolve(ref: str):
    mod, _, name = ref.partition(":")
    return getattr(importlib.import_module(mod), name)


class Follower:
    """One follower rank's model, cache and loop."""

    def __init__(self, mesh, device: torch.device):
        self.mesh = mesh
        self.device = torch.device(device)
        self.model = None
        self.cache = None
        self.handled: Counter = Counter()

    def run(self) -> None:
        """Run rank 0's operations until ``stop``."""
        while True:
            msg = self.mesh.broadcast_object()
            op = msg[0]
            self.handled[op] += 1
            if op == "stop":
                return
            getattr(self, "_op_" + op)(*msg[1:])

    # ------------------------------------------------------------ operations
    def _op_mesh(self, shape: tuple) -> None:
        from dynamo_tpu_torch.utils.mesh import MESH_AXES, build_mesh

        self._op_free()
        self.mesh = build_mesh(shape, MESH_AXES, device=self.device)

    def _op_model(self, spec: dict) -> None:
        from dynamo_tpu_torch.models.loader import model_from_spec

        self._op_free()
        self.model = model_from_spec(spec, self.device, self.mesh)

    def _op_engine(self, num_blocks: int, block_size: int, cache_dtype) -> None:
        self.cache = None
        self.cache = self.model.init_kv_cache(num_blocks, block_size, cache_dtype)

    def _up(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _op_step(self, name: str, host: tuple, statics: dict) -> None:
        from dynamo_tpu_torch.engine.core import STEP_FNS

        fn, n_fwd = STEP_FNS[name]
        if len(host) != n_fwd:
            raise ValueError(f"{name}: {len(host)} operands, expected {n_fwd}")
        args = tuple(self._up(a) for a in host)
        # no generator and no sampling operands: rank 0 samples
        fn(self.model, self.cache, *args, None, None, None, None, **statics)

    def _op_scatter(self, block_ids: list, parts: tuple) -> None:
        from dynamo_tpu_torch.engine.core import shard_blocks
        from dynamo_tpu_torch.ops.block_copy import scatter_blocks_inplace
        from dynamo_tpu_torch.ops.kv_quant import QuantKvCache

        parts = tuple(b.to(self.device) for b in shard_blocks(self.model, parts))
        blocks = QuantKvCache(*parts) if len(parts) == 2 else parts[0]
        scatter_blocks_inplace(self.cache, block_ids, blocks)

    def _op_gather(self, block_ids: list) -> None:
        from dynamo_tpu_torch.engine.core import gather_shard_blocks

        gather_shard_blocks(self.model, self.cache, block_ids)

    def _op_call(self, ref: str, args: tuple) -> None:
        _resolve(ref)(self, *args)

    def _op_close(self) -> None:
        self.cache = None
        _release(self.device)

    def _op_free(self) -> None:
        self.model = self.cache = None
        _release(self.device)


def _release(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# -------------------------------------------------------- rank 0's side
def remesh(mesh, shape: tuple):
    """Rank 0: the same world laid out as a (dp, tp) mesh of ``shape``
    (the followers drop their models and build it too)."""
    from dynamo_tpu_torch.utils.mesh import MESH_AXES, build_mesh

    mesh.broadcast_object(("mesh", tuple(shape)))
    return build_mesh(shape, MESH_AXES, device=mesh.device)


def broadcast_model(spec: dict, mesh, device=None):
    """Rank 0: have every follower build its slice of the model ``spec``
    describes, then build rank 0's (``models/loader.py::model_from_spec``)."""
    from dynamo_tpu_torch.models.loader import model_from_spec

    if mesh is not None and mesh.size > 1:
        mesh.broadcast_object(("model", spec))
    return model_from_spec(spec, device, mesh)


class _Root:
    """Rank 0's context for :func:`call_all`: its mesh, model and device (the
    model's, else the mesh's: NCCL takes only tensors on the card)."""

    def __init__(self, mesh, model=None, cache=None, device=None):
        self.mesh, self.model, self.cache = mesh, model, cache
        if device is None:
            device = model.device if model is not None else (
                mesh.device if mesh is not None else "cpu")
        self.device = torch.device(device)


def call_all(mesh, ref: str, *args, model=None, cache=None, device=None):
    """Rank 0: run ``ref`` ("module:function") as ``function(ctx, *args)``
    on every rank; returns rank 0's result."""
    if mesh is not None and mesh.size > 1:
        mesh.broadcast_object(("call", ref, args))
    return _resolve(ref)(_Root(mesh, model, cache, device), *args)


def free_followers(mesh) -> None:
    """Rank 0: have the followers drop their models and caches."""
    if mesh is not None and mesh.size > 1:
        mesh.broadcast_object(("free",))


def stop_followers(mesh) -> None:
    """Rank 0: end the followers' loops (each process then exits 0)."""
    if mesh is not None and mesh.size > 1:
        mesh.broadcast_object(("stop",))


# ------------------------------------------------------------ entry point
def rank_device(device: Optional[str] = None) -> torch.device:
    """This rank's device: the named one, else ``cuda:{local rank % cards}``
    (``DYN_MH_LOCAL_RANK``).  No card and no name raises, as every entry
    point of the port does."""
    from dynamo_tpu_torch.device import resolve_device

    if device is not None:
        return resolve_device(device)
    if not torch.cuda.is_available():
        resolve_device(None)  # raises, naming the missing card
    local = int(os.environ.get("DYN_MH_LOCAL_RANK", os.environ.get("DYN_MH_RANK", "0")))
    return torch.device("cuda", local % torch.cuda.device_count())


def mesh_from_env(device: torch.device):
    """Join the world the ``DYN_MH_*`` variables describe and build its mesh
    (``DYN_MH_MESH`` = "dp,tp", default "1,<world>")."""
    from dynamo_tpu_torch.runtime.multihost import bootstrap, spec_from_env
    from dynamo_tpu_torch.utils.mesh import MESH_AXES, build_mesh

    spec = spec_from_env()
    bootstrap(spec, device)
    shape = tuple(int(x) for x in os.environ.get(
        "DYN_MH_MESH", f"1,{spec.num_processes}").split(","))
    return build_mesh(shape, MESH_AXES, device=device)


def main(argv: Optional[list[str]] = None) -> None:
    p = argparse.ArgumentParser(prog="python -m dynamo_tpu_torch.engine.follower")
    p.add_argument("--device", default=None, help="this rank's device (default: "
                   "cuda:{local rank % cards}; cpu for the tests)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format=f"[rank {os.environ.get('DYN_MH_RANK', '?')}] %(message)s")
    from dynamo_tpu_torch.runtime.multihost import shutdown

    device = rank_device(args.device)
    mesh = mesh_from_env(device)
    log.info("shard follower rank %d of %d on %s (%s)", mesh.rank, mesh.size, device,
             mesh.backend)
    follower = Follower(mesh, device)
    try:
        follower.run()
    except Exception:
        log.exception("shard follower rank %d failed", mesh.rank)
        os._exit(1)  # the peers' collectives raise: the world comes down
    shutdown()


if __name__ == "__main__":
    main()
