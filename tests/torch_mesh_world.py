"""A real gloo world for the port's mesh tests, on the CPU.

:class:`World` makes this test process rank 0 and starts ``n - 1`` shard
follower processes (the port's own entry point, ``engine/follower.py``, with
``--device cpu``), which join through the port's rendezvous: a coordinator
on a thread of this process, where rank 0 publishes the world's TCPStore
address (``runtime/multihost.py``).  Rank 0 then drives the followers with
the port's broadcasts: models (``broadcast_model``), engine dispatches
(an ``EngineCore`` on a sharded model), and the per-rank functions below
(``call_all``), which every rank runs on its own chunk or slice.

This module imports nothing of JAX: the follower processes import it.
"""

from __future__ import annotations

import asyncio
import os
import subprocess
import sys
import threading
import uuid

import numpy as np
import torch

import dynamo_tpu_torch
from dynamo_tpu_torch.engine.follower import call_all, remesh, stop_followers
from dynamo_tpu_torch.runtime.multihost import MultiHostSpec, bootstrap, shutdown
from dynamo_tpu_torch.utils.mesh import AXIS_DATA, AXIS_MODEL, MESH_AXES, build_mesh

HERE = __name__


class Coordinator:
    """The port's CoordinatorServer on a private event-loop thread."""

    def __init__(self):
        from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorServer

        self._loop = asyncio.new_event_loop()
        ready = threading.Event()

        async def start():
            self.server = await CoordinatorServer(port=0).start()
            ready.set()

        def run():
            asyncio.set_event_loop(self._loop)
            self._loop.create_task(start())
            self._loop.run_forever()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        if not ready.wait(20):
            raise RuntimeError("coordinator did not start")
        self.url = self.server.url

    def stop(self):
        async def halt():
            await self.server.stop()
            # reap every task the server leaves (its expiry loop, handlers)
            rest = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
            for t in rest:
                t.cancel()
            await asyncio.gather(*rest, return_exceptions=True)
            self._loop.stop()

        asyncio.run_coroutine_threadsafe(halt(), self._loop)
        self._thread.join(10)
        self._loop.close()


# a collective waits this long for its peers: a desynchronised test world
# fails instead of hanging the suite
TIMEOUT_S = 120.0


class World:
    """Rank 0 here, ranks 1..n-1 as follower processes, one gloo world."""

    def __init__(self, n: int, shape: tuple):
        self.coord = Coordinator()
        group = f"test-{uuid.uuid4().hex[:8]}"
        env = dict(os.environ, DYN_MH_NPROCS=str(n), DYN_MH_GROUP=group,
                   DYN_MH_COORDINATOR=self.coord.url, DYN_MH_MESH=",".join(map(str, shape)),
                   DYN_MH_TIMEOUT_S=str(TIMEOUT_S), OMP_NUM_THREADS="1")
        env.pop("DYN_MH_STORE", None)
        cmd = [sys.executable, "-m", f"{dynamo_tpu_torch.__name__}.engine.follower",
               "--device", "cpu"]
        self.procs = [subprocess.Popen(cmd, env=dict(env, DYN_MH_RANK=str(r)),
                                       stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
                      for r in range(1, n)]
        try:
            bootstrap(MultiHostSpec(num_processes=n, process_id=0, group=group,
                                    coordinator_url=self.coord.url, timeout_s=TIMEOUT_S),
                      device="cpu")
            self.mesh = build_mesh(shape, MESH_AXES)
        except BaseException:
            self.close()
            raise
        finally:
            # the rendezvous is over once the world is up
            self.coord.stop()

    def layout(self, shape: tuple):
        """The world as a (dp, tp) mesh of ``shape``."""
        if tuple(self.mesh.sizes) != tuple(shape):
            self.mesh = remesh(self.mesh, shape)
        return self.mesh

    def close(self):
        try:
            if getattr(self, "mesh", None) is not None:
                stop_followers(self.mesh)
        finally:
            shutdown()
            for p in self.procs:
                try:
                    p.wait(timeout=20)
                except subprocess.TimeoutExpired:
                    p.kill()

    def call(self, fn, *args, model=None):
        """``fn(ctx, *args)`` (a function of this module) on every rank;
        rank 0's result."""
        return call_all(self.mesh, f"{HERE}:{fn.__name__}", *args, model=model)


# ------------------------------------------------------- per-rank functions
def _chunk(ctx, a: np.ndarray, axis: int = 1) -> torch.Tensor:
    """This data rank's chunk of ``a`` along ``axis``."""
    n, i = ctx.mesh.axis_size(AXIS_DATA), ctx.mesh.axis_index(AXIS_DATA)
    c = a.shape[axis] // n
    return torch.from_numpy(np.ascontiguousarray(np.take(a, range(i * c, (i + 1) * c),
                                                         axis=axis)))


def ring_case(ctx, q, k, v, q_pos, kv_pos, kw: dict, axis: str = AXIS_DATA):
    """Ring attention over "data" on each rank's chunk; the chunks gathered
    back in order."""
    from dynamo_tpu_torch.ops.ring_attention import ring_attention

    out = ring_attention(_chunk(ctx, q), _chunk(ctx, k), _chunk(ctx, v), _chunk(ctx, q_pos),
                         _chunk(ctx, kv_pos), mesh=ctx.mesh, axis=axis, **kw)
    return ctx.mesh.all_gather(out, AXIS_DATA, dim=1).numpy()


def sp_forward(ctx, tokens, positions):
    """``forward_seq_parallel`` of each rank's chunk over "data": the whole
    (hidden [B, S, Dm], kv [L, 2, B, S, W]), gathered."""
    hidden, kv = ctx.model.forward_seq_parallel(_chunk(ctx, tokens), _chunk(ctx, positions),
                                                sp_axis=AXIS_DATA)
    return (ctx.mesh.all_gather(hidden, AXIS_DATA, dim=1).numpy(),
            ctx.mesh.all_gather(kv, AXIS_DATA, dim=3).numpy())


def logits_case(ctx, tokens, positions, num_blocks: int, block_size: int):
    """One paged prefill forward of the sharded model into a fresh cache and
    the logits of every position ([B, S, V], the vocab shards gathered)."""
    model = ctx.model
    b, s = tokens.shape
    cache = model.init_kv_cache(num_blocks, block_size)
    nb = -(-s // block_size)
    bt = torch.arange(b * nb, dtype=torch.int32).reshape(b, nb)
    pos = torch.from_numpy(positions)
    slot = bt.gather(1, (pos // block_size).long()) * block_size + pos % block_size
    hidden, _ = model.forward(torch.from_numpy(tokens), pos, cache, bt,
                              torch.full((b,), s, dtype=torch.int32), slot)
    return model.compute_logits(hidden.reshape(b * s, -1)).reshape(b, s, -1).numpy()


def handled_steps(ctx):
    """Each rank's count of replayed dispatches (rank 0: 0), gathered."""
    mine = torch.tensor([float(getattr(ctx, "handled", {}).get("step", 0))])
    group_all = ctx.mesh.all_gather(mine, AXIS_MODEL, dim=0) if AXIS_MODEL in ctx.mesh.lines \
        else mine
    if AXIS_DATA in ctx.mesh.lines:
        group_all = ctx.mesh.all_gather(group_all, AXIS_DATA, dim=0)
    return group_all.tolist()
