"""The sharding plane's census held to a real rank mesh: the CPU gloo world
of ``tests/test_torch_mesh.py`` (this process rank 0, one follower), laid
out as (1, 2).

A tensor-parallel engine's ranks hold the bytes of params and cache the
census gives each rank at (1, 2) (``shardcheck.census_at``: meta models on a
``RecordingMesh``), and rank 0's collectives in one decode dispatch, one and
three turns, are the census's: the operand broadcast, two all-reduces a
layer and the logits' gather a turn, a token broadcast each later turn,
counted and sized on the real mesh.
"""

import dataclasses

import pytest
import torch

from dynamo_tpu_torch.analysis import shardcheck
from dynamo_tpu_torch.analysis.shardcheck import census_at, counted_collectives
from dynamo_tpu_torch.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.follower import broadcast_model, call_all, free_followers
from dynamo_tpu_torch.engine.request import EngineRequest, RequestState
from dynamo_tpu_torch.llm.protocols import SamplingOptions, StopConditions
from dynamo_tpu_torch.models.config import ModelConfig
from tests.torch_mesh_world import World

TP2 = (1, 2)
BASE = dict(max_batch_size=4, max_model_len=128, block_size=8, num_blocks=64)
CFG = ModelConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
                  num_heads=4, num_kv_heads=2, max_position_embeddings=256, dtype="float32")


@pytest.fixture(scope="module")
def world():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    w = World(2, TP2)
    yield w
    w.close()
    torch.set_num_threads(n)


def _census_view(census: dict) -> dict:
    return {k: {"count": v["count"], "payload_bytes": v["payload_bytes"]}
            for k, v in census["collectives"].items()}


@pytest.mark.parametrize("cache_dtype", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("turns", [1, 3])
def test_ranks_and_decode_collectives_equal_the_census(world, cache_dtype, turns):
    spec = {"kind": "init", "family": "llama", "seed": 0, "config": dataclasses.asdict(CFG)}
    model = broadcast_model(spec, world.layout(TP2), "cpu")
    cfg = dict(BASE, decode_steps=turns, interactive_decode_steps=turns, cache_dtype=cache_dtype)
    core = EngineCore(model, EngineConfig(**cfg), eos_token_ids=[], device="cpu")
    try:
        req = EngineRequest(request_id="r", prompt=list(range(3, 15)),
                            sampling=SamplingOptions(temperature=0.0),
                            stops=StopConditions(max_tokens=2 + 2 * turns, ignore_eos=True),
                            emit=lambda o: None)
        core.submit(req)
        while req.state is not RequestState.RUNNING:
            assert core.step()
        d0, p0 = core.decode_steps, core.prefill_steps
        with counted_collectives(world.mesh) as got:
            assert core.step()
        assert core.decode_steps == d0 + turns and core.prefill_steps == p0
        resident = call_all(world.mesh, f"{shardcheck.__name__}:gathered_resident_bytes",
                            model=model, cache=core.cache)
    finally:
        core.close()
        free_followers(world.mesh)
    census = census_at(CFG, TP2, BASE["num_blocks"], BASE["block_size"], cache_dtype=cache_dtype,
                       batch=BASE["max_batch_size"], m=BASE["max_model_len"] // BASE["block_size"],
                       num_steps=turns)
    assert resident == census["ranks"]
    assert got == _census_view(census)
    assert got["all_reduce:model"]["count"] == 2 * CFG.num_layers * turns
    assert got["all_gather:model"]["count"] == turns
    assert got["broadcast_object:world"]["count"] == 1
    assert got.get("broadcast:world", {"count": 0})["count"] == turns - 1
