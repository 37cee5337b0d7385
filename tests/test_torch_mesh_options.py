"""The options a rank mesh serves beyond the dispatches, against the JAX
package's meshed engine, on the CPU.

The gloo world of ``tests/test_torch_mesh.py`` (this process is rank 0, one
shard follower process), laid out as (1, 2): the port's engine on a
tensor-parallel model against JAX's ``EngineCore(mesh=build_mesh((1, 2)))``
on the forced CPU devices, each with the same options, f32:

* the host tier: an undersized device pool whose evicted prefix comes back
  from the host, f32 and int8 caches, the pool holding whole blocks;
* the persist tier: files written at tp = 2 restore at tp = 2 and on one
  rank, and files written on one rank restore at tp = 2;
* speculation: n-gram at k = 2 and 4, and a tiny unsharded draft, with a
  seeded temperature row beside the greedy ones;
* lookahead bursts on the unified path, f32 and int8 caches, with a
  seeded row;
* a bf16 cache over the f32 model (``test_kv_persist.py``'s
  ``test_restart_with_different_generation_is_cold``), on one rank and at
  tp = 2;
* the perf model's prediction of a tp = 2 engine's rank 0 equals the one
  rank engine's (the whole model's basis);
* ``run --tp 2`` with a draft model and the host tier starts and answers.

Every stream is token-identical to JAX's; the follower replays every
dispatch rank 0 ran.
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
from safetensors.torch import save_file

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.request import EngineRequest as JaxEngineRequest
from dynamo_tpu.llm import protocols as jax_protocols
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import LlamaModel as JaxLlamaModel
from dynamo_tpu.utils.mesh import MESH_AXES as JAX_MESH_AXES
from dynamo_tpu.utils.mesh import build_mesh as jax_build_mesh
from dynamo_tpu_torch.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.follower import broadcast_model
from dynamo_tpu_torch.engine.request import EngineRequest
from dynamo_tpu_torch.llm import protocols as port_protocols
from dynamo_tpu_torch.llm.kv.host_pool import flatten_blocks
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.llama import LlamaModel
from dynamo_tpu_torch.models.loader import model_from_spec
from tests.test_torch_mesh import _llama, _one_torch_thread, ckpt, world  # noqa: F401 (fixtures)
from tests.torch_mesh_world import handled_steps

TP2 = (1, 2)
BASE = dict(max_batch_size=4, max_model_len=128, block_size=8, num_blocks=64)
TIERS = dict(max_batch_size=2, max_model_len=64, block_size=8, num_blocks=8, num_host_blocks=32)
SEEDED = dict(temperature=0.8, seed=42)
GREEDY = dict(temperature=0.0)


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    """(JAX model, JAX params, the port's model spec) of the f32 tiny
    Llama of ``test_torch_mesh.py``."""
    jmodel, jparams, cfg, state = _llama()
    path = tmp_path_factory.mktemp("mesh_options") / "dense.safetensors"
    save_file({k: v.contiguous() for k, v in state.items()}, str(path))
    return jmodel, jparams, {"kind": "state", "family": "llama",
                             "config": dataclasses.asdict(cfg), "path": str(path)}


@pytest.fixture(scope="module")
def draft():
    """A one-layer draft of the dense model's vocabulary, other weights:
    (JAX model, JAX params, the port's unsharded model)."""
    kw = dict(vocab_size=256, hidden_size=32, intermediate_size=64, num_layers=1, num_heads=2,
              num_kv_heads=1, max_position_embeddings=256, dtype="float32")
    jmodel = JaxLlamaModel(JaxModelConfig(**kw))
    jparams = jmodel.init_params(jax.random.PRNGKey(5))
    cfg = ModelConfig(**kw)
    tree = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, LlamaModel.from_state(cfg, params_from_jax(tree, cfg, device="cpu"))


def _sharded(world, dense):
    return broadcast_model(dense[2], world.layout(TP2), "cpu")


def _one_rank(dense):
    return model_from_spec(dense[2], "cpu")


def _jax_core(dense, mesh=True, draft=None, **kw):
    jmodel, jparams, _ = dense
    return JaxEngineCore(jmodel, jparams, JaxEngineConfig(**kw),
                         mesh=jax_build_mesh(TP2, JAX_MESH_AXES) if mesh else None,
                         eos_token_ids=[], draft=draft)


def _port_core(model, draft=None, **kw):
    return EngineCore(model, EngineConfig(**kw), eos_token_ids=[], device="cpu", draft=draft)


def _serve(core, jax_side: bool, specs, head=2, stagger=3, steps=600):
    """Submit ``head`` of ``specs`` = [(id, prompt, max_tokens, sampling)],
    step ``stagger`` times, submit the rest (so later prompts arrive while
    others decode), run to idle: {id: tokens}."""
    req_cls, proto = ((JaxEngineRequest, jax_protocols) if jax_side
                      else (EngineRequest, port_protocols))
    outs = {rid: [] for rid, *_ in specs}
    reqs = [req_cls(request_id=rid, prompt=list(prompt), sampling=proto.SamplingOptions(**samp),
                    stops=proto.StopConditions(max_tokens=n, ignore_eos=True),
                    emit=lambda o, r=rid: outs[r].extend(o.token_ids))
            for rid, prompt, n, samp in specs]
    for r in reqs[:head]:
        core.submit(r)
    for _ in range(stagger):
        core.step()
    for r in reqs[head:]:
        core.submit(r)
    for _ in range(steps):
        if not core.step():
            break
    return outs


def _collect(core, jax_side: bool, prompt, n, rid):
    """One greedy request run to its end: (tokens, cached prompt tokens)."""
    req_cls, proto = ((JaxEngineRequest, jax_protocols) if jax_side
                      else (EngineRequest, port_protocols))
    outs = []
    req = req_cls(request_id=rid, prompt=list(prompt), sampling=proto.SamplingOptions(**GREEDY),
                  stops=proto.StopConditions(max_tokens=n, ignore_eos=True), emit=outs.append)
    core.submit(req)
    for _ in range(n + 40):
        if not core.step():
            break
    return [t for o in outs for t in o.token_ids], req.cached_tokens


def _specs(seeded: bool):
    """Prompts with repeats (n-gram lookup proposes from the first turn),
    one whose random tail proposes only once its output repeats, and
    optionally a seeded temperature row."""
    rng = np.random.default_rng(3)
    seg = rng.integers(3, 250, 8).tolist()
    specs = [("rep", seg * 3 + [7], 12, GREEDY),
             ("other", rng.integers(3, 250, 5).tolist() * 4, 10, GREEDY),
             ("late", seg * 2 + rng.integers(3, 250, 20).tolist(), 8, GREEDY)]
    if seeded:
        specs.append(("seeded", seg[:5] * 2, 12, SEEDED))
    return specs


def _replayed(world, model, run):
    """``run()``'s result and the dispatches the follower replayed in it."""
    before = world.call(handled_steps, model=model)
    out = run()
    after = world.call(handled_steps, model=model)
    return out, after[1] - before[1]


# ------------------------------------------------------------- host tier
def _churn(core, jax_side: bool, n=4):
    rng = np.random.RandomState(8)
    for i in range(n):
        _collect(core, jax_side, rng.randint(3, 250, size=24), 2, f"churn{i}")


@pytest.mark.parametrize("cache_dtype", [None, "int8"], ids=["f32", "int8"])
def test_host_tier_restores_whole_blocks_at_tp2(world, dense, cache_dtype):
    """An undersized device pool: the prompt's blocks are evicted to the host
    (gathered whole onto rank 0) and restored into each rank's kv heads; the
    streams are JAX's meshed engine's under the same tiers."""
    model = _sharded(world, dense)
    prompt = np.random.RandomState(7).randint(3, 250, size=24)  # 3 full blocks
    core = _port_core(model, **TIERS, cache_dtype=cache_dtype)

    def run():
        first = _collect(core, False, prompt, 6, "a")
        _churn(core, False)
        core.flush_host_offload()
        return first, _collect(core, False, prompt, 6, "b")

    ((got1, _), (got2, cached2)), replayed = _replayed(world, model, run)
    restored = core.tier_stats["restore_blocks"]
    specs = core.host_pool.part_specs()
    core.close()
    one = _port_core(_one_rank(dense), **TIERS, cache_dtype=cache_dtype)
    # the blocks one card holds: its cache's parts without the block axis
    assert specs == [((p.shape[0],) + tuple(p.shape[2:]), p.dtype)
                     for p in flatten_blocks(one.cache)[1]]
    one.close()
    jcore = _jax_core(dense, **TIERS, cache_dtype=cache_dtype)
    ref1, _ = _collect(jcore, True, prompt, 6, "a")
    _churn(jcore, True)
    jcore.flush_host_offload()
    ref2, jcached2 = _collect(jcore, True, prompt, 6, "b")
    jcore.close()
    assert restored > 0 and cached2 >= 16
    assert (got1, got2) == (ref1, ref2) and got1 == got2
    assert cached2 == jcached2
    assert replayed == core.steps > 0


# ----------------------------------------------------------- persist tier
def _fill_and_close(core, prompt):
    """Decode the prompt, churn it out to the host (written through to the
    persist directory), close the engine; the prompt's tokens."""
    got, _ = _collect(core, False, prompt, 6, "cold")
    _churn(core, False)
    core.flush_host_offload()
    assert core.metrics()["persist_blocks"] > 0
    core.close()
    return got


@pytest.mark.parametrize("writer", ["tp2", "one"])
def test_persist_files_restore_across_layouts(world, dense, tmp_path, writer):
    """Files written by a tp = 2 engine hold whole blocks: a restarted tp = 2
    engine and a one-rank engine both restore the prefix from disk, and
    files a one-rank engine wrote restore at tp = 2.  Every stream is the
    cold one and JAX's meshed engine's."""
    sharded = _sharded(world, dense)
    prompt = np.random.RandomState(11).randint(3, 250, size=24)
    make = {"tp2": lambda: sharded, "one": lambda: _one_rank(dense)}
    got = _fill_and_close(_port_core(make[writer](), **TIERS, kv_persist_dir=str(tmp_path)),
                          prompt)
    readers = ("tp2", "one") if writer == "tp2" else ("tp2",)
    for reader in readers:
        core = _port_core(make[reader](), **TIERS, kv_persist_dir=str(tmp_path))
        assert core.host_pool.stored_blocks == 0
        warm, cached = _collect(core, False, prompt, 6, f"warm-{reader}")
        hits = core.metrics()["persist_hits"]
        core.close()
        assert warm == got and cached >= 16 and hits > 0, reader
    jcore = _jax_core(dense, **{k: v for k, v in TIERS.items() if k != "num_host_blocks"})
    assert _collect(jcore, True, prompt, 6, "ref")[0] == got
    jcore.close()


# ----------------------------------------------------------- speculation
@pytest.mark.parametrize("k", [2, 4])
def test_ngram_speculation_at_tp2_matches_jax(world, dense, k):
    model = _sharded(world, dense)
    core = _port_core(model, **BASE, spec_tokens=k)
    out, replayed = _replayed(world, model, lambda: _serve(core, False, _specs(seeded=k == 4)))
    core.close()
    jcore = _jax_core(dense, **BASE, spec_tokens=k)
    ref = _serve(jcore, True, _specs(seeded=k == 4))
    jcore.close()
    assert out == ref
    assert all(len(out[rid]) == n for rid, _, n, _ in _specs(seeded=k == 4))
    assert core.spec_steps > 0 and core.spec_accepted > 0
    assert core.spec_accepted == jcore.spec_accepted
    assert replayed == core.steps


def test_draft_speculation_at_tp2_matches_jax(world, dense, draft):
    """The draft stays whole on rank 0's device beside the sharded target
    and takes part in no collective; its proposals are verified by the
    broadcast verify."""
    jdmodel, jdparams, port_draft = draft
    model = _sharded(world, dense)
    core = _port_core(model, draft=port_draft, **BASE, spec_tokens=3)
    out, replayed = _replayed(world, model, lambda: _serve(core, False, _specs(seeded=True)))
    core.close()
    jcore = _jax_core(dense, draft=(jdmodel, jdparams), **BASE, spec_tokens=3)
    ref = _serve(jcore, True, _specs(seeded=True))
    jcore.close()
    assert out == ref
    assert port_draft.mesh is None
    assert core.draft.dispatches == jcore.draft.dispatches > 0
    assert core.spec_steps > 0 and core.spec_proposed == jcore.spec_proposed
    assert replayed == core.steps


# --------------------------------------------------------------- lookahead
LOOKAHEAD = dict(BASE, prefill_token_budget=32, unified_token_dispatch=True,
                 lookahead_dispatch=True, decode_steps=4, interactive_decode_steps=3)


@pytest.fixture(scope="module", params=[None, "int8"], ids=["f32", "int8"])
def lookahead_ref(request, dense):
    """(cache dtype, JAX's streams, JAX's lookahead burst count) of the
    lookahead workload, computed once per cache dtype.  The JAX side's
    compiles are nearly all of its cost (~10 s cold on a CPU against the port's
    ~0.5 s serve), and under a loaded parallel run they pushed the test's
    call past the per-test guard."""
    cfg = dict(LOOKAHEAD, cache_dtype=request.param)
    jcore = _jax_core(dense, **cfg)
    ref = _serve(jcore, True, _specs(seeded=True), stagger=2)
    jcore.close()
    return request.param, ref, jcore.metrics()["lookahead_bursts_total"]


def test_lookahead_bursts_at_tp2_match_jax(world, dense, lookahead_ref):
    """Fused unified bursts broadcast to the follower, turn 0's tokens
    broadcast back into the later turns; a seeded row rides along.  The
    int8 cache's bursts write each rank's own scale tiles."""
    cache_dtype, ref, jax_bursts = lookahead_ref
    cfg = dict(LOOKAHEAD, cache_dtype=cache_dtype)
    model = _sharded(world, dense)
    core = _port_core(model, **cfg)
    out, replayed = _replayed(world, model,
                              lambda: _serve(core, False, _specs(seeded=True), stagger=2))
    core.close()
    assert out == ref
    m = core.metrics()
    assert m["lookahead_bursts_total"] > 0
    assert m["lookahead_bursts_total"] == jax_bursts
    assert replayed == core.steps


# ------------------------------------------------------- another cache dtype
@pytest.mark.parametrize("layout", ["one", "tp2"])
def test_restart_with_different_generation_is_cold(world, dense, tmp_path, layout):
    """A persist directory survives, but a bf16 cache over the f32 model is
    another generation: the restart finds nothing resident, and it serves
    with JAX's streams for the same bf16 cache."""
    model = _sharded(world, dense) if layout == "tp2" else _one_rank(dense)
    prompt = np.random.RandomState(11).randint(3, 250, size=24)
    _fill_and_close(_port_core(model, **TIERS, kv_persist_dir=str(tmp_path)), prompt)
    core = _port_core(model, **TIERS, kv_persist_dir=str(tmp_path), cache_dtype="bfloat16")
    assert core.persist_store.resident_hashes() == []
    assert str(core.cache.dtype) == "torch.bfloat16"
    got = _serve(core, False, _specs(seeded=False), stagger=0)
    core.close()
    jcore = _jax_core(dense, mesh=layout == "tp2", **TIERS, cache_dtype="bfloat16")
    ref = _serve(jcore, True, _specs(seeded=False), stagger=0)
    jcore.close()
    assert got == ref


# -------------------------------------------------------------- perf model
def test_perf_model_prices_the_whole_model_at_tp2(world, dense):
    """Rank 0 of a tp = 2 engine predicts the one-rank engine's flops and
    bytes for a prefill and a decode dispatch: every term is the whole
    model's."""
    preds = []
    for model in (_sharded(world, dense), _one_rank(dense)):
        core = _port_core(model, **BASE, decode_steps=2)
        _collect(core, False, list(range(3, 30)), 4, "perf")
        preds.append({kind: core.perf_model.predicted(kind) for kind in ("step", "decode_multi")})
        core.close()
    tp2, one = preds
    for kind in ("step", "decode_multi"):
        for key in ("flops", "bytes"):
            assert tp2[kind][key] == pytest.approx(one[kind][key], rel=1e-6), (kind, key)


# ------------------------------------------------------------------- run
def test_run_tp2_with_a_draft_and_the_host_tier(ckpt, tmp_path):
    """``run --tp 2 --spec-tokens 2 --spec-draft-model`` (the checkpoint as
    its own draft, loaded whole on rank 0 beside the sharded target) with
    the host tier starts its follower, answers the batch and exits 0.  The
    batch samples at temperature 1 without a seed, so its texts are not
    compared: speculation keeps each token's distribution, not the draws."""
    from tests.test_torch_mesh import _batch_run, _run_cli

    batch = tmp_path / "b.jsonl"
    batch.write_text('{"text": "hello world w1 w2"}\n{"text": "w3 w4 w5"}\n')
    base, answers = _batch_run(ckpt, batch)
    r = _run_cli(base + ["--tp", "2", "--spec-tokens", "2", "--spec-draft-model", str(ckpt),
                         "--num-host-blocks", "16"], cwd=Path(__file__).resolve().parent.parent)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "1 followers started here" in r.stderr
    assert r.stderr.count(f"loaded {ckpt} ") == 2, r.stderr[-3000:]  # the target and the draft
    texts = answers()
    assert len(texts) == 2 and all(texts)
