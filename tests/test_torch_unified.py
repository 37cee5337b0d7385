"""The port's token-budget engine paths against the JAX EngineCore.

Both engines serve the same tiny f32 model (the JAX package's random init of
``ModelConfig.tiny()``, carried into the port by ``params_from_jax``) under
the same EngineConfig on the CPU, following ``tests/test_ragged_prefill.py``
and ``tests/test_lookahead_dispatch.py``: ``prefill_token_budget=64`` with
16-token chunks, then with ``unified_token_dispatch``, then with
``lookahead_dispatch`` and ``decode_steps=8``.  Greedy token streams, finish
reasons and prefix-cache hit lengths must be identical, and so must the
engine counters ``metrics()`` reports (dispatches, mixed turns, bursts,
device reads, ...): requests arriving while others decode, frequency and
presence penalties, a prefix join, and a mid-batch abort of a prefill row.
"""

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.request import EngineRequest as JaxEngineRequest
from dynamo_tpu.llm import protocols as jax_protocols
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import LlamaModel as JaxLlamaModel
from dynamo_tpu_torch.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine.request import EngineRequest
from dynamo_tpu_torch.llm import protocols
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.llama import LlamaModel

EOS = 2
BASE = dict(max_batch_size=8, max_model_len=256, block_size=8, num_blocks=128,
            prefill_buckets=[16, 32, 64, 128, 256])
CONFIGS = {
    "budget": dict(prefill_chunk_tokens=16, prefill_token_budget=64),
    "unified": dict(prefill_chunk_tokens=16, prefill_token_budget=64,
                    unified_token_dispatch=True),
    "lookahead": dict(prefill_chunk_tokens=16, prefill_token_budget=64,
                      lookahead_dispatch=True, decode_steps=8),
}
# every counter metrics() reports, both engines; host_gap_ms_per_turn is a
# wall-clock reading and measures a different span in each engine
COUNTERS = ("prefill_dispatches_total", "prefill_batch_occupancy", "prefill_budget_utilization",
            "unified_dispatches_total", "unified_decode_rows", "unified_prefill_tokens",
            "unified_budget_utilization", "lookahead_bursts_total", "lookahead_hits_total",
            "lookahead_mispredicts_total", "lookahead_commits_total", "lookahead_flushes_total",
            "lookahead_dispatch_depth", "device_gets_total", "tokens_generated",
            "kv_active_blocks", "request_active_slots")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes need no intra-op pool, and the suite's other workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxLlamaModel(JaxModelConfig.tiny())
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = ModelConfig.tiny()
    tree = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, LlamaModel.from_state(cfg, params_from_jax(tree, cfg, device="cpu"))


def _prompt(rng, n):
    return [int(x) for x in rng.randint(3, 250, size=n)]


def _run(core, request_cls, proto, specs, head, stagger, abort=None):
    """Submit the first ``head`` requests, step ``stagger`` times so they
    reach decode, submit the rest, optionally abort one after the next step,
    and step until idle.  Returns {id: (tokens, finish reason, cached
    tokens of each output)}."""
    outs = {rid: [] for rid, *_ in specs}
    reqs = [request_cls(request_id=rid, prompt=list(prompt),
                        sampling=proto.SamplingOptions(**sampling),
                        stops=proto.StopConditions(max_tokens=max_tokens),
                        emit=outs[rid].append)
            for rid, prompt, sampling, max_tokens in specs]
    for r in reqs[:head]:
        core.submit(r)
    for _ in range(stagger):
        core.step()
    for r in reqs[head:]:
        core.submit(r)
    if abort is not None:
        core.step()
        core.abort(abort)
    for _ in range(1000):
        if not core.step():
            break
    return {rid: ([t for o in v for t in o.token_ids], v[-1].finish_reason.value,
                  [o.cached_tokens for o in v]) for rid, v in outs.items()}


def _jax_run(models, specs, head, stagger, abort=None, **cfg_kw):
    """One JAX engine run: its streams, its metrics() and the prompt tokens
    it computed."""
    jmodel, jparams, _ = models
    jcore = JaxEngineCore(jmodel, jparams, JaxEngineConfig(**{**BASE, **cfg_kw}), eos_token_ids=[EOS])
    ref = _run(jcore, JaxEngineRequest, jax_protocols, specs, head, stagger, abort)
    return ref, jcore.metrics(), jcore.prompt_tokens_computed


def _both(models, jax_refs, case):
    """The JAX reference of ``case`` (made in set-up) and the port's run of
    the same case: (reference, port streams, JAX metrics, JAX prompt
    tokens computed, the port's core)."""
    specs, head, stagger, abort, cfg_kw = RUNS[case]
    ref, jmetrics, jtokens = jax_refs[case]
    core = EngineCore(models[2], EngineConfig(**{**BASE, **cfg_kw}), eos_token_ids=[EOS], device="cpu")
    out = _run(core, EngineRequest, protocols, specs(), head, stagger, abort)
    return ref, out, jmetrics, jtokens, core


def _assert_counters_match(jmetrics, core):
    pm = core.metrics()
    assert {k: pm[k] for k in COUNTERS} == {k: jmetrics[k] for k in COUNTERS}


def _mixed_specs():
    """A long prompt that stays mid-chunk across turns, a penalised request,
    a logprobs request and plain greedy ones, all greedy."""
    rng = np.random.RandomState(42)
    return [
        ("long", _prompt(rng, 44), dict(temperature=0.0), 5),
        ("pen", _prompt(rng, 12), dict(temperature=0.0, frequency_penalty=0.7,
                                       presence_penalty=0.3), 11),
        ("lp", _prompt(rng, 10), dict(temperature=0.0, logprobs=True, top_logprobs=3), 6),
        ("plain", _prompt(rng, 9), dict(temperature=0.0), 7),
        ("mid", _prompt(rng, 30), dict(temperature=0.0), 12),
    ]


def _prefix_specs():
    rng = np.random.RandomState(3)
    prompt = _prompt(rng, 41)
    return [("deco", _prompt(rng, 8), dict(temperature=0.0), 20),
            ("a", prompt, dict(temperature=0.0), 4),
            ("b", prompt, dict(temperature=0.0), 4)]


def _abort_specs():
    rng = np.random.RandomState(4)
    return [("deco", _prompt(rng, 8), dict(temperature=0.0), 40),
            ("victim", _prompt(rng, 48), dict(temperature=0.0), 4),
            ("other", _prompt(rng, 12), dict(temperature=0.0), 4)]


# every engine run of the module: (specs, head, stagger, abort, EngineConfig
# options) by (test, config)
RUNS = {
    **{("greedy", c): (_mixed_specs, 2, 4, None, CONFIGS[c]) for c in CONFIGS},
    **{("prefix_join", c): (_prefix_specs, 1, 3, None, CONFIGS[c]) for c in ("budget", "unified")},
    **{("abort", c): (_abort_specs, 1, 3, "victim", dict(CONFIGS[c], prefill_token_budget=32))
       for c in ("unified", "lookahead")},
}


@pytest.fixture(scope="module")
def jax_refs(models):
    """The JAX engine's run of every case, made once in the module's
    set-up.  Compiling the JAX engine's step functions is most of this
    file's time; a test's own time is then the port's run and the
    comparison."""
    return {case: _jax_run(models, specs(), head, stagger, abort, **cfg_kw)
            for case, (specs, head, stagger, abort, cfg_kw) in RUNS.items()}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_greedy_streams_and_counters_match_jax(models, jax_refs, config):
    kw = CONFIGS[config]
    ref, out, jmetrics, _, core = _both(models, jax_refs, ("greedy", config))
    assert out == ref
    assert all(reason == "length" for _, reason, _ in out.values())
    _assert_counters_match(jmetrics, core)
    m = core.metrics()
    assert m["prefill_batch_occupancy"] > 1.0  # several prompts packed per dispatch
    if kw.get("unified_token_dispatch") or kw.get("lookahead_dispatch"):
        assert m["unified_dispatches_total"] > 0 and m["unified_decode_rows"] > 0
    if kw.get("lookahead_dispatch"):
        assert m["lookahead_bursts_total"] > 0
        assert m["lookahead_commits_total"] + m["lookahead_flushes_total"] > 0


@pytest.mark.parametrize("config", ["budget", "unified"])
def test_prefix_join_matches_jax(models, jax_refs, config):
    """Identical prompts submitted while another request decodes: the second
    joins the first's in-flight blocks instead of packing duplicate compute
    into the dispatch."""
    ref, out, jmetrics, jtokens, core = _both(models, jax_refs, ("prefix_join", config))
    assert out == ref
    assert out["a"][0] == out["b"][0]
    assert out["b"][2][0] == 40  # five 8-token blocks came from the joined owner
    assert core.prompt_tokens_computed == jtokens == 8 + 41 + 1
    _assert_counters_match(jmetrics, core)


@pytest.mark.parametrize("config", ["unified", "lookahead"])
def test_mid_batch_abort_of_prefill_row_matches_jax(models, jax_refs, config):
    """A prefill row aborted while mid-chunk finishes CANCELLED; the decoding
    request and the other prompt stream on as in the JAX engine."""
    ref, out, jmetrics, _, core = _both(models, jax_refs, ("abort", config))
    assert out == ref
    assert out["victim"][1] == "cancelled"
    assert core.metrics()["unified_dispatches_total"] > 0
    _assert_counters_match(jmetrics, core)


def test_engine_accepts_the_token_budget_options(models):
    _, _, model = models
    core = EngineCore(model, EngineConfig(**BASE, lookahead_dispatch=True), device="cpu")
    # the JAX config's normalisation: lookahead implies unified dispatch,
    # which defaults the budget
    assert core.config.unified_token_dispatch and core.config.prefill_token_budget == 256
    assert core._unified_enabled() and core._lookahead_enabled()
