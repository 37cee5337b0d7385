"""Constrained decoding and per-request seeds through the port's EngineCore.

* Parity: the JAX package's ``mixed_specs`` (``tests/test_unified_dispatch.
  py``: two seeded rows at temperature > 0, a JSON-mode row, a penalised
  row and a plain greedy one, half of them arriving while the others
  decode) on the same tiny f32 model (the JAX random init carried over by
  ``params_from_jax``) and the same byte vocabulary: token streams, finish
  reasons, cached-prefix counts and engine counters identical to the JAX
  EngineCore's, logprobs within 1e-4, on the default path (chunked
  prefill), the token-budget path, unified dispatch and lookahead bursts.
  The JAX runs are made once, in the module's set-up.
* The cases of ``tests/test_grammar_engine.py`` (all but the tensor-
  parallel one, which needs a mesh): JSON mode emits JSON or a prefix the
  host tables accept, guided choice and guided regex, mixed grammars in one
  burst, refusals without tables or a usable EOS, the state budget's
  backpressure, a bad pattern failing only its request, and the schema
  regex falling back to JSON mode.
* ``tests/test_sampling_extras.py``'s seeded case: the same seeded request
  gives the same stream whatever the burst length, companions and engine
  seed.
* A constrained, seeded burst reads the device as often as an
  unconstrained one: the grammar state and the seed steps advance on the
  device.
"""

import json
import re

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.grammar import JsonGrammar as JaxJsonGrammar
from dynamo_tpu.engine.request import EngineRequest as JaxEngineRequest
from dynamo_tpu.llm import protocols as jax_protocols
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import LlamaModel as JaxLlamaModel
from dynamo_tpu_torch.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine import grammar as tg
from dynamo_tpu_torch.engine.grammar import INIT_STATE, JsonGrammar
from dynamo_tpu_torch.engine.request import EngineRequest
from dynamo_tpu_torch.llm import protocols
from dynamo_tpu_torch.llm.protocols import FinishReason, SamplingOptions, StopConditions
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.llama import LlamaModel

EOS = 2
LP_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes need no intra-op pool, and the suite's other workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(**kw):
    """(JAX model, JAX params, port model) of one f32 config."""
    kw = dict(intermediate_size=2 * kw["hidden_size"], num_layers=2, max_position_embeddings=256,
              rope_theta=10000.0, dtype="float32", **kw)
    jmodel = JaxLlamaModel(JaxModelConfig(**kw))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = ModelConfig(**kw)
    tree = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, LlamaModel.from_state(cfg, params_from_jax(tree, cfg, device="cpu"))


def _byte_vocab(v, extra=None):
    """ids 3..258 are the single bytes, ``extra`` maps further ids to
    multi-byte tokens, the rest (EOS included) are None."""
    toks: list = [None] * v
    for b in range(256):
        toks[3 + b] = bytes([b])
    for i, t in (extra or {}).items():
        toks[i] = t
    return toks


def _decode(toks, ids) -> bytes:
    return b"".join(toks[i] for i in ids if i != EOS and toks[i])


def _replays(tables, ids) -> bool:
    """Every token up to EOS is valid where it was sampled."""
    s, d, st = INIT_STATE, 0, 0
    for t in ids:
        if t == EOS:
            break
        if not tables.valid_mask(s, d, st)[t]:
            return False
        s, d, st = tables.advance(s, d, st, t)
    return True


# ------------------------------------------------------ parity with JAX
BASE = dict(max_batch_size=8, max_model_len=256, block_size=8, num_blocks=128,
            prefill_buckets=[16, 32, 64, 128, 256])
PATHS = {
    "default": dict(prefill_chunk_tokens=16),
    "budget": dict(prefill_chunk_tokens=16, prefill_token_budget=64),
    "unified": dict(prefill_chunk_tokens=16, prefill_token_budget=64,
                    unified_token_dispatch=True),
    "lookahead": dict(prefill_chunk_tokens=16, prefill_token_budget=64,
                      lookahead_dispatch=True, decode_steps=8),
}
COUNTERS = ("prefill_dispatches_total", "prefill_batch_occupancy", "unified_dispatches_total",
            "unified_decode_rows", "unified_prefill_tokens", "lookahead_bursts_total",
            "lookahead_hits_total", "lookahead_mispredicts_total", "lookahead_commits_total",
            "lookahead_flushes_total", "device_gets_total", "tokens_generated",
            "kv_active_blocks", "request_active_slots")


def mixed_specs():
    """``tests/test_unified_dispatch.py::mixed_specs``: (id, prompt,
    sampling options, max_tokens)."""
    rng = np.random.RandomState(42)
    p = lambda n: [int(x) for x in rng.randint(3, 259, size=n)]  # noqa: E731
    return [
        ("long", p(44), dict(temperature=1.0, seed=7), 5),
        ("json", p(8), dict(temperature=0.0, json_mode=True), 8),
        ("lp", p(10), dict(temperature=0.9, seed=123, logprobs=True, top_logprobs=3), 5),
        ("pen", p(12), dict(temperature=0.0, frequency_penalty=0.7, presence_penalty=0.3), 5),
        ("plain", p(9), dict(temperature=0.0), 5),
    ]


def _run(core, request_cls, proto, specs, head=2, stagger=4, ignore_eos=False):
    outs = {rid: [] for rid, *_ in specs}
    reqs = [request_cls(request_id=rid, prompt=list(prompt),
                        sampling=proto.SamplingOptions(**sampling),
                        stops=proto.StopConditions(max_tokens=n, ignore_eos=ignore_eos),
                        emit=outs[rid].append)
            for rid, prompt, sampling, n in specs]
    for r in reqs[:head]:
        core.submit(r)
    for _ in range(stagger):
        core.step()
    for r in reqs[head:]:
        core.submit(r)
    for _ in range(3000):
        if not core.step():
            break
    return outs


def _streams(outs):
    return {rid: ([t for o in v for t in o.token_ids], v[-1].finish_reason.value,
                  [o.cached_tokens for o in v]) for rid, v in outs.items()}


def _logprobs(outs):
    return {rid: [lp for o in v for lp in (o.logprobs or [])] for rid, v in outs.items()}


@pytest.fixture(scope="module")
def mixed_models():
    return _models(vocab_size=320, hidden_size=32, num_heads=2, num_kv_heads=2)


@pytest.fixture(scope="module")
def jax_mixed(mixed_models):
    """The JAX engine's run of ``mixed_specs`` on every path: (streams,
    logprobs, metrics()), made once."""
    jmodel, jparams, _ = mixed_models
    toks = _byte_vocab(320)
    refs = {}
    for path, kw in PATHS.items():
        core = JaxEngineCore(jmodel, jparams, JaxEngineConfig(**BASE, **kw), eos_token_ids=[EOS],
                             grammar=JaxJsonGrammar.from_token_bytes(toks, eos_ids=[EOS]))
        outs = _run(core, JaxEngineRequest, jax_protocols, mixed_specs())
        refs[path] = (_streams(outs), _logprobs(outs), core.metrics())
    return refs


@pytest.mark.parametrize("path", sorted(PATHS))
def test_mixed_specs_match_jax(mixed_models, jax_mixed, path):
    ref, ref_lp, jmetrics = jax_mixed[path]
    core = EngineCore(mixed_models[2], EngineConfig(**BASE, **PATHS[path]), eos_token_ids=[EOS],
                      device="cpu", grammar=JsonGrammar.from_token_bytes(_byte_vocab(320),
                                                                         eos_ids=[EOS]))
    outs = _run(core, EngineRequest, protocols, mixed_specs())
    assert _streams(outs) == ref
    got_lp = _logprobs(outs)
    assert len(got_lp["lp"]) == len(ref_lp["lp"]) == 5
    np.testing.assert_allclose(got_lp["lp"], ref_lp["lp"], atol=LP_ATOL)
    pm = core.metrics()
    assert {k: pm[k] for k in COUNTERS} == {k: jmetrics[k] for k in COUNTERS}
    if path in ("unified", "lookahead"):
        assert pm["unified_dispatches_total"] > 0 and pm["unified_decode_rows"] > 0
    if path == "lookahead":
        assert pm["lookahead_bursts_total"] > 0


@pytest.mark.parametrize("path", ["default", "lookahead"])
def test_constrained_seeded_burst_reads_like_an_unconstrained_one(mixed_models, path):
    """The same schedule with and without grammar and seeds (EOS ignored,
    so every row runs to max_tokens): as many device reads and turns."""
    kw = dict(PATHS[path], decode_steps=8)
    plain = [(rid, p, dict(temperature=1.0 if s.get("seed") else 0.0), n)
             for rid, p, s, n in mixed_specs()]
    runs = {}
    for name, specs in (("constrained", mixed_specs()), ("plain", plain)):
        core = EngineCore(mixed_models[2], EngineConfig(**BASE, **kw), eos_token_ids=[EOS],
                          device="cpu", grammar=JsonGrammar.from_token_bytes(
                              _byte_vocab(320), eos_ids=[EOS]))
        specs = [(rid, p, s, 24) for rid, p, s, _ in specs]
        _run(core, EngineRequest, protocols, specs, ignore_eos=True)
        runs[name] = (core.device_gets, core.steps, core.tokens_generated)
    assert runs["constrained"] == runs["plain"]
    assert runs["plain"][2] == 5 * 24


# ------------------------------------- tests/test_grammar_engine.py cases
GCFG = dict(max_batch_size=2, max_model_len=128, block_size=8, num_blocks=64,
            prefill_buckets=[16, 32, 64, 128])


@pytest.fixture(scope="module")
def gsetup():
    """The JAX grammar-engine tests' model and vocabulary: single bytes and
    a few multi-byte tokens."""
    _, _, model = _models(vocab_size=512, hidden_size=64, num_heads=4, num_kv_heads=2)
    toks = _byte_vocab(512, {300: b'{"', 301: b'":', 302: b'"}', 303: b'true', 304: b'[1,',
                             305: b'23'})
    return model, JsonGrammar.from_token_bytes(toks, eos_ids=[EOS]), toks


def _core(gsetup, grammar="default", **kw):
    model, g, _ = gsetup
    return EngineCore(model, EngineConfig(**{**GCFG, **kw}), eos_token_ids=[EOS], device="cpu",
                      grammar=g if grammar == "default" else grammar)


def _serve(core, specs, steps=600):
    """Submit (id, prompt, SamplingOptions, StopConditions) and step until
    idle; returns {id: (tokens, finish reason)}."""
    outs = {rid: [] for rid, *_ in specs}
    for rid, prompt, sampling, stops in specs:
        core.submit(EngineRequest(request_id=rid, prompt=prompt, sampling=sampling, stops=stops,
                                  emit=outs[rid].append))
    for _ in range(steps):
        if not core.step():
            break
    for rid, v in outs.items():
        assert v and v[-1].finish_reason is not None, rid
    return {rid: ([t for o in v for t in o.token_ids], v[-1].finish_reason)
            for rid, v in outs.items()}


def _assert_json(gsetup, ids, reason):
    _, g, toks = gsetup
    if reason is FinishReason.EOS:
        json.loads(_decode(toks, ids).decode("utf-8", errors="replace"))
    else:  # LENGTH: a valid JSON prefix, never malformed
        assert reason is FinishReason.LENGTH
        assert _replays(g.tables, ids)


@pytest.mark.parametrize("decode_steps", [1, 4])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_json_mode_emits_valid_json(gsetup, decode_steps, temperature):
    core = _core(gsetup, decode_steps=decode_steps)
    for trial in range(3):
        (ids, reason), = _serve(core, [(f"j{trial}", [5 + trial, 6, 7, 8],
                                        SamplingOptions(temperature=temperature, json_mode=True),
                                        StopConditions(max_tokens=48))]).values()
        _assert_json(gsetup, ids, reason)


def test_json_mode_with_penalties_and_topk(gsetup):
    """Grammar + penalties + top-k ride the same burst."""
    core = _core(gsetup, decode_steps=4)
    (ids, reason), = _serve(core, [("jp", [9, 10, 11], SamplingOptions(
        temperature=0.8, top_k=40, frequency_penalty=0.4, presence_penalty=0.2, json_mode=True),
        StopConditions(max_tokens=40))]).values()
    _assert_json(gsetup, ids, reason)


def test_json_mode_mixed_batch(gsetup):
    """A json_mode request and a free-running one in the same burst; only
    the constrained row is masked."""
    out = _serve(_core(gsetup, decode_steps=4), [
        ("json", [5, 6, 7], SamplingOptions(temperature=1.0, json_mode=True),
         StopConditions(max_tokens=32)),
        ("free", [8, 9, 10], SamplingOptions(temperature=1.0),
         StopConditions(max_tokens=32, ignore_eos=True))])
    _assert_json(gsetup, *out["json"])
    assert len(out["free"][0]) == 32


@pytest.mark.parametrize("grammar", ["none", "no-eos"])
def test_json_mode_refused_without_usable_tables(gsetup, grammar):
    """No tables, or tables compiled without an EOS id, cannot terminate
    JSON mode: the request finishes with ERROR, not garbled."""
    g = None if grammar == "none" else JsonGrammar.from_token_bytes(gsetup[2], eos_ids=[])
    out = _serve(_core(gsetup, grammar=g), [("j", [5, 6], SamplingOptions(json_mode=True),
                                            StopConditions(max_tokens=8))], steps=20)
    assert out["j"] == ([], FinishReason.ERROR)


def test_guided_choice_emits_a_choice(gsetup):
    core = _core(gsetup, decode_steps=4)
    choices = ["alpha", "beta", "true"]
    for trial, temp in enumerate([0.0, 1.0, 1.0]):
        (ids, reason), = _serve(core, [(f"gc{trial}", [5 + trial, 6, 7], SamplingOptions(
            temperature=temp, guided_choice=list(choices)), StopConditions(max_tokens=16))],
            steps=200).values()
        assert reason is FinishReason.EOS
        assert _decode(gsetup[2], ids).decode() in choices


def test_mixed_grammar_batch_json_and_choices(gsetup):
    """One burst with a JSON row, two different choice rows and a free row:
    each obeys its own grammar (composite tables, offset-mapped)."""
    toks = gsetup[2]
    out = _serve(_core(gsetup, max_batch_size=4, num_blocks=96, decode_steps=4), [
        ("json", [5, 6, 7], SamplingOptions(temperature=1.0, json_mode=True),
         StopConditions(max_tokens=24)),
        ("c1", [8, 9], SamplingOptions(temperature=1.0, guided_choice=["yes", "no"]),
         StopConditions(max_tokens=12)),
        ("c2", [10, 11], SamplingOptions(temperature=1.0, guided_choice=["left", "right", "up"]),
         StopConditions(max_tokens=12)),
        ("free", [12, 13], SamplingOptions(temperature=1.0),
         StopConditions(max_tokens=12, ignore_eos=True))])
    assert _decode(toks, out["c1"][0]).decode() in ("yes", "no")
    assert _decode(toks, out["c2"][0]).decode() in ("left", "right", "up")
    _assert_json(gsetup, *out["json"])
    assert len(out["free"][0]) == 12


def test_grammar_budget_backpressure(gsetup):
    """Requests whose combined grammar states would overflow the composite
    budget WAIT for slots instead of failing the engine step."""
    core = _core(gsetup, max_batch_size=4, num_blocks=96)
    core.GRAMMAR_STATE_BUDGET = 300  # each choice set is bounded at ~242 states
    big = ["x" * 120, "y" * 120]
    specs = [(rid, [5, 6], SamplingOptions(temperature=0.0, guided_choice=[c + rid for c in big]),
              StopConditions(max_tokens=200)) for rid in ("a", "b")]
    out = _serve(core, specs, steps=1500)
    for rid in ("a", "b"):
        assert out[rid][1] is FinishReason.EOS
        assert _decode(gsetup[2], out[rid][0]).decode() in [c + rid for c in big]


def test_guided_regex_through_engine(gsetup):
    core = _core(gsetup, decode_steps=4)
    pattern = r"(up|down) [0-9][0-9]?%"
    for trial in range(3):
        (ids, reason), = _serve(core, [(f"rx{trial}", [5 + trial, 6], SamplingOptions(
            temperature=1.0, guided_regex=pattern), StopConditions(max_tokens=24))],
            steps=300).values()
        assert reason is FinishReason.EOS
        assert re.fullmatch(pattern, _decode(gsetup[2], ids).decode())


def test_guided_regex_bad_pattern_errors_request_not_engine(gsetup, monkeypatch):
    """A pattern that blows the DFA cap ERROR-finishes that request; the
    engine keeps serving the others."""
    core = _core(gsetup)
    monkeypatch.setattr(tg, "MAX_REGEX_STATES", 3)
    out = _serve(core, [
        ("bad", [5, 6], SamplingOptions(guided_regex="abcdefgh"), StopConditions(max_tokens=8)),
        ("ok", [7, 8], SamplingOptions(temperature=0.0),
         StopConditions(max_tokens=4, ignore_eos=True))], steps=100)
    assert out["bad"][1] is FinishReason.ERROR
    assert len(out["ok"][0]) == 4


def test_schema_regex_falls_back_to_json_mode(gsetup, monkeypatch):
    """A schema regex whose DFA exceeds the cap degrades to the generic
    JSON grammar instead of failing the request."""
    core = _core(gsetup)
    monkeypatch.setattr(tg, "MAX_REGEX_STATES", 3)
    (ids, reason), = _serve(core, [("sf", [5, 6, 7], SamplingOptions(
        temperature=1.0, json_mode=True, guided_regex="abcdefgh"),
        StopConditions(max_tokens=24))], steps=300).values()
    assert reason in (FinishReason.EOS, FinishReason.LENGTH)
    assert _replays(gsetup[1].tables, ids)


# --------------------------------- tests/test_sampling_extras.py seeded case
def test_seeded_sampling_is_deterministic_across_batches(mixed_models):
    """OpenAI ``seed``: the same seeded request gives the same tokens
    whatever the burst length, the companions (one of them widening the
    candidate set) and the engine seed; another seed diverges; with top_p
    below 1 the seeded row's fixed K_MAX window keeps it so."""
    model = mixed_models[2]

    def run(seed, decode_steps, companions, engine_seed, top_p=1.0):
        core = EngineCore(model, EngineConfig(max_batch_size=4, max_model_len=96, block_size=16,
                                              num_blocks=48, decode_steps=decode_steps,
                                              seed=engine_seed), device="cpu")
        specs = [("seeded", [5, 6, 7, 8], SamplingOptions(temperature=0.9, seed=seed,
                                                          top_p=top_p),
                  StopConditions(max_tokens=14, ignore_eos=True))]
        specs += [(f"c{j}", [20 + j, 21, 22], SamplingOptions(
            temperature=1.0, top_k=100 if j == 0 else 0),
            StopConditions(max_tokens=10, ignore_eos=True)) for j in range(companions)]
        return _serve(core, specs, steps=200)["seeded"][0]

    a = run(seed=1234, decode_steps=4, companions=0, engine_seed=0)
    assert len(a) == 14
    assert run(seed=1234, decode_steps=1, companions=2, engine_seed=99) == a
    assert run(seed=4321, decode_steps=4, companions=0, engine_seed=0) != a
    d = run(seed=1234, decode_steps=4, companions=0, engine_seed=0, top_p=0.9)
    assert run(seed=1234, decode_steps=1, companions=2, engine_seed=7, top_p=0.9) == d
