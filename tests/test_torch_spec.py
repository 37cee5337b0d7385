"""Speculative decoding in the port's EngineCore against the JAX EngineCore.

Both engines serve the same tiny f32 models (the JAX package's random init,
carried over by ``params_from_jax``) on the CPU, with the same EngineConfig:

* ``propose_ngram`` returns the JAX proposer's lists, on seeded random and
  periodic sequences;
* the counterparts of ``tests/test_spec_decode.py``: a deterministic cycle
  model accepts (its counters equal the JAX engine's), greedy streams with
  speculation on equal speculation off and the JAX engine's at k = 2, 4
  and 7 on the default, chunked, unified, lookahead and int8 paths (spec
  counters equal too), sampler features that defer to the burst,
  temperature acceptance, seeded streams equal with speculation on and off
  and to the JAX engine's, block limits, the proposal-coverage gate, and the
  draft-model proposer (identical and other-weight drafts, proposals and
  dispatches equal to the JAX ``DraftProposer``'s, blocks released, vocab
  refusal, all-or-nothing growth, a long prompt's catch-up, int8 caches);
* beyond that file: a tiny DeepSeek-V2 with speculation on, a prefix hit on
  a speculated request's prompt and output, and one device read per verify
  turn (and one per draft dispatch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine.draft import DraftProposer as JaxDraftProposer
from dynamo_tpu.engine.request import EngineRequest as JaxEngineRequest
from dynamo_tpu.engine.spec import propose_ngram as jax_propose_ngram
from dynamo_tpu.llm import protocols as jax_protocols
from dynamo_tpu.models import deepseek as jds
from dynamo_tpu.models import quant as jax_quant
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import LlamaModel as JaxLlamaModel
from dynamo_tpu_torch.engine import EngineConfig, EngineCore
from dynamo_tpu_torch.engine import spec as spec_mod
from dynamo_tpu_torch.engine.draft import DraftProposer
from dynamo_tpu_torch.engine.grammar import JsonGrammar
from dynamo_tpu_torch.engine.request import EngineRequest
from dynamo_tpu_torch.engine.sampling import K_MAX
from dynamo_tpu_torch.engine.spec import propose_ngram
from dynamo_tpu_torch.llm import protocols
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.llama import LlamaModel
from dynamo_tpu_torch.ops.kv_quant import is_quant
from tests.test_spec_decode import CYCLE
from tests.test_spec_decode import CycleModel as JaxCycleModel
from tests.test_torch_deepseek import _configs as deepseek_configs
from tests.test_torch_deepseek import _perturbed_tree, _port
from tests.test_torch_grammar_engine import _byte_vocab

SPEC_COUNTERS = ("spec_steps", "spec_proposed", "spec_accepted")
COUNTERS = SPEC_COUNTERS + (
    "prefill_dispatches_total", "unified_dispatches_total", "lookahead_bursts_total",
    "device_gets_total", "tokens_generated", "kv_active_blocks")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes need no intra-op pool, and the suite's other workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- proposer ----
def _sequences():
    rng = np.random.default_rng(0)
    out = [rng.integers(0, 6, n).tolist() for n in (0, 1, 2, 5, 17, 64, 300)]
    out += [(list(rng.integers(0, 50, p)) * 12)[:n] for p, n in ((1, 9), (3, 20), (7, 50),
                                                                 (16, 100))]
    out += [[1, 2, 3, 9, 1, 2, 3], [7, 7, 7, 7, 7], [5, 6, 1, 5, 6, 2, 5, 6]]
    return out


@pytest.mark.parametrize("ngram,k,min_ngram", [(3, 4, 1), (2, 2, 1), (3, 7, 2), (1, 1, 1),
                                               (4, 3, 3), (3, 0, 1)])
def test_propose_ngram_matches_jax(ngram, k, min_ngram):
    for toks in _sequences():
        toks = [int(t) for t in toks]
        assert propose_ngram(toks, ngram, k, min_ngram) == \
            jax_propose_ngram(toks, ngram, k, min_ngram), toks


# ------------------------------------------------- deterministic cycle model
class CycleModel:
    """The port's counterpart of ``tests/test_spec_decode.py::CycleModel``:
    argmax at position p is CYCLE[(p + 1) % len(CYCLE)] whatever the input,
    so n-gram proposals become perfect after one cycle."""

    def __init__(self, vocab=64, scale=1.0):
        self.config = ModelConfig.tiny(vocab_size=vocab)
        self.scale = scale
        self.device = torch.device("cpu")

    def init_kv_cache(self, num_blocks, block_size, dtype=None):
        cfg = self.config
        return torch.zeros((cfg.num_layers, num_blocks, 2, block_size,
                            cfg.num_kv_heads * cfg.head_dim))

    def forward(self, tokens, positions, cache, block_tables, seq_lens, slot_idx,
                prefix_blocks=None, **_):
        b, s = tokens.shape
        hidden = torch.zeros((b, s, self.config.hidden_size))
        hidden[:, :, 0] = positions.float()
        return hidden, cache

    def compute_logits(self, hidden):
        pos = hidden[..., 0].long()
        nxt = torch.tensor(CYCLE)[(pos + 1) % len(CYCLE)]
        return F.one_hot(nxt, self.config.vocab_size).float() * self.scale


def _cfg(**kw):
    return dict(max_batch_size=2, max_model_len=256, block_size=16, num_blocks=40, **kw)


def _drain(core, request_cls, proto, prompt, n, rid="s", steps=600, **samp):
    outs = []
    core.submit(request_cls(
        request_id=rid, prompt=list(prompt), sampling=proto.SamplingOptions(**samp),
        stops=proto.StopConditions(max_tokens=n, ignore_eos=True), emit=outs.append))
    for _ in range(steps):
        if not core.step():
            break
    return [t for o in outs for t in o.token_ids], outs


def _port_run(model, cfg, prompt, n, draft=None, **samp):
    core = EngineCore(model, EngineConfig(**cfg), eos_token_ids=[], device="cpu", draft=draft)
    toks, _ = _drain(core, EngineRequest, protocols, prompt, n, **samp)
    return toks, core


def _jax_run(model, params, cfg, prompt, n, draft=None, **samp):
    core = JaxEngineCore(model, params, JaxEngineConfig(**cfg), eos_token_ids=[], draft=draft)
    try:
        toks, _ = _drain(core, JaxEngineRequest, jax_protocols, prompt, n, **samp)
    finally:
        core.close()
    return toks, core


def _counters(core, keys=SPEC_COUNTERS):
    m = core.metrics()
    return {k: m[k] for k in keys}


CYCLE_PROMPT = [11, 12, 13, 14, 11, 12, 13, 14]


def test_spec_accepts_on_cyclic_model():
    base, bcore = _port_run(CycleModel(), _cfg(), CYCLE_PROMPT, 24, temperature=0.0)
    got, core = _port_run(CycleModel(), _cfg(spec_tokens=4), CYCLE_PROMPT, 24, temperature=0.0)
    jmodel = JaxCycleModel()
    ref, jcore = _jax_run(jmodel, jmodel.init_params(), _cfg(spec_tokens=4), CYCLE_PROMPT, 24,
                          temperature=0.0)
    assert got == base == ref
    assert core.spec_steps > 0 and core.spec_accepted > 0
    assert core.decode_steps < bcore.decode_steps / 2
    assert core.spec_accepted / max(core.spec_proposed, 1) > 0.9
    assert _counters(core, SPEC_COUNTERS + ("device_gets_total",)) == \
        _counters(jcore, SPEC_COUNTERS + ("device_gets_total",))
    assert core.decode_steps == jcore.decode_steps


# ----------------------------------------------- tiny real model, all paths
BASE = dict(max_batch_size=4, max_model_len=128, block_size=8, num_blocks=64,
            prefill_buckets=[16, 32, 64, 128])
PATHS = {
    "default": dict(decode_steps=4),
    "chunked": dict(decode_steps=4, prefill_chunk_tokens=16),
    "unified": dict(decode_steps=4, prefill_chunk_tokens=16, prefill_token_budget=64,
                    unified_token_dispatch=True),
    "lookahead": dict(decode_steps=4, prefill_chunk_tokens=16, prefill_token_budget=64,
                      lookahead_dispatch=True),
    "int8": dict(decode_steps=4, cache_dtype="int8"),
}


def _tiny(quantized=False, seed=0, **kw):
    """(JAX model, JAX params, port model) of ``ModelConfig.tiny(**kw)`` in
    f32, or with int8 weights (``quantize_params`` of a perturbed tree)."""
    jmodel = JaxLlamaModel(JaxModelConfig.tiny(**kw))
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(seed)))
    if quantized:
        rng = np.random.default_rng(seed)
        tree = jax.tree.map(lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype),
                            tree)
        tree = jax.tree.map(np.asarray, jax_quant.quantize_params(tree))
    cfg = ModelConfig.tiny(**kw)
    return (jmodel, jax.tree.map(jnp.asarray, tree),
            LlamaModel.from_state(cfg, params_from_jax(tree, cfg, device="cpu")))


@pytest.fixture(scope="module")
def tiny():
    return _tiny()


@pytest.fixture(scope="module")
def tiny_q8():
    return _tiny(quantized=True)


def _specs():
    """(id, prompt, max_tokens): three prompts with repeats, so lookup
    proposes from the first turn, and one whose random tail proposes only
    once the output repeats."""
    rng = np.random.default_rng(3)
    seg = rng.integers(1, 250, 8).tolist()
    return [("rep", seg * 3 + [7], 14), ("other", rng.integers(1, 250, 5).tolist() * 4, 12),
            ("late", seg * 2 + rng.integers(1, 250, 30).tolist(), 10),
            ("short", seg[:5] * 2, 16)]


def _serve(core, request_cls, proto, specs, head=2, stagger=3, steps=2000):
    """Submit ``head`` requests, step ``stagger`` times, submit the rest
    (so later prompts arrive while others decode), then run to idle:
    {id: (tokens, finish reason, cached tokens per output)}."""
    outs = {rid: [] for rid, *_ in specs}
    reqs = [request_cls(request_id=rid, prompt=list(prompt),
                        sampling=proto.SamplingOptions(temperature=0.0),
                        stops=proto.StopConditions(max_tokens=n, ignore_eos=True),
                        emit=outs[rid].append) for rid, prompt, n in specs]
    for r in reqs[:head]:
        core.submit(r)
    for _ in range(stagger):
        core.step()
    for r in reqs[head:]:
        core.submit(r)
    for _ in range(steps):
        if not core.step():
            break
    return {rid: ([t for o in v for t in o.token_ids], v[-1].finish_reason.value,
                  [o.cached_tokens for o in v]) for rid, v in outs.items()}


@pytest.mark.parametrize("k", [2, 4, 7])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_greedy_streams_match_jax(tiny, tiny_q8, path, k):
    jmodel, jparams, model = tiny_q8 if path == "int8" else tiny
    kw = {**BASE, **PATHS[path]}
    jcore = JaxEngineCore(jmodel, jparams, JaxEngineConfig(**kw, spec_tokens=k), eos_token_ids=[])
    try:
        ref = _serve(jcore, JaxEngineRequest, jax_protocols, _specs())
    finally:
        jcore.close()
    core = EngineCore(model, EngineConfig(**kw, spec_tokens=k), eos_token_ids=[], device="cpu")
    out = _serve(core, EngineRequest, protocols, _specs())
    off = _serve(EngineCore(model, EngineConfig(**kw), eos_token_ids=[], device="cpu"),
                 EngineRequest, protocols, _specs())
    assert out == ref
    assert {rid: v[:2] for rid, v in out.items()} == {rid: v[:2] for rid, v in off.items()}
    assert _counters(core, COUNTERS) == _counters(jcore, COUNTERS)
    assert core.spec_steps > 0 and core.spec_accepted > 0
    if path in ("unified", "lookahead"):
        assert core.metrics()["unified_dispatches_total"] > 0


# ----------------------------------------------------- features that defer
DEFERRING = {
    "penalties": dict(temperature=1.0, frequency_penalty=0.5),
    "logprobs": dict(temperature=0.0, logprobs=True),
    "logit_bias": dict(temperature=0.0, logit_bias={20: 1.0}),
    "json_mode": dict(temperature=0.0, json_mode=True),
    "guided_choice": dict(temperature=0.0, guided_choice=["yes", "no"]),
    "guided_regex": dict(temperature=0.0, guided_regex="[0-9]+"),
    "top_k": dict(temperature=0.8, top_k=K_MAX + 1),
}


@pytest.mark.parametrize("feature", sorted(DEFERRING))
def test_spec_defers_to_sampler_features(feature):
    """A request using a feature the verify pass can't thread disables the
    speculative path for that dispatch — the burst runs instead — while the
    same request without it speculates."""
    vocab = 320
    grammar = JsonGrammar.from_token_bytes(_byte_vocab(vocab), eos_ids=[2])
    counts = []
    for samp in (DEFERRING[feature], dict(temperature=0.0)):
        core = EngineCore(CycleModel(vocab), EngineConfig(**_cfg(spec_tokens=4)),
                          eos_token_ids=[2], device="cpu", grammar=grammar)
        outs = []
        core.submit(EngineRequest(
            request_id="t", prompt=CYCLE_PROMPT, sampling=protocols.SamplingOptions(**samp),
            stops=protocols.StopConditions(max_tokens=8, ignore_eos=True), emit=outs.append))
        for _ in range(100):
            if not core.step():
                break
        assert outs[-1].finish_reason is not None
        assert outs[-1].finish_reason.value != "error"
        counts.append(core.spec_steps)
    assert counts[0] == 0 and counts[1] > 0


def test_spec_accepts_under_temperature():
    got, core = _port_run(CycleModel(scale=20.0), _cfg(spec_tokens=4), CYCLE_PROMPT, 16,
                          temperature=0.7)
    assert got == [CYCLE[(8 + j) % 4] for j in range(16)]
    assert core.spec_steps > 0 and core.spec_accepted > 0


@pytest.mark.parametrize("scale", [1.0, 25.0])
def test_spec_seeded_stream_identical(scale):
    """A seeded request's stream is identical with speculation on or off and
    to the JAX engine's (noise keyed by seed, position and token id), both
    when proposals are mostly rejected (scale 1) and mostly accepted (25)."""
    samp = dict(temperature=0.9, seed=1234)
    base, _ = _port_run(CycleModel(scale=scale), _cfg(), CYCLE_PROMPT, 24, **samp)
    got, core = _port_run(CycleModel(scale=scale), _cfg(spec_tokens=4), CYCLE_PROMPT, 24, **samp)
    jmodel = JaxCycleModel(scale=scale)
    ref, jcore = _jax_run(jmodel, jmodel.init_params(), _cfg(spec_tokens=4), CYCLE_PROMPT, 24,
                          **samp)
    assert len(base) == 24
    assert got == base == ref
    assert core.spec_steps > 0
    assert _counters(core) == _counters(jcore)


def test_spec_respects_block_limits():
    """Proposals are clamped to the sequence's block space; running out
    finishes at LENGTH exactly as the JAX engine does."""
    cfg = dict(max_batch_size=1, max_model_len=48, block_size=16, num_blocks=3, spec_tokens=4)
    prompt = [11, 12, 13, 14] * 3
    core = EngineCore(CycleModel(), EngineConfig(**cfg), eos_token_ids=[], device="cpu")
    got, outs = _drain(core, EngineRequest, protocols, prompt, 100, temperature=0.0)
    jmodel = JaxCycleModel()
    jcore = JaxEngineCore(jmodel, jmodel.init_params(), JaxEngineConfig(**cfg), eos_token_ids=[])
    ref, jouts = _drain(jcore, JaxEngineRequest, jax_protocols, prompt, 100, temperature=0.0)
    jcore.close()
    assert got == ref
    assert outs[-1].finish_reason.value == jouts[-1].finish_reason.value == "length"
    assert 12 + len(got) <= 48
    assert _counters(core) == _counters(jcore)


def test_spec_skips_batch_with_low_proposal_coverage(monkeypatch):
    """Speculation needs proposals on at least half the rows when bursts are
    configured.  (Proposals are stubbed: only prompts starting with the
    marker token propose.)"""
    mark = 11

    def stub(tokens, ngram, k, min_ngram=1):
        return [12, 13] if tokens and tokens[0] == mark else []

    monkeypatch.setattr(spec_mod, "propose_ngram", stub)

    def run(marked_rows):
        core = EngineCore(CycleModel(), EngineConfig(
            max_batch_size=4, max_model_len=256, block_size=16, num_blocks=64, decode_steps=8,
            spec_tokens=4), eos_token_ids=[], device="cpu")
        outs = {}
        for j in range(4):
            rid = f"r{j}"
            outs[rid] = []
            first = mark if j < marked_rows else 40 + 5 * j
            core.submit(EngineRequest(
                request_id=rid, prompt=[first, 31 + j, 32 + j],
                sampling=protocols.SamplingOptions(temperature=0.0),
                stops=protocols.StopConditions(max_tokens=12, ignore_eos=True),
                emit=outs[rid].append))
        for _ in range(300):
            if not core.step():
                break
        for rid, lst in outs.items():
            assert sum(len(o.token_ids) for o in lst) == 12, rid
        return core

    assert run(marked_rows=1).spec_steps == 0
    assert run(marked_rows=3).spec_steps > 0


# ------------------------------------------------------ draft-model spec ----
@pytest.fixture(scope="module")
def other_draft():
    """A draft of the tiny config with other random weights: (JAX params,
    port model)."""
    jmodel = JaxLlamaModel(JaxModelConfig.tiny())
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(99)))
    cfg = ModelConfig.tiny()
    return (jax.tree.map(jnp.asarray, tree),
            LlamaModel.from_state(cfg, params_from_jax(tree, cfg, device="cpu")))


def _recorded_proposals(core) -> list:
    """Every ``propose`` result of the engine's draft, in order."""
    calls = []
    real = core.draft.propose

    def propose(*args, **kw):
        out = real(*args, **kw)
        calls.append(out)
        return out

    core.draft.propose = propose
    return calls


def test_draft_model_identical_to_target_accepts_everything(tiny):
    _, _, model = tiny
    prompt = [5, 6, 7, 8, 9]
    base, bcore = _port_run(model, _cfg(), prompt, 24, temperature=0.0)
    got, core = _port_run(model, _cfg(spec_tokens=4), prompt, 24, draft=model, temperature=0.0)
    assert got == base
    assert core.draft is not None and core.draft.dispatches > 0
    assert core.spec_steps > 0
    assert core.spec_accepted / max(core.spec_proposed, 1) > 0.9
    assert core.decode_steps < bcore.decode_steps / 2


@pytest.mark.parametrize("samp", [dict(temperature=0.0), dict(temperature=0.8, seed=42)],
                         ids=["greedy", "seeded"])
def test_draft_model_different_weights_still_exact(tiny, other_draft, samp):
    jmodel, jparams, model = tiny
    jdraft, draft = other_draft
    prompt = [3, 1, 4, 1, 5]
    base, _ = _port_run(model, _cfg(), prompt, 16, **samp)
    core = EngineCore(model, EngineConfig(**_cfg(spec_tokens=3)), eos_token_ids=[], device="cpu",
                      draft=draft)
    props = _recorded_proposals(core)
    got, _ = _drain(core, EngineRequest, protocols, prompt, 16, **samp)
    jcore = JaxEngineCore(jmodel, jparams, JaxEngineConfig(**_cfg(spec_tokens=3)),
                          eos_token_ids=[], draft=(jmodel, jdraft))
    jprops = _recorded_proposals(jcore)
    try:
        ref, _ = _drain(jcore, JaxEngineRequest, jax_protocols, prompt, 16, **samp)
    finally:
        jcore.close()
    assert got == base == ref
    assert core.spec_steps > 0
    assert props == jprops
    assert core.draft.dispatches == jcore.draft.dispatches
    assert _counters(core) == _counters(jcore)


def test_draft_blocks_released_on_finish(tiny):
    _, _, model = tiny
    core = EngineCore(model, EngineConfig(**_cfg(spec_tokens=2)), eos_token_ids=[],
                      device="cpu", draft=model)
    free0 = len(core.draft._free)
    for j in range(6):
        out, _ = _drain(core, EngineRequest, protocols, [7 + j, 8, 9], 4, f"r{j}",
                        temperature=0.0)
        assert len(out) == 4
    assert core.draft.dispatches > 0
    assert len(core.draft._free) == free0
    assert core.draft._blocks == {}


def test_draft_refusals_match_jax(tiny):
    jmodel, jparams, model = tiny
    other = LlamaModel(ModelConfig.tiny(vocab_size=128), device="cpu")
    jother = JaxLlamaModel(JaxModelConfig.tiny(vocab_size=128))
    for port_draft, jax_draft, spec_tokens, match in (
            (other, (jother, jother.init_params(jax.random.PRNGKey(1))), 2,
             r"draft model must share the target's vocab \(128 != 256\)"),
            (model, (jmodel, jparams), 0, "a draft model requires spec_tokens > 0")):
        with pytest.raises(ValueError, match=match):
            JaxEngineCore(jmodel, jparams, JaxEngineConfig(**_cfg(spec_tokens=spec_tokens)),
                          eos_token_ids=[], draft=jax_draft)
        with pytest.raises(ValueError, match=match):
            EngineCore(model, EngineConfig(**_cfg(spec_tokens=spec_tokens)), eos_token_ids=[],
                       device="cpu", draft=port_draft)


def test_draft_grow_all_or_nothing():
    """A row that cannot FULLY grow takes nothing, in both packages."""
    cfg = dict(max_batch_size=2, max_model_len=256, block_size=16, num_blocks=4)
    jmodel = JaxCycleModel()
    for d in (DraftProposer(CycleModel(), EngineConfig(**cfg)),
              JaxDraftProposer(jmodel, jmodel.init_params(), JaxEngineConfig(**cfg))):
        assert d._grow(0, 16 * 3)        # 3 of 4 blocks
        assert not d._grow(1, 16 * 2)    # needs 2, only 1 free
        assert len(d._free) == 1         # nothing stranded
        assert d._blocks.get(1, []) == []


def test_draft_long_prompt_catches_up_across_steps():
    """A prompt longer than the ingest bucket catches up through one ingest
    dispatch per propose call, then drafts; the stream equals plain greedy
    decoding and the JAX engine's, with the same draft dispatches."""
    jmodel, jparams, model = _tiny(max_position_embeddings=2048)
    prompt = [(i * 17) % 200 + 1 for i in range(1100)]
    cfg = dict(max_batch_size=2, max_model_len=1536, block_size=16, num_blocks=128)
    base, _ = _port_run(model, cfg, prompt, 10, temperature=0.0)
    got, core = _port_run(model, dict(cfg, spec_tokens=3), prompt, 10, draft=model,
                          temperature=0.0)
    ref, jcore = _jax_run(jmodel, jparams, dict(cfg, spec_tokens=3), prompt, 10,
                          draft=(jmodel, jparams), temperature=0.0)
    assert got == base == ref
    assert core.spec_steps > 0
    assert core.draft.dispatches == jcore.draft.dispatches > 3
    assert _counters(core) == _counters(jcore)


@pytest.mark.parametrize("samp", [dict(temperature=0.0), dict(temperature=0.8, seed=7)],
                         ids=["greedy", "seeded"])
def test_draft_model_with_int8_caches_still_exact(tiny, samp):
    jmodel, jparams, model = tiny
    prompt = [3, 1, 4, 1, 5]
    base, _ = _port_run(model, _cfg(cache_dtype="int8"), prompt, 16, **samp)
    core = EngineCore(model, EngineConfig(**_cfg(spec_tokens=3, cache_dtype="int8")),
                      eos_token_ids=[], device="cpu", draft=model)
    assert is_quant(core.cache) and is_quant(core.draft.cache)
    got, _ = _drain(core, EngineRequest, protocols, prompt, 16, **samp)
    ref, jcore = _jax_run(jmodel, jparams, _cfg(spec_tokens=3, cache_dtype="int8"), prompt, 16,
                          draft=(jmodel, jparams), **samp)
    assert got == base == ref
    assert core.spec_steps > 0
    assert _counters(core) == _counters(jcore)


# ---------------------------------------------------------- beyond JAX's ----
def test_deepseek_v2_spec_matches_jax():
    """A tiny DeepSeek-V2 (MLA over the absorbed latent cache, MoE) with
    speculation on: the JAX engine's streams and counters, and the port's
    own streams with speculation off."""
    jcfg, cfg = deepseek_configs()
    tree = _perturbed_tree(jcfg, 4)
    model = _port(cfg, tree)
    rng = np.random.RandomState(5)
    seg = [int(v) for v in rng.randint(3, 96, size=6)]
    specs = [("rep", seg * 4, 12), ("rand", [int(v) for v in rng.randint(3, 96, size=19)], 10),
             ("late", seg * 2 + [9, 9], 12)]
    kw = dict(max_batch_size=4, max_model_len=128, block_size=16, num_blocks=32,
              prefill_buckets=[32, 64, 128], decode_steps=4, spec_tokens=4)
    jcore = JaxEngineCore(jds.DeepseekModel(jcfg), jax.tree.map(jnp.asarray, tree),
                          JaxEngineConfig(**kw), eos_token_ids=[])
    try:
        ref = _serve(jcore, JaxEngineRequest, jax_protocols, specs)
    finally:
        jcore.close()
    core = EngineCore(model, EngineConfig(**kw), eos_token_ids=[], device="cpu")
    out = _serve(core, EngineRequest, protocols, specs)
    off = _serve(EngineCore(model, EngineConfig(**dict(kw, spec_tokens=0)), eos_token_ids=[],
                            device="cpu"), EngineRequest, protocols, specs)
    assert out == ref
    assert {rid: v[:2] for rid, v in out.items()} == {rid: v[:2] for rid, v in off.items()}
    assert _counters(core, COUNTERS) == _counters(jcore, COUNTERS)
    assert core.spec_steps > 0


def test_prefix_reuse_after_speculation(tiny):
    """A request whose prompt is a speculated request's prompt plus output
    hits the blocks that request committed: the JAX engine's tokens and hit
    length, and the tokens of a cold engine with speculation off (no stale
    KV of a rejected proposal was committed)."""
    jmodel, jparams, model = tiny
    rng = np.random.default_rng(9)
    seg = rng.integers(1, 250, 6).tolist()
    first = seg * 4 + [3]
    cfg = dict(BASE, decode_steps=4, spec_tokens=4)
    jcore = JaxEngineCore(jmodel, jparams, JaxEngineConfig(**cfg), eos_token_ids=[])
    core = EngineCore(model, EngineConfig(**cfg), eos_token_ids=[], device="cpu")
    try:
        ref_a = _serve(jcore, JaxEngineRequest, jax_protocols, [("a", first, 20)])
        out_a = _serve(core, EngineRequest, protocols, [("a", first, 20)])
        assert out_a == ref_a
        second = first + out_a["a"][0][:17] + [5, 6]
        ref_b = _serve(jcore, JaxEngineRequest, jax_protocols, [("b", second, 8)])
        out_b = _serve(core, EngineRequest, protocols, [("b", second, 8)])
    finally:
        jcore.close()
    assert core.spec_steps > 0 and core.spec_accepted > 0
    assert out_b == ref_b
    assert out_b["b"][2][-1] == (len(first) + 17 - 1) // 8 * 8  # the blocks A committed
    cold = _serve(EngineCore(model, EngineConfig(**BASE), eos_token_ids=[], device="cpu"),
                  EngineRequest, protocols, [("b", second, 8)])
    assert cold["b"][0] == out_b["b"][0]


@pytest.mark.parametrize("with_draft", [False, True], ids=["ngram", "draft"])
def test_one_device_read_per_verify_turn(tiny, with_draft):
    """A verify turn reads the device once, plus once per draft dispatch."""
    _, _, model = tiny
    core = EngineCore(model, EngineConfig(**_cfg(spec_tokens=4)), eos_token_ids=[],
                      device="cpu", draft=model if with_draft else None)
    reads = []
    if with_draft:
        real = core.draft._read

        def counted(props):
            reads.append(1)
            return real(props)

        core.draft._read = counted
    core.submit(EngineRequest(
        request_id="r", prompt=CYCLE_PROMPT * 2, sampling=protocols.SamplingOptions(),
        stops=protocols.StopConditions(max_tokens=20, ignore_eos=True), emit=lambda o: None))
    spec_turns = 0
    while core.has_work():
        before = (core.spec_steps, core.device_gets, core.steps)
        core.step()
        if core.spec_steps > before[0]:
            spec_turns += 1
            assert core.spec_steps == before[0] + 1
            assert core.device_gets == before[1] + 1
            assert core.steps == before[2] + 1
    assert spec_turns > 0
    assert len(reads) == (core.draft.dispatches if with_draft else 0)
    if with_draft:
        assert core.draft.dispatches >= spec_turns
