"""The port's grammar module against the JAX package's, on the CPU.

* host tables: the JSON pushdown tables, choice tries, regex DFAs, the
  schema regexes and their tables, and composites are ``np.array_equal``
  field for field (``next_state``, the four pop/push tables, ``eos_ok``,
  ``terminal_only``) over the byte vocabularies of
  ``tests/test_grammar.py`` and ``tests/test_grammar_engine.py``; a bad
  pattern raises the same ``RegexError`` message; ``token_bytes_map``
  maps the same fake tokenizers to the same bytes;
* device half: ``grammar_mask`` (masked logits) and ``grammar_advance``
  (state, depth, stack) in torch equal the JAX functions exactly, along
  random constrained walks over a composite of the JSON grammar, a choice
  set and a regex, from reachable states only.

Tolerance: none — every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import grammar as jg
from dynamo_tpu_torch.engine import grammar as tg

FIELDS = ("next_state", "npops", "popbits", "npush", "pushbits", "eos_ok", "terminal_only")


def grammar_vocab():
    """``tests/test_grammar.py``'s vocabulary: token 0 = EOS, 1..256 the
    single bytes, then multi-byte tokens (context-dependent ones too)."""
    toks: list = [None] + [bytes([b]) for b in range(256)]
    toks += [b'{"', b'":', b'", "', b'"}', b'true', b'false', b'null', b'123', b'3.14',
             b'-1e9', b'[1,', b'{}', b'[]', b'  ', b'\\"', b'\\u00ff', b'}}', b']]', b'"a"',
             b'0.5]', b'},', b'],', b',"', b'{"a":', b'[[', b'{{']
    return toks, [0]


def engine_vocab():
    """``tests/test_grammar_engine.py``'s: ids 3..258 the single bytes, a
    few multi-byte tokens, the rest None, EOS = 2."""
    toks: list = [None] * 512
    for b in range(256):
        toks[3 + b] = bytes([b])
    toks[300:306] = [b'{"', b'":', b'"}', b'true', b'[1,', b'23']
    return toks, [2]


VOCABS = {"grammar": grammar_vocab, "engine": engine_vocab}


def assert_tables_equal(port, ref):
    for f in FIELDS:
        a, b = getattr(port, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert port.eos_ids == ref.eos_ids


@pytest.mark.parametrize("vocab", sorted(VOCABS))
def test_json_tables_match_jax(vocab):
    toks, eos = VOCABS[vocab]()
    assert_tables_equal(tg.compile_vocab(toks, eos), jg.compile_vocab(toks, eos))
    assert_tables_equal(tg.JsonGrammar.from_token_bytes(toks, eos).tables,
                        jg.JsonGrammar.from_token_bytes(toks, eos).tables)


CHOICES = [["yes", "no", "nope"], ["on", "off"], ["alpha", "beta", "true"],
           ["x" * 40, "y" * 40], ["left", "right", "up"], ["é", "ü!"]]


@pytest.mark.parametrize("i", range(len(CHOICES)))
def test_choice_tables_match_jax(i):
    toks, eos = grammar_vocab()
    assert_tables_equal(tg.compile_choice_vocab(toks, CHOICES[i], eos),
                        jg.compile_choice_vocab(toks, CHOICES[i], eos))


PATTERNS = [r"(yes|no)[0-9]+", r"v\d+\.\d+", r"[0-9]+", r"[a-z\]]+", r"a\ b", r".", r"[^a]",
            r"^(yes|no)$", r"[0-9][0-9][0-9]-[0-9][0-9][0-9][0-9]", r"(up|down) [0-9][0-9]?%",
            jg._RX_STRING, jg._RX_NUMBER, r"\w+@\w+\.(com|org)", "(a|b)*a" + "(a|b)" * 6]
# counted repetition is outside the subset, as are truncated patterns
BAD_PATTERNS = ["a{2,5}", "[0-9]{3}", "a|", "(", "a(", "[a-\\]", "[z-a]", "a\\", "(unclosed",
                "a^b", "a$b"]


@pytest.mark.parametrize("i", range(len(PATTERNS)))
def test_regex_tables_match_jax(i):
    toks, eos = grammar_vocab()
    assert_tables_equal(tg.compile_regex_vocab(toks, PATTERNS[i], eos),
                        jg.compile_regex_vocab(toks, PATTERNS[i], eos))


@pytest.mark.parametrize("pattern", BAD_PATTERNS)
def test_bad_regex_raises_as_in_jax(pattern):
    toks, eos = grammar_vocab()
    with pytest.raises(jg.RegexError) as ref:
        jg.compile_regex_vocab(toks, pattern, eos)
    with pytest.raises(tg.RegexError) as got:
        tg.compile_regex_vocab(toks, pattern, eos)
    assert str(got.value) == str(ref.value)


SCHEMAS = [
    {"type": "object", "properties": {"verdict": {"enum": ["pass", "fail"]},
                                      "score": {"type": "number"}},
     "required": ["verdict", "score"]},
    {"type": "object", "properties": {"ok": {"type": "boolean"}, "n": {"type": "integer"}},
     "required": ["ok", "n"]},
    {"type": "object", "properties": {"a": {"type": "integer"}, "b": {"type": "boolean"},
                                      "c": {"enum": ["x", "y"]}},
     "required": ["b"]},
    {"type": "object", "properties": {"a": {"type": "integer"}}, "required": []},
    {"type": "integer", "minimum": 1, "maximum": 250},
    {"type": "integer", "exclusiveMinimum": 0, "exclusiveMaximum": 1000},
    {"anyOf": [{"type": "integer", "minimum": 0}, {"enum": ["none"]}]},
    {"oneOf": [{"type": "boolean"}, {"type": "null"}]},
    {"type": ["string", "null"]},
    {"type": "array", "items": {"type": "integer"}},
    {"type": "string", "enum": ["a", 1, "b"]},
    # untranslatable: the generic JSON grammar serves these
    {"type": "object"},
    {"type": "number", "minimum": 0.5},
    {"anyOf": [{"type": "boolean"}, {"type": "object"}]},
    {"type": "integer", "minimum": "5"},
    {"type": "integer", "minimum": 10 ** 500},
    {"enum": [1, 2], "minimum": 2},
]


@pytest.mark.parametrize("i", range(len(SCHEMAS)))
def test_schema_regex_and_tables_match_jax(i):
    rx = tg.json_schema_to_regex(SCHEMAS[i])
    assert rx == jg.json_schema_to_regex(SCHEMAS[i])
    if rx is None or len(rx) > 4096:
        return
    toks, eos = grammar_vocab()
    assert_tables_equal(tg.compile_regex_vocab(toks, rx, eos),
                        jg.compile_regex_vocab(toks, rx, eos))


def _parts(mod, toks, eos):
    return [mod.compile_vocab(toks, eos), mod.compile_choice_vocab(toks, ["on", "off"], eos),
            mod.compile_regex_vocab(toks, r"[0-9][0-9][0-9]-[0-9][0-9][0-9][0-9]", eos)]


@pytest.mark.parametrize("vocab", sorted(VOCABS))
def test_composite_tables_match_jax(vocab):
    toks, eos = VOCABS[vocab]()
    port, p_offs = tg.compose_tables(_parts(tg, toks, eos))
    ref, r_offs = jg.compose_tables(_parts(jg, toks, eos))
    assert p_offs == r_offs
    assert_tables_equal(port, ref)
    # the pushdown grammar must lead a composite, in both packages
    for mod in (tg, jg):
        json_t, choice_t, _ = _parts(mod, toks, eos)
        with pytest.raises(ValueError, match="must be the first"):
            mod.compose_tables([choice_t, json_t])


class _FakeTk:
    def __init__(self, vocab):
        self.vocab = vocab

    def get_vocab(self):
        return dict(self.vocab)

    def get_added_tokens_decoder(self):
        return {}


@pytest.mark.parametrize("vocab", [
    {"Ġhello": 0, "{": 1, "<|eot|>": 2, "ĊĊ": 3, "Ã©": 4},
    {"▁the": 0, "<0x0A>": 1, "a": 2, "<s>": 3, "<0xZZ>": 4},
])
def test_token_bytes_map_matches_jax(vocab):
    assert tg.token_bytes_map(_FakeTk(vocab)) == jg.token_bytes_map(_FakeTk(vocab))


def test_mask_and_advance_match_jax_on_reachable_states():
    """Random constrained walks over a json + choice + regex composite:
    each row starts in one part's initial state (composite ids), and at
    every step both packages mask the same logits and advance by the same
    picks (drawn from the host mask, so every state visited is
    reachable).  Rows are constrained or not at random."""
    toks, eos = grammar_vocab()
    comp, offs = tg.compose_tables(_parts(tg, toks, eos))
    jcomp, _ = jg.compose_tables(_parts(jg, toks, eos))
    v = comp.vocab_size + 5  # the model's vocab is wider than the tokenizer's
    gt = tg.device_tables(comp, v, "cpu")
    jgt = jg.device_tables(jcomp, v)
    rng = np.random.default_rng(7)
    b = 8
    part = rng.integers(0, 3, size=b)
    state = np.asarray([tg.INIT_STATE if p == 0 else 1 + offs[p] for p in part], np.int32)
    depth = np.zeros(b, np.int32)
    stack = np.zeros(b, np.int32)
    jrows = rng.random(b) < 0.8
    deepest = 0
    for step in range(48):
        logits = rng.normal(size=(b, v)).astype(np.float32)
        args = (jrows, state, depth, stack)
        got = tg.grammar_mask(torch.from_numpy(logits), gt, *map(torch.from_numpy, args))
        ref = jg.grammar_mask(jnp.asarray(logits), jgt, *map(jnp.asarray, args))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=f"step {step}")
        picks = np.zeros(b, np.int32)
        for i in range(b):
            ok = np.flatnonzero(got.numpy()[i] > -1e29)
            ok = ok[(ok != eos[0]) & (ok < comp.vocab_size)]
            # a finished row picks EOS (no state change) now and then, and
            # a third of the picks open a container when one may open
            push = ok[comp.npush[state[i], ok] > 0]
            if push.size and rng.random() < 0.3:
                ok = push
            picks[i] = eos[0] if not ok.size or rng.random() < 0.05 else rng.choice(ok)
        got = tg.grammar_advance(gt, *map(torch.from_numpy, args), torch.from_numpy(picks))
        ref = jg.grammar_advance(jgt, *map(jnp.asarray, args), jnp.asarray(picks))
        for g, r in zip(got, ref):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=f"step {step}")
        state, depth, stack = (g.numpy() for g in got)
        deepest = max(deepest, int(depth.max()))
    assert deepest > 1  # the walks went inside nested containers


def test_device_tables_fit_the_model_vocab():
    toks, eos = engine_vocab()
    t = tg.compile_vocab(toks, eos)
    for v in (400, 512, 600):
        gt = tg.device_tables(t, v, "cpu")
        ref = jg.device_tables(t, v)
        for name in gt._fields:
            np.testing.assert_array_equal(getattr(gt, name).numpy(), np.asarray(getattr(ref, name)))
        assert gt.nbytes == t.n_states * v * 6 + 2 * t.n_states + v
