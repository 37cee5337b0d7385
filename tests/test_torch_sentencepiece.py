"""The port's SentencePiece support against the JAX package's.

* The ModelProto parse equals JAX's field for field, for a hand-built
  model (the JAX test's wire helpers) with byte pieces, a precompiled
  charsmap slot, negative varints and both dummy-prefix settings.
* The materialised ``tokenizer.json`` equals JAX's byte for byte, and
  encodes and decodes alike over a set of texts.
* A sentencepiece-only directory: the port's tokenizer and card read it
  (the refusal is gone), and the preprocessed prompt's ids equal the JAX
  package's; SP-BPE is refused as in JAX.
"""

import dataclasses
import json

import pytest

from dynamo_tpu.llm import sentencepiece as jax_sp
from dynamo_tpu.llm.model_card import ModelDeploymentCard as JaxCard
from dynamo_tpu.llm.tokenizer import TokenizerWrapper as JaxTokenizerWrapper
from dynamo_tpu_torch.llm import sentencepiece as sp
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.tokenizer import TokenizerWrapper
from tests.test_sentencepiece import PIECES, _key, _len_field, _make_model, _piece, _vint

BYTE_PIECES = PIECES + [(f"<0x{b:02X}>", 0.0, sp.BYTE) for b in range(256)]
TEXTS = ["hello world", "hello  world", " hello", "held", "wörld ✓", "", "hello\nworld"]


@pytest.mark.parametrize("pieces,dummy", [(PIECES, True), (PIECES, False), (BYTE_PIECES, True)],
                         ids=["unigram", "no-dummy-prefix", "byte-fallback"])
def test_parse_and_materialise_equal_jax(tmp_path, pieces, dummy):
    data = _make_model(pieces, add_dummy_prefix=dummy)
    mine, theirs = sp.parse_model_proto(data), jax_sp.parse_model_proto(data)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    for d in ("port", "jax"):
        (tmp_path / d / "tokenizer.model").write_bytes(data)
    out = sp.materialize_tokenizer(tmp_path / "port" / "tokenizer.model")
    jout = jax_sp.materialize_tokenizer(tmp_path / "jax" / "tokenizer.model")
    assert out == tmp_path / "port" / "tokenizer.json"
    assert out.read_bytes() == jout.read_bytes()
    tok, jtok = sp.build_hf_tokenizer(mine), jax_sp.build_hf_tokenizer(theirs)
    for text in TEXTS:
        ids = tok.encode(text).ids
        assert ids == jtok.encode(text).ids
        assert tok.decode(ids) == jtok.decode(ids)


def test_sentencepiece_only_directory_reads_as_jax(tmp_path):
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "tokenizer.model").write_bytes(_make_model(BYTE_PIECES))
        (tmp_path / d / "config.json").write_text(json.dumps(
            {"architectures": ["LlamaForCausalLM"], "eos_token_id": 2, "bos_token_id": 1}))
    tw = TokenizerWrapper.from_file(tmp_path / "port")
    jtw = JaxTokenizerWrapper.from_file(tmp_path / "jax")
    for text in TEXTS:
        assert tw.encode(text) == jtw.encode(text)
        assert tw.decode(tw.encode(text, add_special_tokens=False)) == \
            jtw.decode(jtw.encode(text, add_special_tokens=False))
    card = ModelDeploymentCard.from_hf_dir(tmp_path / "port", name="sp")
    jcard = JaxCard.from_hf_dir(tmp_path / "jax", name="sp")
    assert card.tokenizer_path == str(tmp_path / "port" / "tokenizer.json")
    mine, theirs = card.to_dict(), jcard.to_dict()
    for d in (mine, theirs):
        d.pop("model_path")
        d["tokenizer_path"] = open(d.pop("tokenizer_path"), "rb").read()
    assert mine == theirs
    # a .model file given directly
    assert TokenizerWrapper.from_file(tmp_path / "port" / "tokenizer.model").encode("held") \
        == jtw.encode("held")


def test_sp_bpe_refused_as_jax():
    bad = b"".join(_piece(*p) for p in PIECES) + _len_field(2, _key(3, 0) + _vint(2))
    with pytest.raises(NotImplementedError):
        sp.build_hf_tokenizer(sp.parse_model_proto(bad))
    with pytest.raises(ValueError, match="no pieces"):
        sp.parse_model_proto(_len_field(2, _key(3, 0) + _vint(1)))
    assert sp.is_sentencepiece_model(__file__) is False
