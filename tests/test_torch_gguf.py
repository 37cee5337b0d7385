"""The port's GGUF reader, writer and loader against the JAX package's.

* The container: a file written by either package parses to the same
  metadata and tensor table in both, and the port's writer writes the JAX
  writer's bytes.
* Dequantisation: Q8_0, Q4_0, Q4_K, Q5_K, Q6_K, F16 and BF16 tensors read
  bit-exact against the JAX reader; ``unpermute_qk`` inverts
  ``permute_qk`` as in JAX.
* A tiny Q8_0 GGUF loads to the state ``params_from_jax`` makes of JAX's
  ``load_gguf_model`` exactly, and its logits stay within the f32 logit
  atol of the JAX model's (ROADMAP rule 3).
* Served: ``--model-path FILE.gguf`` (the checkpoint dispatch) streams
  what the same weights serve from an HF directory; the card and the
  embedded-vocab tokenizer equal JAX's.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.llm import gguf as jax_gguf
from dynamo_tpu.llm.model_card import ModelDeploymentCard as JaxCard
from dynamo_tpu.models.llama import LlamaModel as JaxLlamaModel
from dynamo_tpu_torch import cli
from dynamo_tpu_torch.llm import gguf
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.llama import LlamaModel
from tests.torch_checkpoints import (gguf_metadata, gguf_tensors, tiny_config, tiny_weights,
                                     write_hf_dir)

LOGIT_ATOL = 1e-4  # f32 logits of magnitude ~1, as tests/test_torch_llama.py


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def _blocks(rng, n, fields):
    rec = np.zeros(n, dtype=np.dtype([(f[0], f[1], f[2]) if len(f) == 3 else f for f in fields]))
    for f in fields:
        name, kind = f[0], f[1]
        shape = (n,) + (f[2] if len(f) == 3 else ())
        if kind == "<f2":
            rec[name] = rng.uniform(-0.5, 0.5, size=shape).astype(np.float16)
        elif kind == "u1":
            rec[name] = rng.integers(0, 256, size=shape).astype(np.uint8)
        else:
            rec[name] = rng.integers(-128, 128, size=shape).astype(np.int8)
    return rec.tobytes()


RAW_KINDS = {
    "q8_0": (gguf.GGML_Q8_0, 32, [("d", "<f2"), ("qs", "i1", (32,))]),
    "q4_0": (gguf.GGML_Q4_0, 32, [("d", "<f2"), ("qs", "u1", (16,))]),
    "q4_k": (gguf.GGML_Q4_K, 256, [("d", "<f2"), ("dmin", "<f2"), ("scales", "u1", (12,)),
                                   ("qs", "u1", (128,))]),
    "q5_k": (gguf.GGML_Q5_K, 256, [("d", "<f2"), ("dmin", "<f2"), ("scales", "u1", (12,)),
                                   ("qh", "u1", (32,)), ("qs", "u1", (128,))]),
    "q6_k": (gguf.GGML_Q6_K, 256, [("ql", "u1", (128,)), ("qh", "u1", (64,)),
                                   ("scales", "i1", (16,)), ("d", "<f2")]),
}


@pytest.fixture(scope="module")
def container(tmp_path_factory):
    """A GGUF holding one tensor of every ggml type the reader takes, and
    metadata of every value type, written by the port."""
    rng = np.random.default_rng(0)
    raw = {}
    for name, (t, block, fields) in RAW_KINDS.items():
        rows, cols = 4, 2 * block
        raw[name] = (t, (rows, cols), _blocks(rng, rows * cols // block, fields))
    bf16 = rng.standard_normal((3, 8)).astype(np.float32).view(np.uint32) >> 16
    raw["bf16"] = (gguf.GGML_BF16, (3, 8), bf16.astype(np.uint16).tobytes())
    tensors = {"f32": rng.standard_normal((5, 7)).astype(np.float32),
               "f16": rng.standard_normal((4, 8)).astype(np.float32),
               "q8w": rng.standard_normal((2, 64)).astype(np.float32)}
    meta = {"general.architecture": "llama", "general.name": "mix", "general.alignment": 32,
            "a.u32": 7, "a.neg": -3, "a.big": 2 ** 40, "a.f": 0.5, "a.flag": True,
            "a.list": ["x", "yz"], "a.ints": [1, 2, 3], "a.empty": []}
    path = tmp_path_factory.mktemp("gguf") / "mix.gguf"
    gguf.write_gguf(path, meta, tensors, quantize={"f16": gguf.GGML_F16,
                                                   "q8w": gguf.GGML_Q8_0}, raw=raw)
    jpath = path.with_name("mix-jax.gguf")
    jax_gguf.write_gguf(jpath, meta, tensors, quantize={"f16": gguf.GGML_F16,
                                                        "q8w": gguf.GGML_Q8_0}, raw=raw)
    return path, jpath


def test_container_bytes_and_metadata_equal_jax(container):
    path, jpath = container
    assert path.read_bytes() == jpath.read_bytes()
    gf, jf = gguf.GGUFFile(path), jax_gguf.GGUFFile(path)
    assert gf.metadata == jf.metadata and gf._data_start == jf._data_start
    assert {n: (i.shape, i.ggml_type, i.offset) for n, i in gf.tensors.items()} == \
        {n: (i.shape, i.ggml_type, i.offset) for n, i in jf.tensors.items()}


@pytest.mark.parametrize("name", ["f32", "f16", "q8w", "bf16", *RAW_KINDS])
def test_dequantisation_bit_exact_against_jax(container, name):
    path, _ = container
    got = gguf.GGUFFile(path).load_tensor(name)
    want = jax_gguf.GGUFFile(path).load_tensor(name)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_permute_roundtrip_equals_jax():
    w = np.random.default_rng(3).standard_normal((32, 12)).astype(np.float32)
    for heads in (1, 2, 4):
        p = gguf.permute_qk(w, heads)
        assert np.array_equal(p, jax_gguf.permute_qk(w, heads))
        assert np.array_equal(gguf.unpermute_qk(p, heads), w)


@pytest.fixture(scope="module")
def tiny_gguf(tmp_path_factory):
    """The tiny checkpoint's weights as an HF dir, a Q8_0 GGUF and an F32
    GGUF, each with its vocabulary."""
    root = tmp_path_factory.mktemp("tiny")
    cfg = tiny_config()
    hf = write_hf_dir(root / "hf")
    tensors = gguf_tensors(cfg, tiny_weights(cfg), gguf.permute_qk)
    meta = gguf_metadata(cfg)
    q8 = {n: gguf.GGML_Q8_0 for n, t in tensors.items() if t.ndim == 2}
    gguf.write_gguf(root / "q8.gguf", meta, tensors, quantize=q8)
    gguf.write_gguf(root / "f32.gguf", meta, tensors)
    return root, hf


def test_q8_model_state_and_logits_match_jax(tiny_gguf):
    root, _ = tiny_gguf
    path = root / "q8.gguf"
    cfg, state = gguf.load_gguf_model(path, dtype="float32", device="cpu")
    jcfg, jparams = jax_gguf.load_gguf_model(path, dtype="float32")
    ref = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    assert set(state) == set(ref) and all(torch.equal(state[k], ref[k]) for k in ref)

    model, jmodel = LlamaModel.from_state(cfg, state), JaxLlamaModel(jcfg)
    bs, n = 8, 13
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, n)
    t = np.zeros((1, 16), np.int32)
    t[0, :n] = prompt
    pos = np.zeros((1, 16), np.int32)
    pos[0, :n] = np.arange(n)
    bt = np.array([[1, 2, 0, 0]], np.int32)
    slot = np.full((1, 16), -1, np.int32)
    slot[0, :n] = bt[0, pos[0, :n] // bs] * bs + pos[0, :n] % bs
    lens = np.array([n], np.int32)
    jh, _ = jmodel.forward(jax.tree.map(jnp.asarray, jparams), jnp.asarray(t), jnp.asarray(pos),
                           jmodel.init_kv_cache(4, bs), jnp.asarray(bt), jnp.asarray(lens),
                           jnp.asarray(slot), prefix_blocks=0)
    want = np.asarray(jmodel.compute_logits(jax.tree.map(jnp.asarray, jparams), jh[:, n - 1]))
    h, _ = model.forward(torch.from_numpy(t), torch.from_numpy(pos), model.init_kv_cache(4, bs),
                         torch.from_numpy(bt), torch.from_numpy(lens), torch.from_numpy(slot),
                         prefix_blocks=0)
    got = model.compute_logits(h[:, n - 1]).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL)


async def _greedy(engine, prompt, n=6):
    from dynamo_tpu_torch.llm.protocols import BackendInput, SamplingOptions, StopConditions
    from dynamo_tpu_torch.runtime.engine import Context

    ctx = Context(BackendInput(token_ids=prompt, sampling=SamplingOptions(temperature=0.0),
                               stops=StopConditions(max_tokens=n, ignore_eos=True)))
    return [t async for o in engine.generate(ctx) for t in o.token_ids]


def _served(path):
    args = cli.parse_args(["run", "in=text:x", "out=gpu", "--model-path", str(path), "--device",
                           "cpu", "--dtype", "float32", "--max-model-len", "64", "--num-blocks",
                           "16", "--max-batch-size", "2"])
    engine, card = cli.build_local_engine(args)
    try:
        return run(_greedy(engine, [3, 9, 27, 40, 5, 11])), card
    finally:
        engine.shutdown()


def test_gguf_served_through_the_checkpoint_dispatch(tiny_gguf):
    root, hf = tiny_gguf
    from_gguf, card = _served(root / "f32.gguf")
    from_hf, _ = _served(hf)
    assert from_gguf == from_hf and len(from_gguf) == 6
    assert card.name == "tiny-gguf" and card.eos_token_ids == [2]


def test_card_and_embedded_tokenizer_equal_jax(tiny_gguf, tmp_path):
    root, _ = tiny_gguf
    src = (root / "q8.gguf").read_bytes()
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    (tmp_path / "port" / "m.gguf").write_bytes(src)
    (tmp_path / "jax" / "m.gguf").write_bytes(src)
    card = ModelDeploymentCard.from_gguf(tmp_path / "port" / "m.gguf")
    jcard = JaxCard.from_gguf(tmp_path / "jax" / "m.gguf")
    mine, theirs = card.to_dict(), jcard.to_dict()
    for d in (mine, theirs):
        d.pop("model_path")
        d["tokenizer_path"] = open(d.pop("tokenizer_path"), "rb").read()
    assert mine == theirs
    from dynamo_tpu_torch.llm.tokenizer import TokenizerWrapper

    tok = TokenizerWrapper.from_file(card.tokenizer_path)
    assert tok.encode("w1 w7", add_special_tokens=False) == \
        jax_gguf.GGUFFile(root / "q8.gguf").build_hf_tokenizer().encode(
            "w1 w7", add_special_tokens=False).ids
