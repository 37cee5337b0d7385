"""The port's native checkpoint against the JAX package's.

* ``quantize`` on an HF directory writes the JAX package's manifest,
  field for field, and int8 tensors and scales equal to
  ``params_from_jax(quantize_params(...))`` of the JAX load, bit for bit;
  ``--scheme none`` keeps the dense tensors of the port's own load.
* A JAX checkpoint (orbax ``params/``) is refused by name, by the loader
  and by ``run``.
* ``quantize`` then ``run`` on the CPU: the native checkpoint serves the
  tokens that ``--quantize int8`` on the HF directory serves, and a dense
  native checkpoint given ``--quantize int8`` too.
"""

import asyncio
import json

import pytest
import torch

from dynamo_tpu.models.checkpoint import save_checkpoint as jax_save_checkpoint
from dynamo_tpu.models.loader import load_model_dir as jax_load_model_dir
from dynamo_tpu.models.quant import quantize_params as jax_quantize_params
from dynamo_tpu_torch import cli
from dynamo_tpu_torch.models.checkpoint import (MANIFEST, PARAMS, is_native_checkpoint,
                                                load_checkpoint, save_checkpoint)
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.loader import load_model_dir
from tests.torch_checkpoints import write_hf_dir


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    return write_hf_dir(tmp_path_factory.mktemp("hf") / "tiny")


@pytest.fixture(scope="module")
def converted(hf_dir, tmp_path_factory):
    """``quantize`` (int8 and none) by the port's CLI, and the JAX
    package's int8 checkpoint of the same directory."""
    root = tmp_path_factory.mktemp("ck")
    cli.main(["quantize", str(hf_dir), str(root / "int8"), "--device", "cpu"])
    cli.main(["quantize", str(hf_dir), str(root / "dense"), "--scheme", "none", "--device",
              "cpu", "--dtype", "float32"])
    jcfg, jparams = jax_load_model_dir(hf_dir)
    jq = jax_quantize_params(jparams)
    jax_save_checkpoint(root / "jax", jcfg, jq, quantized=True)
    return root, jcfg, jq


def test_manifest_fields_equal_jax(converted):
    root, _, _ = converted
    port = json.loads((root / "int8" / MANIFEST).read_text())
    assert port == json.loads((root / "jax" / MANIFEST).read_text())
    assert port["quantized"] is True and port["format"] == 1
    assert json.loads((root / "dense" / MANIFEST).read_text())["quantized"] is False
    for name in ("tokenizer.json", "config.json"):
        assert (root / "int8" / name).is_file()


def test_int8_params_equal_jax_bit_for_bit(converted):
    root, jcfg, jq = converted
    cfg, state, quantized = load_checkpoint(root / "int8", device="cpu")
    assert quantized and is_native_checkpoint(root / "int8")
    ref = params_from_jax(jq, cfg, device="cpu")
    assert set(state) == set(ref)
    for name in ref:
        assert state[name].dtype == ref[name].dtype, name
        assert torch.equal(state[name], ref[name]), name
    assert any(t.dtype == torch.int8 for t in state.values())


def test_dense_roundtrip_and_dtype_override(converted, hf_dir, tmp_path):
    root, _, _ = converted
    cfg, state, quantized = load_checkpoint(root / "dense", device="cpu")
    _, direct = load_model_dir(hf_dir, dtype="float32", device="cpu")
    assert not quantized and cfg.dtype == "float32"
    assert all(torch.equal(state[k], direct[k]) for k in direct) and set(state) == set(direct)
    cfg16, state16, _ = load_checkpoint(root / "dense", dtype="bfloat16", device="cpu")
    assert cfg16.dtype == "bfloat16" and state16["embed"].dtype == torch.bfloat16
    # a rewrite drops the old manifest first and writes it last
    save_checkpoint(tmp_path / "re", cfg, state, quantized=False)
    assert (tmp_path / "re" / PARAMS).is_file() and is_native_checkpoint(tmp_path / "re")


def test_orbax_checkpoint_refused_by_name(converted):
    root, _, _ = converted
    assert (root / "jax" / "params").is_dir()
    with pytest.raises(ValueError, match="orbax"):
        load_checkpoint(root / "jax", device="cpu")
    args = cli.parse_args(["run", "in=text:w1", "out=gpu", "--device", "cpu", "--model-path",
                           str(root / "jax")])
    with pytest.raises(ValueError, match="orbax"):
        cli.build_local_engine(args)


async def _greedy(engine, prompt, n=6):
    from dynamo_tpu_torch.llm.protocols import BackendInput, SamplingOptions, StopConditions
    from dynamo_tpu_torch.runtime.engine import Context

    ctx = Context(BackendInput(token_ids=prompt, sampling=SamplingOptions(temperature=0.0),
                               stops=StopConditions(max_tokens=n, ignore_eos=True)))
    return [t async for o in engine.generate(ctx) for t in o.token_ids]


FLAGS = ["--device", "cpu", "--max-model-len", "64", "--num-blocks", "16",
         "--max-batch-size", "2"]


def _stream(path, *extra):
    args = cli.parse_args(["run", "in=text:x", "out=gpu", "--model-path", str(path), *FLAGS,
                           *extra])
    engine, card = cli.build_local_engine(args)
    try:
        toks = run(_greedy(engine, [3, 9, 27, 40, 5, 11]))
        return toks, engine.core.model.quantized
    finally:
        engine.shutdown()


def test_quantize_then_run_serves_the_int8_stream(converted, hf_dir):
    root, _, _ = converted
    native, native_q8 = _stream(root / "int8")
    hf, hf_q8 = _stream(hf_dir, "--quantize", "int8")
    dense_then_q8, dq8 = _stream(root / "dense", "--quantize", "int8", "--dtype", "bfloat16")
    assert native_q8 and hf_q8 and dq8
    assert native == hf == dense_then_q8 and len(native) == 6
