"""The port's model store against the JAX package's.

* A directory pushed by one package is pulled by the other, through
  either package's coordinator: the same manifest digest, every file's
  sha256 equal to the source's, and the same cache directory name.
* A cache hit downloads nothing; a corrupt cached file is re-pulled; a
  manifest entry that escapes the cache is refused; a non-ref passes
  through ``resolve_model`` unchanged.
* The CLI: ``models push`` and ``models pull`` against a coordinator, and
  ``run --model-path dyn://models/NAME`` serving the pulled copy with the
  answer the directory itself gives.
"""

import asyncio
import os
import subprocess
import sys
from pathlib import Path

import pytest

import dynamo_tpu_torch
from dynamo_tpu.llm import model_store as jax_store
from dynamo_tpu.runtime.transports.coordinator import CoordinatorClient as JaxCoordinatorClient
from dynamo_tpu.runtime.transports.coordinator import CoordinatorServer as JaxCoordinatorServer
from dynamo_tpu_torch.llm import model_store as store
from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorClient, CoordinatorServer
from tests.torch_checkpoints import write_hf_dir

PKG = dynamo_tpu_torch.__name__
REPO = Path(__file__).resolve().parent.parent


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = write_hf_dir(tmp_path_factory.mktemp("m") / "tiny")
    (d / "sub").mkdir()
    (d / "sub" / "notes.txt").write_text("nested files ship too\n")
    (d / "__pycache__").mkdir()
    (d / "__pycache__" / "x.pyc").write_bytes(b"never shipped")
    return d


def _digests(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): store.file_sha256(p)
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("pusher,coordinator", [("jax", "port"), ("port", "jax"),
                                                ("port", "port")])
def test_push_pull_across_packages(model_dir, tmp_path, pusher, coordinator):
    puller = "jax" if pusher == "port" else "port"
    mods = {"port": (store, CoordinatorClient), "jax": (jax_store, JaxCoordinatorClient)}

    async def go():
        srv = await (CoordinatorServer if coordinator == "port" else JaxCoordinatorServer)(
            port=0).start()
        push_mod, push_cls = mods[pusher]
        pull_mod, pull_cls = mods[puller]
        pc, qc = await push_cls(srv.url).connect(), await pull_cls(srv.url).connect()
        try:
            manifest = await push_mod.push_model(pc, "org/tiny", model_dir)
            path = await pull_mod.pull_model(qc, "org/tiny", tmp_path / "cache")
            again = await pull_mod.pull_model(qc, "org/tiny", tmp_path / "cache")
            return manifest, Path(path), Path(again)
        finally:
            await pc.close()
            await qc.close()
            await srv.stop()

    manifest, path, again = run(go())
    src = {k: v for k, v in _digests(model_dir).items() if not k.startswith("__pycache__")}
    assert _digests(path) == src
    assert {r: f["sha256"] for r, f in manifest["files"].items()} == src
    assert path == again and path.name == f"org--tiny-{manifest['digest'][:12]}"


def test_cache_repairs_refusals_and_passthrough(model_dir, tmp_path):
    async def go():
        srv = await CoordinatorServer(port=0).start()
        c = await CoordinatorClient(srv.url).connect()
        try:
            await store.push_model(c, "tiny", model_dir)
            path = Path(await store.resolve_model("dyn://models/tiny", c, tmp_path / "cache"))
            (path / "config.json").write_text("{}")   # a torn write
            (path / "sub" / "notes.txt").unlink()       # a lost file
            again = Path(await store.resolve_model("dyn://models/tiny", c, tmp_path / "cache"))
            repaired = _digests(again)
            # an untrusted manifest naming a path outside the cache
            bad = await c.kv_get(store.manifest_key("tiny"))
            bad["files"] = {"../escape": bad["files"]["config.json"]}
            bad["digest"] = "f" * 64
            await c.kv_put(store.manifest_key("evil"), bad)
            with pytest.raises(IOError, match="safe relative path"):
                await store.pull_model(c, "evil", tmp_path / "cache")
            with pytest.raises(FileNotFoundError, match="not found"):
                await store.pull_model(c, "missing", tmp_path / "cache")
            return path, again, repaired
        finally:
            await c.close()
            await srv.stop()

    path, again, repaired = run(go())
    assert again == path
    assert repaired == {k: v for k, v in _digests(model_dir).items()
                        if not k.startswith("__pycache__")}
    assert not (tmp_path / "escape").exists()
    assert run(store.resolve_model(str(model_dir))) == str(model_dir)
    with pytest.raises(ValueError, match="needs a coordinator"):
        run(store.resolve_model("dyn://models/x"))
    assert store.is_model_ref("dyn://models/a") and not store.is_model_ref("dyn://ns.c.e")


def _env(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", HOME=str(tmp_path / "home"),
               DYNAMO_MODEL_CACHE=str(tmp_path / "cache"))
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_cli_push_pull_and_run_from_a_ref(model_dir, tmp_path):
    """``models push``, ``models pull`` and ``run --model-path
    dyn://models/NAME`` as processes, against a coordinator on this
    process's loop (driven with create_subprocess_exec so the loop keeps
    serving it)."""
    env = _env(tmp_path)

    async def cli(*args):
        p = await asyncio.create_subprocess_exec(
            sys.executable, "-m", PKG, *args, env=env, cwd=str(REPO),
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE)
        out, err = await asyncio.wait_for(p.communicate(), 120)
        assert p.returncode == 0, err.decode()[-2000:]
        return out.decode()

    text_args = ["in=text:w1 w2 w3", "out=gpu", "--device", "cpu", "--dtype", "float32",
                 "--max-tokens", "4", "--max-model-len", "64", "--num-blocks", "16"]

    async def go():
        srv = await CoordinatorServer(port=0).start()
        try:
            pushed = await cli("models", "push", "tiny", str(model_dir), "--coordinator", srv.url)
            pulled = await cli("models", "pull", "tiny", "--out", str(tmp_path / "pulled"),
                               "--coordinator", srv.url)
            from_ref = await cli("run", *text_args, "--model-path", "dyn://models/tiny",
                                 "--coordinator", srv.url)
            return pushed, pulled, from_ref
        finally:
            await srv.stop()

    pushed, pulled, from_ref = run(go())
    assert pushed.startswith("pushed tiny: ")
    path = Path(pulled.strip())
    assert path.parent == tmp_path / "pulled" and (path / "config.json").is_file()
    direct = subprocess.run([sys.executable, "-m", PKG, "run", *text_args, "--model-path",
                             str(model_dir)], env=env, cwd=str(REPO), capture_output=True,
                            text=True, timeout=120)
    assert direct.returncode == 0, direct.stderr[-2000:]
    assert from_ref == direct.stdout and from_ref.strip()
