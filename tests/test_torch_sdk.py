"""The port's SDK (``dynamo_tpu_torch/sdk``) and packaging
(``dynamo_tpu_torch/deploy/packaging.py``) against the JAX package's.

* ServiceConfig: Common inheritance and merge as in ``tests/test_sdk.py``,
  and the ``DYNTPU_SERVICE_CONFIG`` form read across the packages both ways.
* The same graph shape declared in both packages has the same closure and
  the same reverse-topological boot order; ``link`` edges are scoped by the
  graph module that made them, and a mismatched module raises.
* ``serve_graph`` serves echo services in process, and ``serve_worker``
  serves one in a process of its own.
* ``GpuAllocator`` pins GPU services through ``CUDA_VISIBLE_DEVICES`` and
  hides the GPUs from the rest; ``ServeSupervisor`` starts, scales and stops
  worker processes, every one exiting 0 after its drain.
* Package archives are interchangeable between the packages, tampering is
  caught, and ``package push|pull|list`` and ``serve --package`` work
  against the JAX package's api-store.
"""

import asyncio
import io
import json
import os
import signal
import subprocess
import sys
import tarfile
import textwrap
from pathlib import Path

import pytest

import dynamo_tpu.sdk as jsdk
import dynamo_tpu_torch
import dynamo_tpu_torch.sdk as tsdk
from dynamo_tpu.components.api_store import ApiStore
from dynamo_tpu.deploy import packaging as jpkg
from dynamo_tpu_torch.deploy import packaging as tpkg
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorServer
from dynamo_tpu_torch.sdk import (
    ServiceConfig,
    async_on_start,
    depends,
    dynamo_endpoint,
    serve_graph,
    service,
)
from dynamo_tpu_torch.sdk.config import CONFIG_ENV
from dynamo_tpu_torch.sdk.serving import GpuAllocator, ServeSupervisor

REPO = Path(__file__).resolve().parent.parent
# the port's package name, never spelled in a string here (the metrics lint
# reads strings starting with the JAX package's prefix as scraped metrics)
PKG = dynamo_tpu_torch.__name__


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# ------------------------------------------------------------------ config ----


def test_service_config_common_inheritance():
    cfg = ServiceConfig({
        "Common": {"model": "llama", "block-size": 16, "unused": 1},
        "Worker": {"common-configs": ["model", "block-size"], "tp": 4},
        "Router": {"common-configs": ["model"], "model": "override"},
    })
    assert cfg.for_service("Worker") == {"model": "llama", "block-size": 16, "tp": 4}
    assert cfg.for_service("Router") == {"model": "override"}
    assert cfg.for_service("Nope") == {}
    assert cfg.for_service("Worker") == jsdk.ServiceConfig(cfg.data).for_service("Worker")


def test_service_config_merge():
    cfg = ServiceConfig({"A": {"x": 1, "y": 2}})
    merged = cfg.merged_with({"A": {"y": 3}, "B": {"z": 4}})
    assert merged.for_service("A") == {"x": 1, "y": 3}
    assert merged.for_service("B") == {"z": 4}
    assert merged.data == jsdk.ServiceConfig(cfg.data).merged_with(
        {"A": {"y": 3}, "B": {"z": 4}}).data


@pytest.mark.parametrize("writer,reader", [(jsdk.ServiceConfig, ServiceConfig),
                                           (ServiceConfig, jsdk.ServiceConfig)],
                         ids=["jax-to-port", "port-to-jax"])
def test_service_config_env_roundtrip_across_packages(monkeypatch, writer, reader):
    data = {"Common": {"m": "p"}, "A": {"x": 1, "common-configs": ["m"]}}
    env = writer(data).to_env()
    assert list(env) == [CONFIG_ENV]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert reader.from_env().for_service("A") == {"x": 1, "m": "p"}


def test_service_config_from_yaml(tmp_path):
    f = tmp_path / "g.yaml"
    f.write_text("Common:\n  bs: 32\nW:\n  common-configs: [bs]\n  engine: gpu\n")
    assert ServiceConfig.from_yaml(f).for_service("W") == {"bs": 32, "engine": "gpu"}
    assert ServiceConfig.from_yaml(f).data == jsdk.ServiceConfig.from_yaml(f).data


# ----------------------------------------------------------- graph shape ----


def _diamond(sdk):
    """Entry A depends on B and links C; C depends on B and links D; an
    unlinked E is pruned."""

    @sdk.service(dynamo={"namespace": "t"})
    class B:
        pass

    @sdk.service(dynamo={"namespace": "t"})
    class D:
        pass

    @sdk.service(dynamo={"namespace": "t"})
    class C:
        b = sdk.depends(B)

    @sdk.service(dynamo={"namespace": "t"})
    class E:
        pass

    @sdk.service(dynamo={"namespace": "t"})
    class A:
        b = sdk.depends(B)

    A.link(C).link(D)
    return A


def test_closure_and_boot_order_equal_jax():
    port, jax_ = _diamond(tsdk), _diamond(jsdk)
    names = lambda svcs: [s.name for s in svcs]  # noqa: E731
    assert names(port.closure()) == names(jax_.closure())
    assert set(names(port.closure())) == {"A", "B", "C", "D"}
    order = names(port.boot_order())
    assert order == names(jax_.boot_order())
    assert order.index("B") < order.index("C") < order.index("A")
    assert order.index("D") < order.index("C")
    # edges are scoped by the module that made them
    assert names(port.closure(__name__)) == names(port.closure())
    assert names(port.closure("other.graph")) == ["A", "B"]
    assert port.component == "a"


def _toy_services():
    @service(dynamo={"namespace": "toy"})
    class Backend:
        @dynamo_endpoint
        async def generate(self, req):
            for tok in req["tokens"]:
                yield {"tok": tok * 2}

    @service(dynamo={"namespace": "toy"})
    class Middle:
        backend = depends(Backend)

        def __init__(self):
            self.scale = self.service_config.get("scale", 1)

        @dynamo_endpoint
        async def process(self, req):
            async for item in self.backend.generate(req):
                yield {"tok": item["tok"] * self.scale}

    @service(dynamo={"namespace": "toy"})
    class Frontend:
        middle = depends(Middle)

        @async_on_start
        async def boot(self):
            self.booted = True

        @dynamo_endpoint
        async def entry(self, req):
            async for item in self.middle.process(req):
                yield item

    return Frontend, Middle, Backend


def test_serve_graph_e2e():
    Frontend, _, _ = _toy_services()

    async def go():
        srv = await CoordinatorServer(port=0).start()
        try:
            handle = await serve_graph(
                Frontend, config=ServiceConfig({"Middle": {"scale": 10}}),
                runtime_config=RuntimeConfig(coordinator_url=srv.url, lease_ttl_s=2.0))
            try:
                assert handle.instances["Frontend"].booted
                assert handle.instances["Middle"].scale == 10
                rt = handle.runtimes[0]
                client = await rt.namespace("toy").component("frontend").endpoint(
                    "entry").client()
                out = [x async for x in client.generate(Context({"tokens": [1, 2, 3]}))]
                await client.close()
            finally:
                await handle.stop()
        finally:
            await srv.stop()
        return out

    assert run(go()) == [{"tok": 20}, {"tok": 40}, {"tok": 60}]


def test_serve_graph_refuses_a_mismatched_graph_module():
    @service(dynamo={"namespace": "mm"})
    class Tail:
        @dynamo_endpoint
        async def generate(self, req):
            yield req

    @service(dynamo={"namespace": "mm"})
    class Head:
        pass

    Head.link(Tail)
    with pytest.raises(ValueError, match="matches no link edges from Head"):
        run(serve_graph(Head, graph="not.this.module"))


def test_serve_graph_stops_what_it_started_when_a_service_fails():
    """A service that fails to boot raises out of serve_graph, and the
    services booted before it stop: their endpoints leave discovery."""

    @service(dynamo={"namespace": "fail"})
    class Ok:
        @dynamo_endpoint
        async def generate(self, req):
            yield req

    @service(dynamo={"namespace": "fail"})
    class Broken:
        ok = depends(Ok)

        @async_on_start
        async def boot(self):
            raise RuntimeError("boot failed")

    async def go():
        from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorClient

        srv = await CoordinatorServer(port=0).start()
        coord = await CoordinatorClient(srv.url).connect()
        seen = []

        def on_event(event, key, value):
            seen.append((event, key.split("/")[2]))

        try:
            await coord.watch("fail/", on_event)
            with pytest.raises(RuntimeError, match="boot failed"):
                await serve_graph(Broken, runtime_config=RuntimeConfig(coordinator_url=srv.url))
            for _ in range(100):
                if not await coord.kv_get_prefix("fail/"):
                    break
                await asyncio.sleep(0.02)
            return seen, await coord.kv_get_prefix("fail/")
        finally:
            await coord.close()
            await srv.stop()

    seen, left = run(go())
    assert ("put", "ok") in seen and ("delete", "ok") in seen
    assert left == {}


# --------------------------------------------------------- worker processes ----


GRAPH_MODULE = textwrap.dedent(
    """
    from PKG.sdk import dynamo_endpoint, service

    @service(dynamo={"namespace": "sub"})
    class Echo:
        @dynamo_endpoint
        async def generate(self, req):
            for x in req:
                yield x + self.service_config.get("bias", 0)

    @service(dynamo={"namespace": "sub"})
    class Head:
        @dynamo_endpoint
        async def generate(self, req):
            import os

            yield os.environ.get("CUDA_VISIBLE_DEVICES")

    Head.link(Echo)
    """
).replace("PKG", PKG)


def _child_env(tmp_path, **extra) -> dict:
    return dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{REPO}", JAX_PLATFORMS="cpu",
                **extra)


async def _client(rt, component: str, n: int = 1):
    client = await rt.namespace("sub").component(component).endpoint("generate").client()
    await client.wait_for_instances(n, timeout=30)
    return client


def test_serve_worker_subprocess(tmp_path):
    (tmp_path / "toy_graph.py").write_text(GRAPH_MODULE)

    async def go():
        srv = await CoordinatorServer(port=0).start()
        proc = subprocess.Popen(
            [sys.executable, "-m", f"{PKG}.sdk.serve_worker", "toy_graph:Head", "Echo"],
            env=_child_env(tmp_path, DYNTPU_COORDINATOR=srv.url,
                           DYNTPU_SERVICE_CONFIG=json.dumps({"Echo": {"bias": 100}})),
            cwd=tmp_path, stderr=subprocess.PIPE, text=True)
        try:
            rt = await DistributedRuntime.connect(RuntimeConfig(coordinator_url=srv.url,
                                                                lease_ttl_s=2.0))
            client = await _client(rt, "echo")
            out = [x async for x in client.generate(Context([1, 2]))]
            await client.close()
            await rt.shutdown()
        finally:
            proc.send_signal(signal.SIGTERM)
            _, err = await asyncio.to_thread(proc.communicate, timeout=30)
            await srv.stop()
        return out, proc.returncode, err

    out, rc, err = run(go())
    assert out == [101, 102]
    assert rc == 0, err[-2000:]
    assert f"[Echo] INFO {PKG}.serve_worker: Echo drained and stopped" in err


class _Svc:
    def __init__(self, name, gpus=0):
        self.name, self.resources = name, ({"gpu": gpus} if gpus else {})


def test_gpu_allocator(monkeypatch):
    monkeypatch.setenv("DYNTPU_GPUS", "0,0,1")
    alloc = GpuAllocator()
    assert alloc.free == [0, 0, 1]  # duplicates kept: two workers may share a card
    assert alloc.allocate(_Svc("Frontend")) == {"CUDA_VISIBLE_DEVICES": ""}
    a = alloc.allocate(_Svc("GpuWorker", 1))
    b = alloc.allocate(_Svc("PrefillWorker", 1))
    assert a == b == {"CUDA_VISIBLE_DEVICES": "0"}
    with pytest.raises(RuntimeError, match="service Big wants 2 GPUs, only 1 free"):
        alloc.allocate(_Svc("Big", 2))
    alloc.release(a)
    assert alloc.allocate(_Svc("Big", 2)) == {"CUDA_VISIBLE_DEVICES": "1,0"}
    alloc.release({"CUDA_VISIBLE_DEVICES": ""})
    assert alloc.free == []
    monkeypatch.delenv("DYNTPU_GPUS")
    with pytest.raises(RuntimeError, match="wants 1 GPUs, only 0 free"):
        GpuAllocator().allocate(_Svc("GpuWorker", 1))


def test_supervisor_start_scale_stop(tmp_path, monkeypatch):
    """The supervisor spawns the port's serve_worker per service worker,
    pins nothing for GPU-less services, scales one service up and down,
    and stops every worker with exit 0."""
    (tmp_path / "sup_graph.py").write_text(GRAPH_MODULE)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PYTHONPATH", f"{tmp_path}{os.pathsep}{REPO}")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "7")  # what the children must not inherit

    async def go():
        sup = ServeSupervisor("sup_graph:Head", ServiceConfig({"Echo": {"bias": 5}}),
                              drain_grace_s=8.0)
        await sup.start()
        try:
            assert sorted(sup.procs) == ["Echo:0", "Head:0"]
            rt = await DistributedRuntime.connect(
                RuntimeConfig(coordinator_url=sup.coordinator_url, lease_ttl_s=2.0))
            try:
                head = await _client(rt, "head")
                seen = [x async for x in head.generate(Context(None))]
                assert await sup.scale("Echo", 2) == 2
                echo = await _client(rt, "echo", 2)
                out = [x async for x in echo.generate(Context([1]))]
                assert await sup.scale("Echo", 1) == 1
                assert sorted(sup.procs) == ["Echo:0", "Head:0"]
                await head.close()
                await echo.close()
            finally:
                await rt.shutdown()
        finally:
            codes = await sup.stop()
        return seen, out, codes

    seen, out, codes = run(go())
    assert seen == [""]
    assert out == [6]
    assert codes == {"Echo:0": 0, "Head:0": 0}


# ----------------------------------------------------------------- packages ----


def _write_graph_tree(root: Path) -> Path:
    (root / "graphs").mkdir(parents=True)
    (root / "graphs" / "__init__.py").write_text("")
    (root / "graphs" / "hello.py").write_text(textwrap.dedent('''
        from PKG.sdk import depends, dynamo_endpoint, service


        @service(dynamo={"namespace": "pkg"})
        class Backend:
            @dynamo_endpoint
            async def generate(self, text: str):
                for word in str(text).split("-"):
                    yield f"{word}!"


        @service(dynamo={"namespace": "pkg"})
        class Frontend:
            backend = depends(Backend)

            @dynamo_endpoint
            async def generate(self, text: str):
                async for w in self.backend.generate(str(text).upper()):
                    yield w
        ''').replace("PKG", PKG))
    (root / "config.yaml").write_text("defaults: {}\n")
    return root


@pytest.mark.parametrize("builder,unpacker", [(tpkg, jpkg), (jpkg, tpkg)],
                         ids=["port-built", "jax-built"])
def test_packages_interchange(tmp_path, builder, unpacker):
    src = _write_graph_tree(tmp_path / "tree")
    a, b = tmp_path / "a.tgz", tmp_path / "b.tgz"
    manifest = builder.build_package(src, "graphs.hello:Frontend", "hello", a)
    # byte-identical archives from either package
    unpacker.build_package(src, "graphs.hello:Frontend", "hello", b)
    assert a.read_bytes() == b.read_bytes()
    assert set(manifest["files"]) == {"graphs/__init__.py", "graphs/hello.py", "config.yaml"}
    assert unpacker.read_manifest(a.read_bytes()) == manifest
    got, src_root = unpacker.unpack_package(a, tmp_path / "unpacked")
    assert got == manifest
    assert (src_root / "graphs" / "hello.py").read_text() == (
        src / "graphs" / "hello.py").read_text()
    hit = unpacker.cached_unpack(a, tmp_path / "cache", "hello", 1)
    assert builder.cache_lookup(tmp_path / "cache", "hello", 1) == hit
    with pytest.raises(builder.PackageError, match="not found in the package sources"):
        builder.build_package(src, "graphs.nope:X", "hello", tmp_path / "x.tgz")


def _rewrite(pkg: Path, mutate) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(pkg, "r:gz") as tin, tarfile.open(fileobj=buf, mode="w:gz") as tout:
        for m in tin.getmembers():
            m2, d2 = mutate(m, tin.extractfile(m).read())
            m2.size = len(d2)
            tout.addfile(m2, io.BytesIO(d2))
    return buf.getvalue()


def _swap(m, data):
    return m, (b"import os  # evil" if m.name == "src/graphs/hello.py" else data)


def _traverse(m, data):
    if m.name == "manifest.json":
        mf = json.loads(data)
        mf["files"]["../evil.py"] = "0" * 64
        return m, json.dumps(mf).encode()
    return m, data


@pytest.mark.parametrize("builder", [tpkg, jpkg], ids=["port-built", "jax-built"])
@pytest.mark.parametrize("mutate,error", [(_swap, "hash mismatch"), (_traverse, "escapes")],
                         ids=["payload-swap", "traversal"])
def test_package_tamper_detection(tmp_path, builder, mutate, error):
    pkg = tmp_path / "hello.tgz"
    builder.build_package(_write_graph_tree(tmp_path / "tree"), "graphs.hello:Frontend",
                          "hello", pkg)
    with pytest.raises(tpkg.PackageError, match=error):
        tpkg.unpack_package(_rewrite(pkg, mutate), tmp_path / "u")
    assert not (tmp_path / "u").exists()


async def _cli(*args, env=None, timeout=60):
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", PKG, *args, cwd=str(REPO), env=env or _child_env(REPO),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out, err = await asyncio.wait_for(proc.communicate(), timeout)
    return proc.returncode, out.decode(), err.decode()


def test_package_cli_and_serve_package(tmp_path):
    """``package build|push|list|pull`` against the JAX api-store, then
    ``serve --package hello`` pulls the archive, unpacks it into the cache
    and serves its entry; SIGTERM stops it with exit 0."""
    src = _write_graph_tree(tmp_path / "tree")
    pkg = tmp_path / "hello.tgz"
    cache = tmp_path / "cache"

    async def go():
        store = await ApiStore(db_path=":memory:", port=0).start()
        url = f"http://127.0.0.1:{store.port}"
        srv = await CoordinatorServer(port=0).start()
        try:
            built = await _cli("package", "build", str(src), "--entry", "graphs.hello:Frontend",
                               "--name", "hello", "-o", str(pkg))
            pushed = [await _cli("package", "push", str(pkg), "--api-store", url)
                      for _ in range(2)]
            listed = await _cli("package", "list", "--api-store", url)
            pulled = await _cli("package", "pull", "hello:1", "--api-store", url, "-o",
                                str(cache))
            serve = await asyncio.create_subprocess_exec(
                sys.executable, "-m", PKG, "serve", "--package", "hello", "--api-store", url,
                "--package-cache", str(cache), "--coordinator", srv.url, cwd=str(REPO),
                env=_child_env(REPO), stderr=subprocess.PIPE)
            try:
                rt = await DistributedRuntime.connect(
                    RuntimeConfig(coordinator_url=srv.url, lease_ttl_s=2.0))
                client = await rt.namespace("pkg").component("frontend").endpoint(
                    "generate").client()
                await client.wait_for_instances(1, timeout=30)
                words = [w async for w in client.generate(Context("a-b"))]
                await client.close()
                await rt.shutdown()
            finally:
                serve.send_signal(signal.SIGTERM)
                _, err = await asyncio.wait_for(serve.communicate(), 30)
        finally:
            await srv.stop()
            await store.stop()
        return built, pushed, listed, pulled, words, serve.returncode, err.decode()

    built, pushed, listed, pulled, words, rc, err = run(go())
    assert built[0] == 0, built[2][-2000:]
    assert json.loads(built[1]) == {"name": "hello", "entry": "graphs.hello:Frontend",
                                    "files": 3, "out": str(pkg)}
    assert [json.loads(p[1]) for p in pushed] == [{"name": "hello", "version": 1},
                                                  {"name": "hello", "version": 2}]
    assert json.loads(listed[1])[0]["latest_version"] == 2
    assert json.loads(pulled[1]) == {"name": "hello", "entry": "graphs.hello:Frontend",
                                     "src": str(cache / "hello-1" / "src")}
    assert words == ["A!", "B!"]
    assert rc == 0, err[-3000:]
    assert (cache / "hello-2" / "src" / "graphs" / "hello.py").exists()
    assert 'worker exit codes {"Backend:0": 0, "Frontend:0": 0}' in err
