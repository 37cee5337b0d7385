"""The port's manifest renderer and operator against the JAX package's.

* Manifests: the same spec renders the JAX package's objects after the
  renderer's three translations (a ``gpu:`` block for a ``tpu:`` block,
  ``nvidia.com/gpu`` for ``google.com/tpu`` and its node selector, the
  port's CLI for ``dynamo-tpu`` in the containers the renderer writes);
  a ``tpu:`` block is refused by name.
* The operator: every reconcile case of the JAX operator tests, run in
  both packages on ``MemoryCluster`` (create, scale, delete, drift,
  directory and custom-resource sources with their torn-read rules, live
  status phases, both autoscale signals, a coordinator outage, a real
  engine's published metrics) gives the same reconcile summaries, cluster
  operations, replica counts and statuses.  The kubectl adapters run
  against an in-process stand-in for the kubectl binary: no process is
  started.
"""

import asyncio
import contextlib
import copy
import io
import json
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
import yaml

import dynamo_tpu.deploy.operator as jax_operator
import dynamo_tpu.deploy.renderer as jax_renderer
import dynamo_tpu.llm.kv_router.publisher as jax_publisher
import dynamo_tpu.runtime.transports.coordinator as jax_coord
import dynamo_tpu_torch
import dynamo_tpu_torch.deploy.operator as operator
import dynamo_tpu_torch.deploy.renderer as renderer
import dynamo_tpu_torch.llm.kv_router.publisher as publisher
import dynamo_tpu_torch.runtime.transports.coordinator as coord

JAX = SimpleNamespace(op=jax_operator, r=jax_renderer, coord=jax_coord,
                      pub=jax_publisher, gpu=False)
PORT = SimpleNamespace(op=operator, r=renderer, coord=coord, pub=publisher, gpu=True)
sys.path.insert(0, str(Path(__file__).resolve().parent))
import _fake_kubectl  # noqa: E402

H100 = "NVIDIA-H100-80GB-HBM3"
TPU_RX = re.compile(r"tpu: \{type: (\w+), topology: \"([\dx]+)\", chips: (\d+)\}")


def to_gpu(text):
    """A JAX spec's ``tpu:`` blocks as the port's ``gpu:`` blocks: the chip
    count becomes the card count, the v5e pools become H100 nodes."""
    return TPU_RX.sub(lambda m: f"gpu: {{count: {m.group(3)}, product: {H100}}}", text)


def spec_text(p, text):
    return to_gpu(text) if p.gpu else text


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


SPEC = """
name: llama-disagg
namespace: serving
image: dynamo-tpu:latest
frontend: {replicas: 2, port: 8080}
services:
  decode:
    command: [dynamo-tpu, run, "in=dyn://dynamo.decode.generate", out=tpu]
    replicas: 1
    tpu: {type: v5e, topology: "2x2", chips: 4}
  prefill:
    command: [dynamo-tpu, run, "in=dyn://dynamo.prefill.generate", out=tpu]
    replicas: 4
    tpu: {type: v5e, topology: "1x1", chips: 1}
    env: {DYNTPU_ROLE: prefill}
    port: 9000
"""
EXAMPLE = (Path(__file__).resolve().parent.parent / "deploy/examples/disagg-v5e.yaml").read_text()
BARE = """
name: bare
image: img:1
coordinator: {port: 7000}
metrics: {port: 9999}
services:
  worker:
    command: [python3, -m, PKG, run, "in=dyn://ns.worker.generate", out=gpu,
              --coordinator, tcp://elsewhere:1]
    autoscale: {signal: decode, min: 1, max: 3}
""".replace("PKG", dynamo_tpu_torch.__name__)


def translate(objs, specs):
    """The JAX package's manifests under the renderer's translations."""
    chips = {s.name: s for s in specs.services}
    out = copy.deepcopy(objs)
    for o in out:
        if o["kind"] != "Deployment":
            continue
        pod = o["spec"]["template"]["spec"]
        c = pod["containers"][0]
        if c["name"] in ("coordinator", "frontend", "metrics"):  # the renderer's own
            assert c["command"][0] == "dynamo-tpu"
            c["command"] = renderer.CLI + c["command"][1:]
        res = c.get("resources")
        if res:
            n = res["limits"].pop("google.com/tpu")
            res["requests"].pop("google.com/tpu")
            res["limits"]["nvidia.com/gpu"] = res["requests"]["nvidia.com/gpu"] = n
            svc = chips[c["name"]]
            assert svc.tpu_chips == int(n)
            pod["nodeSelector"] = {"nvidia.com/gpu.product": H100}
    return out


@pytest.mark.parametrize("text", [SPEC, EXAMPLE, BARE], ids=["disagg", "example", "bare"])
def test_manifests_equal_jax_after_translations(text, tmp_path):
    jspec = jax_renderer.DeploymentSpec.from_yaml(text)
    spec = renderer.DeploymentSpec.from_yaml(to_gpu(text))
    objs = renderer.render_manifests(spec)
    assert objs == translate(jax_renderer.render_manifests(jspec), jspec)
    # one file per object, the same names, the same objects back
    paths = renderer.render_to_dir(spec, tmp_path / "port")
    jpaths = jax_renderer.render_to_dir(jspec, tmp_path / "jax")
    assert [p.name for p in paths] == [p.name for p in jpaths]
    assert [yaml.safe_load(p.read_text()) for p in paths] == objs
    gpu = [s for s in spec.services if s.gpu_count]
    assert [(s.gpu_count, s.gpu_product) for s in gpu] == [
        (s.tpu_chips, H100) for s in jspec.services if s.tpu_chips]


def test_gpu_block_without_product_and_tpu_refused():
    spec = renderer.DeploymentSpec.from_yaml(SPEC.replace(
        'tpu: {type: v5e, topology: "2x2", chips: 4}', "gpu: {count: 2}").replace(
        'tpu: {type: v5e, topology: "1x1", chips: 1}', ""))
    deps = {o["metadata"]["name"]: o["spec"]["template"]["spec"]
            for o in renderer.render_manifests(spec) if o["kind"] == "Deployment"}
    decode, prefill = deps["llama-disagg-decode"], deps["llama-disagg-prefill"]
    assert decode["containers"][0]["resources"]["limits"] == {"nvidia.com/gpu": "2"}
    assert "nodeSelector" not in decode and "resources" not in prefill["containers"][0]
    with pytest.raises(ValueError, match="tpu: block"):
        renderer.DeploymentSpec.from_yaml(SPEC)
    with pytest.raises(ValueError, match="'decode'"):
        renderer.DeploymentSpec.from_dict(yaml.safe_load(EXAMPLE))


# ---------------------------------------------------------------- operator


OP_SPEC = """
name: llama-disagg
namespace: serving
image: dynamo-tpu:latest
frontend: {replicas: 1, port: 8080}
services:
  decode:
    command: [dynamo-tpu, run, "in=dyn://dynamo.decode.generate", "out=tpu"]
    replicas: 1
    tpu: {type: v5e, topology: "2x2", chips: 4}
  prefill:
    command: [dynamo-tpu, run, "in=dyn://dynamo.prefill.generate", "out=tpu"]
    replicas: 4
    tpu: {type: v5e, topology: "1x1", chips: 1}
"""
AUTOSCALE_SPEC = """
name: llm
namespace: serving
image: dynamo-tpu:latest
services:
  decode:
    command: [dynamo-tpu, run, "in=dyn://dynamo.decode.generate", "out=tpu"]
    replicas: 2
  prefill:
    command: [dynamo-tpu, run, "in=dyn://dynamo.prefill.generate", "out=tpu"]
    replicas: 1
    autoscale: {min: 1, max: 4, target_per_replica: 2}
"""
DECODE_AUTOSCALE_SPEC = """
name: llm
namespace: serving
image: dynamo-tpu:latest
services:
  decode:
    command: [dynamo-tpu, run, "in=dyn://dynamo.decode.generate", "out=tpu"]
    replicas: 2
    autoscale: {signal: decode, min: 1, max: 6, target_usage: 0.5}
"""
CR_YAML = """
apiVersion: dynamo-tpu.dev/v1alpha1
kind: DynamoTpuDeployment
metadata: {name: llm, namespace: serving}
spec:
  image: dynamo-tpu:latest
  services:
    decode:
      command: [dynamo-tpu, run, "in=dyn://dynamo.decode.generate", "out=tpu"]
      replicas: 2
"""


def _spec(p, text):
    return p.r.DeploymentSpec.from_yaml(spec_text(p, text))


def _replicas(cluster, name):
    return cluster.objects[("Deployment", "serving", name)]["spec"]["replicas"]


def _keys(cluster):
    return sorted(cluster.objects)


def _both(scenario, *args):
    """Run one scenario in each package: its records must be equal."""
    got = scenario(PORT, *args)
    assert got == scenario(JAX, *args)
    return got


def _create_scale_delete(p):
    cluster, rec = p.op.MemoryCluster(), []
    op = p.op.Operator(cluster)
    spec = _spec(p, OP_SPEC)
    op.set_spec(spec)
    s = op.reconcile_once()
    rec += [s, _keys(cluster), _replicas(cluster, "llama-disagg-prefill"), op.reconcile_once()]
    scaled = copy.deepcopy(spec)
    scaled.services[1].replicas = 8
    op.set_spec(scaled)
    rec += [op.reconcile_once(), _replicas(cluster, "llama-disagg-prefill")]
    total = len(cluster.list_owned(op.owner))
    op.delete_spec(spec.name)
    rec += [op.reconcile_once(), total, cluster.list_owned(op.owner), op.status]
    return rec


def test_create_scale_delete_reconcile():
    rec = _both(_create_scale_delete)
    created, keys, pf, level, scale, pf8, delete, total, left, _ = rec
    assert created["created"] == len(keys) > 0 and pf == 4
    assert level == {"created": 0, "updated": 0, "deleted": 0, "unchanged": len(keys)}
    assert scale == {"created": 0, "updated": 1, "deleted": 0, "unchanged": len(keys) - 1}
    assert pf8 == 8 and delete["deleted"] == total and left == []


def _drift_and_foreign(p):
    cluster = p.op.MemoryCluster()
    foreign = {"kind": "Deployment", "metadata": {"name": "unrelated", "namespace": "serving"}}
    cluster.apply(foreign)
    op = p.op.Operator(cluster)
    op.set_spec(_spec(p, OP_SPEC))
    op.reconcile_once()
    key = next(k for k in cluster.objects if "decode" in k[2])
    cluster.objects.pop(key)
    s = op.reconcile_once()
    return [s, key in cluster.objects, p.op.obj_key(foreign) in cluster.objects, cluster.ops]


def test_drift_repair_and_foreign_objects_untouched():
    s, healed, foreign_kept, ops = _both(_drift_and_foreign)
    assert s["created"] == 1 and healed and foreign_kept
    assert all(k[2] != "unrelated" for verb, k in ops if verb == "delete")


def _load_dir_cases(p, tmp_path):
    d = tmp_path / ("port" if p.gpu else "jax")
    d.mkdir()
    f = d / "a.yaml"
    rec = []
    cluster = p.op.MemoryCluster()
    op = p.op.Operator(cluster)
    f.write_text(spec_text(p, OP_SPEC))
    op.load_dir(d)
    rec.append(op._wake.is_set())
    op._wake.clear()
    op.reconcile_once()
    owned = cluster.list_owned(op.owner)
    op.load_dir(d)  # unchanged directory: no wake (no hot spin)
    rec.append(op._wake.is_set())
    f.write_text("{this is : not yaml ::")  # torn read keeps the spec
    op.load_dir(d)
    op.reconcile_once()
    rec.append(cluster.list_owned(op.owner) == owned)
    f.write_text(spec_text(p, OP_SPEC))
    op.load_dir(d)
    op.reconcile_once()
    rec.append(cluster.list_owned(op.owner) == owned)
    f.unlink()
    op.load_dir(d)
    rec.append(op._wake.is_set())
    op.reconcile_once()
    rec += [len(owned), cluster.list_owned(op.owner), [(v, k) for v, k in cluster.ops]]
    return rec


def test_load_dir_watch_torn_read_and_wake(tmp_path):
    rec = _load_dir_cases(PORT, tmp_path)
    assert rec == _load_dir_cases(JAX, tmp_path)
    first_wake, steady_wake, torn_kept, repaired, delete_wake, n_owned, left, _ = rec
    assert first_wake and not steady_wake and torn_kept and repaired and delete_wake
    assert n_owned > 0 and left == []


def _async_loop(p):
    async def go():
        cluster = p.op.MemoryCluster()
        op = p.op.Operator(cluster, interval_s=30.0).start()
        await asyncio.sleep(0.05)
        op.set_spec(_spec(p, OP_SPEC))
        for _ in range(100):
            await asyncio.sleep(0.02)
            if cluster.list_owned(op.owner):
                break
        await op.stop()
        return _keys(cluster), op.status

    return run(go())


def test_async_loop_reconciles_on_set_spec():
    keys, status = _both(_async_loop)
    assert keys and status["llama-disagg"]["phase"] == "Unknown"


async def _register(worker, comp, n):
    leases = []
    for _ in range(n):
        lease = await worker.lease_create(ttl=30.0)
        await worker.kv_put(f"dynamo/components/{comp}/endpoints/generate/{lease:x}",
                            {"instance_id": lease}, lease_id=lease)
        leases.append(lease)
    return leases


def _on_coordinator(p, body):
    """Run ``body(op, cluster, coord_client, worker_client)`` against a fresh
    coordinator."""
    async def go():
        srv = await PORT.coord.CoordinatorServer(port=0).start()
        c = await p.coord.CoordinatorClient(srv.url).connect()
        worker = await p.coord.CoordinatorClient(srv.url).connect()
        try:
            return await body(p, c, worker)
        finally:
            await worker.close()
            await c.close()
            await srv.stop()

    return run(go())


def _phases(p):
    op0 = p.op.Operator(p.op.MemoryCluster())
    op0.set_spec(_spec(p, AUTOSCALE_SPEC))
    op0.reconcile_once()

    async def body(p, c, worker):
        op = p.op.Operator(p.op.MemoryCluster(), coordinator=c)
        op.set_spec(_spec(p, AUTOSCALE_SPEC))
        out = []
        for comp, n in ((None, 0), ("decode", 1), ("decode", 1)):
            if comp:
                await _register(worker, comp, n)
            if len(out) == 2:
                await _register(worker, "prefill", 1)
            await op.observe()
            op.reconcile_once()
            out.append(copy.deepcopy(op.status["llm"]))
        return out

    return [op0.status["llm"]["phase"]] + _on_coordinator(p, body)


def test_phase_from_live_registrations():
    unknown, pending, degraded, ready = _both(_phases)
    assert unknown == "Unknown" and pending["phase"] == "Pending"
    assert degraded["phase"] == "Degraded" and degraded["workers"]["decode"] == {"want": 2,
                                                                                "live": 1}
    assert ready["phase"] == "Ready" and ready["workers"]["prefill"] == {"want": 1, "live": 1}


def _queue_autoscale(p):
    async def body(p, c, pusher):
        cluster = p.op.MemoryCluster()
        op = p.op.Operator(cluster, coordinator=c)
        op.set_spec(_spec(p, AUTOSCALE_SPEC))
        await op.observe()
        op.reconcile_once()
        out = [_replicas(cluster, "llm-prefill")]
        for n in (6, 20):
            for i in range(n):
                await pusher.queue_push("dynamo_prefill_queue", {"i": i})
            await op.observe()
            op.reconcile_once()
            out.append((_replicas(cluster, "llm-prefill"), dict(op.status["llm"]["queue_depth"])))
        while True:
            item = await pusher.queue_pull("dynamo_prefill_queue")
            if item is None:
                break
            await pusher.queue_ack("dynamo_prefill_queue", item[0])
        for _ in range(4):
            await op.observe()
            op.reconcile_once()
            out.append(_replicas(cluster, "llm-prefill"))
        return out

    return _on_coordinator(p, body)


def test_autoscale_on_queue_depth():
    assert _both(_queue_autoscale) == [1, (3, {"prefill": 6}), (4, {"prefill": 26}), 3, 2, 1, 1]


def _decode_autoscale(p):
    async def body(p, c, worker):
        cluster = p.op.MemoryCluster()
        op = p.op.Operator(cluster, coordinator=c)
        op.set_spec(_spec(p, DECODE_AUTOSCALE_SPEC))
        wids = await _register(worker, "decode", 2)

        async def publish(slots, kv):
            for wid in wids:
                await worker.publish(p.pub.metrics_subject("dynamo", wid), {
                    "worker_id": wid, "request_active_slots": slots, "request_total_slots": 8,
                    "kv_active_blocks": kv, "kv_total_blocks": 100, "num_requests_waiting": 0})
            await asyncio.sleep(0.05)

        async def tick():
            await op.observe()
            op.reconcile_once()
            return _replicas(cluster, "llm-decode"), op.status["llm"].get("decode_usage")

        out = [await tick()]
        for slots, kv in ((8, 20), (0, 90), (1, 5)):
            await publish(slots, kv)
            out.append(await tick())
        for wid in wids:  # silence: the metrics go stale, replicas hold
            op._metrics["dynamo"][wid]["_rx"] -= 1e6
        out.append(await tick())
        return out

    return _on_coordinator(p, body)


def test_autoscale_on_decode_saturation():
    out = _both(_decode_autoscale)
    assert out[0] == (2, None)
    assert out[1] == (4, {"decode": 1.0})
    assert out[2][0] >= 4 and out[3][0] == out[2][0] - 1
    assert out[4][0] == out[3][0]


def _autoscale_file_rules(p, tmp_path):
    d = tmp_path / ("port" if p.gpu else "jax")
    d.mkdir()
    (d / "llm.yaml").write_text(spec_text(p, AUTOSCALE_SPEC))
    capped = AUTOSCALE_SPEC.replace(
        "autoscale: {min: 1, max: 4, target_per_replica: 2}",
        "autoscale: {min: 1, target_per_replica: 2}").replace(
        "replicas: 1\n    autoscale", "replicas: 3\n    autoscale")

    async def body(p, c, _):
        cluster = p.op.MemoryCluster()
        op = p.op.Operator(cluster, coordinator=c, watch_dir=str(d))
        op.load_dir(d)
        for _ in range(8):
            await c.queue_push("dynamo_prefill_queue", {})
        await op.observe()
        op.reconcile_once()
        out = [_replicas(cluster, "llm-prefill")]
        op._wake.clear()
        op.load_dir(d)  # the reparse keeps the scaled value, and no wake
        out += [op.specs["llm"].services[1].replicas, op._wake.is_set(), op.reconcile_once()]
        while (item := await c.queue_pull("dynamo_prefill_queue")) is not None:
            await c.queue_ack("dynamo_prefill_queue", item[0])
        # without a max, the cap is the file's declared replicas
        op2 = p.op.Operator(p.op.MemoryCluster(), coordinator=c)
        op2.set_spec(_spec(p, capped))
        svc = op2.specs["llm"].services[1]
        seen = [svc.replicas]
        for _ in range(2):
            await op2.observe()
            seen.append(svc.replicas)
        for _ in range(10):
            await c.queue_push("dynamo_prefill_queue", {})
        await op2.observe()
        return out + [seen + [svc.replicas]]

    return _on_coordinator(p, body)


def test_autoscale_survives_reparse_and_caps_at_declared(tmp_path):
    rec = _autoscale_file_rules(PORT, tmp_path)
    assert rec == _autoscale_file_rules(JAX, tmp_path)
    scaled, reparsed, woke, s, capped = rec
    assert scaled == reparsed == 4 and not woke and s["updated"] == s["created"] == 0
    assert capped == [3, 2, 1, 3]


def _outage(p, tmp_path):
    d = tmp_path / ("port" if p.gpu else "jax")
    d.mkdir()
    (d / "llm.yaml").write_text(spec_text(p, AUTOSCALE_SPEC))

    async def go():
        srv = await PORT.coord.CoordinatorServer(port=0).start()
        c = await p.coord.CoordinatorClient(srv.url).connect()
        await srv.stop()
        cluster = p.op.MemoryCluster()
        op = p.op.Operator(cluster, coordinator=c, interval_s=0.05, watch_dir=str(d))
        op.start()
        try:
            for _ in range(100):
                if cluster.objects and "llm" in op.status:
                    break
                await asyncio.sleep(0.02)
            return _keys(cluster), op.status["llm"]["phase"]
        finally:
            await op.stop()
            await c.close()

    return run(go())


def test_coordinator_outage_does_not_halt_reconcile(tmp_path):
    keys, phase = _outage(PORT, tmp_path)
    assert (keys, phase) == _outage(JAX, tmp_path)
    assert keys and phase == "Unknown"


# ------------------------------------------------------------ CRD source ----


class FakeCrSource:
    """CR objects in, status patches out (the JAX tests' double)."""

    def __init__(self):
        self.items, self.patches, self.fail_list = [], [], False

    def list(self):
        if self.fail_list:
            raise RuntimeError("apiserver away")
        return [copy.deepcopy(o) for o in self.items]

    def patch_status(self, ns, name, status):
        self.patches.append((ns, name, copy.deepcopy(status)))


def _cr(name, ns="serving", replicas=2, uid=None):
    md = {"name": name, "namespace": ns}
    if uid:
        md["uid"] = uid
    return {"metadata": md, "spec": {"image": "dynamo-tpu:latest", "services": {"decode": {
        "command": ["dynamo-tpu", "run", "in=dyn://dynamo.decode.generate", "out=tpu"],
        "replicas": replicas}}}}


def _cr_sync(p):
    async def body(p, c, worker):
        cluster, src = p.op.MemoryCluster(), FakeCrSource()
        src.items.append(_cr("llm"))
        op = p.op.Operator(cluster, coordinator=c, cr_source=src)
        out = []
        for phase in range(2):
            if phase:
                await _register(worker, "decode", 2)
            op.load_crs()
            await op.observe()
            op.reconcile_once()
            op.push_status()
            out.append(src.patches[-1])
        src.fail_list = True  # an apiserver blip keeps the specs
        op.load_crs()
        out.append((op.reconcile_once(), _keys(cluster)))
        src.fail_list = False
        src.items.clear()
        op.load_crs()
        out.append(op.reconcile_once())
        op.push_status()
        out.append((cluster.list_owned(op.owner), len(src.patches)))
        return out

    return _on_coordinator(p, body)


def test_cr_source_sync_status_and_prune():
    pending, ready, (blip, keys), pruned, (left, n_patches) = _both(_cr_sync)
    assert pending[:2] == ("serving", "llm") and pending[2]["phase"] == "Pending"
    assert pending[2]["workers"]["decode"] == {"want": 2, "live": 0}
    assert ready[2]["phase"] == "Ready"
    assert ("Deployment", "serving", "llm-decode") in keys and blip["deleted"] == 0
    assert pruned["deleted"] > 0 and left == [] and n_patches == 2


def _cr_cases(p, tmp_path):
    rec = []
    # a bad CR is skipped, good ones live
    cluster, src = p.op.MemoryCluster(), FakeCrSource()
    src.items = [{"metadata": {"name": "bad"}, "spec": {}}, _cr("good")]
    op = p.op.Operator(cluster, cr_source=src)
    op.load_crs()
    op.reconcile_once()
    rec.append((sorted(op.specs), _keys(cluster)))
    # combined with a directory: pruning spares directory specs, a torn CR
    # keeps its spec, a namespace collision is refused, no-op patches skip
    d = tmp_path / ("port" if p.gpu else "jax")
    d.mkdir()
    (d / "dir.yaml").write_text(spec_text(p, OP_SPEC))
    cluster, src = p.op.MemoryCluster(), FakeCrSource()
    src.items.append(_cr("llm"))
    op = p.op.Operator(cluster, cr_source=src, watch_dir=str(d))
    for _ in range(2):
        op.load_dir(d)
        op.load_crs()
        op.reconcile_once()
        rec.append((sorted(op.specs), len(cluster.list_owned(op.owner))))
    good = src.items[0]
    src.items[0] = {"metadata": {"name": "llm", "namespace": "serving"}, "spec": {}}
    op.load_crs()
    op.reconcile_once()
    rec.append(("llm" in op.specs, ("Deployment", "serving", "llm-decode") in cluster.objects))
    src.items[0] = good
    src.items.append(_cr("llm", ns="other"))
    op.load_crs()
    rec.append(op._cr_ident["llm"][0])
    src.items.pop()
    op.load_crs()
    op.reconcile_once()
    op.push_status()
    n = len(src.patches)
    op.reconcile_once()
    op.push_status()
    rec.append(len(src.patches) - n)
    # a CR colliding with a set_spec deployment is refused; a recreated CR
    # (fresh uid) is re-pushed; dropped status keys merge-delete
    cluster, src = p.op.MemoryCluster(), FakeCrSource()
    op = p.op.Operator(cluster, cr_source=src)
    op.set_spec(_spec(p, OP_SPEC))
    src.items.append(_cr("llama-disagg", uid="u1"))
    op.load_crs()
    rec.append(("llama-disagg" in op._cr_ident, op.specs["llama-disagg"].services[1].name))
    src.items = [_cr("llm", uid="u2")]
    op.load_crs()
    op.reconcile_once()
    op.push_status()
    n = len(src.patches)
    src.items = []
    op.load_crs()
    op.reconcile_once()
    src.items = [_cr("llm", uid="u3")]
    op.load_crs()
    op.reconcile_once()
    op.push_status()
    rec.append(len(src.patches) - n)
    op._pushed_status["llm"] = {"phase": "Unknown", "objects": 1, "queue_depth": {"prefill": 9}}
    op.push_status()
    rec.append(src.patches[-1])
    return rec


def test_cr_bad_spec_dir_coexistence_collisions_and_recreation(tmp_path):
    rec = _cr_cases(PORT, tmp_path)
    assert rec == _cr_cases(JAX, tmp_path)
    (specs, keys), tick1, tick2, torn, ns, noop, clash, repushed, last = rec
    assert specs == ["good"] and ("Deployment", "serving", "good-decode") in keys
    assert tick1 == tick2 and tick1[0] == ["llama-disagg", "llm"]
    assert torn == (True, True) and ns == "serving" and noop == 0
    assert clash == (False, "prefill") and repushed > 0
    assert last[2].get("queue_depth", "absent") is None


# ----------------------------------------------------- kubectl adapters ----


@pytest.fixture
def fake_kubectl(tmp_path, monkeypatch):
    """``subprocess.run`` of both operator modules answered in-process by the
    fake kubectl's ``main`` over a JSON state file: no process starts."""
    state = tmp_path / "cluster.json"
    monkeypatch.setenv("FAKE_KUBECTL_STATE", str(state))
    calls = []

    def fake_run(argv, input=None, capture_output=True, text=True):
        calls.append(list(argv))
        out, err = io.StringIO(), io.StringIO()
        stdin = sys.stdin
        sys.stdin = io.StringIO(input or "")
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = _fake_kubectl.main(argv[1:])
        finally:
            sys.stdin = stdin
        return subprocess.CompletedProcess(argv, rc, out.getvalue(), err.getvalue())

    for mod in (operator, jax_operator):
        monkeypatch.setattr(mod.subprocess, "run", fake_run)
    return SimpleNamespace(state=state, calls=calls, run=fake_run)


def _apply(k, text):
    assert k.run(["kubectl", "apply", "-f", "-"], input=text).returncode == 0


def _objects(k):
    return json.loads(k.state.read_text())["objects"]


def _kubectl_lifecycle(p, k, monkeypatch):
    if k.state.exists():
        k.state.unlink()
    del k.calls[:]
    _apply(k, CR_YAML)
    op = p.op.Operator(p.op.KubectlCluster(kubectl="kubectl"),
                       cr_source=p.op.KubectlCrSource(kubectl="kubectl"))
    op.load_crs()
    rec = [op.reconcile_once()]
    op.push_status()
    objs = _objects(k)
    dep = objs["Deployment|serving|llm-decode"]
    rec += [dep["spec"]["replicas"], dep["metadata"]["annotations"][p.op.OWNER_ANNOTATION],
            objs["DynamoTpuDeployment|serving|llm"]["status"]]
    _apply(k, CR_YAML.replace("replicas: 2", "replicas: 3"))
    op.load_crs()
    rec += [op.reconcile_once(), op.reconcile_once(),
            _objects(k)["Deployment|serving|llm-decode"]["spec"]["replicas"]]
    _apply(k, "apiVersion: v1\nkind: ConfigMap\nmetadata: {name: unrelated, namespace: serving}\n")
    # a malformed CR keeps its previous spec
    _apply(k, CR_YAML.replace('command: [dynamo-tpu, run, "in=dyn://dynamo.decode.generate", '
                              '"out=tpu"]\n      replicas: 2', "replicas: 9"))
    op.load_crs()
    rec.append(op.specs["llm"].services[0].replicas)
    # apiserver down: the CR list fails soft, cluster calls raise, and the
    # run loop rides it out
    monkeypatch.setenv("FAKE_KUBECTL_DOWN", "1")
    op.load_crs()
    with pytest.raises(RuntimeError, match="connection to the server"):
        op.cluster.list_owned(op.owner)

    async def one_tick():
        t = op.start()
        await asyncio.sleep(0.05)
        await op.stop()
        return t._task.done() and t._task.exception() is None

    rec.append(run(one_tick()))
    monkeypatch.delenv("FAKE_KUBECTL_DOWN")
    assert k.run(["kubectl", "delete", "dynamotpudeployment.dynamo-tpu.dev", "llm", "-n",
                  "serving"]).returncode == 0
    op.load_crs()
    rec.append(op.reconcile_once())
    left = _objects(k)
    rec.append(sorted(left))
    src = p.op.KubectlCrSource(kubectl="kubectl")
    _apply(k, CR_YAML)
    src.patch_status("serving", "llm", {"phase": "Ready", "queue_depth": {"prefill": 9}})
    src.patch_status("serving", "llm", {"phase": "Ready", "queue_depth": None})
    rec.append(_objects(k)["DynamoTpuDeployment|serving|llm"]["status"])
    # every kubectl command line the adapters issued, in order
    rec.append([c for c in k.calls])
    return rec


def test_kubectl_adapters_end_to_end(fake_kubectl, monkeypatch):
    rec = _kubectl_lifecycle(PORT, fake_kubectl, monkeypatch)
    assert rec == _kubectl_lifecycle(JAX, fake_kubectl, monkeypatch)
    created, replicas, owner, status, edit, steady, replicas3, kept, survived, pruned, left, \
        merged, calls = rec
    assert created["created"] > 0 and replicas == 2 and owner == "dynamo-tpu-operator"
    assert status["phase"] == "Unknown" and status["workers"]["decode"]["want"] == 2
    assert edit["updated"] >= 1 and steady == {"created": 0, "updated": 0, "deleted": 0,
                                               "unchanged": steady["unchanged"]}
    assert replicas3 == 3 and kept == 3 and survived and pruned["deleted"] > 0
    assert [x for x in left if x.startswith("Deployment|")] == []
    assert "ConfigMap|serving|unrelated" in left and merged == {"phase": "Ready"}
    assert all(c[0] == "kubectl" for c in calls)


# ------------------------------------------ the metrics plane's autoscale ----


def _partial_reporting(p):
    async def body(p, c, worker):
        cluster = p.op.MemoryCluster()
        op = p.op.Operator(cluster, coordinator=c)
        op.set_spec(_spec(p, DECODE_AUTOSCALE_SPEC))
        wids = await _register(worker, "decode", 2)
        await op.observe()
        op.reconcile_once()
        out = [_replicas(cluster, "llm-decode")]
        full = {"request_active_slots": 8, "request_total_slots": 8, "kv_active_blocks": 90,
                "kv_total_blocks": 100, "num_requests_waiting": 0}
        for reporting in (wids[:1], wids):
            for wid in reporting:
                await worker.publish(p.pub.metrics_subject("dynamo", wid),
                                     dict(full, worker_id=wid))
            await asyncio.sleep(0.05)
            await op.observe()
            op.reconcile_once()
            out.append((_replicas(cluster, "llm-decode"), "decode_usage" in op.status["llm"]))
        return out

    return _on_coordinator(p, body)


def test_operator_partial_reporting_holds():
    assert _both(_partial_reporting) == [2, (2, False), (4, True)]


def test_live_engine_metrics_autoscale_the_operator():
    """A real port engine on the CPU publishes its ForwardPassMetrics through
    KvMetricsPublisher and the coordinator; the port's operator scales its
    decode service on them as the JAX operator does on the same numbers."""
    from dynamo_tpu_torch.engine import EngineConfig, EngineCore
    from dynamo_tpu_torch.engine.request import EngineRequest
    from dynamo_tpu_torch.llm.protocols import SamplingOptions, StopConditions
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.models.convert import init_params
    from dynamo_tpu_torch.models.llama import LlamaModel

    cfg = ModelConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_position_embeddings=256, dtype="float32")
    model = LlamaModel.from_state(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                                   device="cpu"))
    core = EngineCore(model, EngineConfig(max_batch_size=2, max_model_len=128, block_size=8,
                                          num_blocks=64), eos_token_ids=[], device="cpu")
    for rid in ("a", "b"):
        core.submit(EngineRequest(request_id=rid, prompt=[1, 2, 3, 4], emit=lambda o: None,
                                  sampling=SamplingOptions(temperature=0.0),
                                  stops=StopConditions(max_tokens=64, ignore_eos=True)))
    for _ in range(4):
        core.step()
    metrics = core.metrics()
    assert metrics["request_active_slots"] == 2

    def scenario(p):
        async def body(p, c, worker):
            (lease,) = await _register(worker, "decode", 1)
            pub = p.pub.KvMetricsPublisher(worker, worker_id=lease, source=lambda: metrics,
                                           namespace="dynamo")
            cluster = p.op.MemoryCluster()
            op = p.op.Operator(cluster, coordinator=c)
            op.set_spec(_spec(p, DECODE_AUTOSCALE_SPEC.replace("replicas: 2", "replicas: 1")))
            await op.observe()
            op.reconcile_once()
            before = _replicas(cluster, "llm-decode")
            await pub.publish_once()
            await asyncio.sleep(0.05)
            await op.observe()
            op.reconcile_once()
            return before, _replicas(cluster, "llm-decode"), op.status["llm"]["decode_usage"]

        return _on_coordinator(p, body)

    # slot usage 2/2 = 1.0 against a target of 0.5: ceil(1 x 1.0 / 0.5) = 2
    assert _both(scenario) == (1, 2, {"decode": 1.0})
