"""The port's load plane (``load/``) held to the JAX package's.

The same seeds must give the same traffic, token for token; a simulated
worker the same timings and KV events; every capacity cell the same
canonical bytes; the whole sweep the same knees and metrics.  The
packages' workers are priced differently by default (the port from the
card's committed serving figures, JAX from its TPU perf manifest), so
every parity test builds one explicit ``LatencyModel`` in each package
from the same figures, the card's.  The handoff of a disaggregated cell
is priced on a path whose prior differs between the packages (the port's
``"nvlink"``, JAX's ``"ici"``), so those tests patch both packages'
``prior_cost_s`` to one function.  Then the port's own contract:
``from_card`` reads the committed file and nothing else, and no TPU
figure or scale survives.
"""

import asyncio
import dataclasses
import inspect
import json
import re
from pathlib import Path

import pytest

import dynamo_tpu_torch
from dynamo_tpu.analysis import detloop as jax_detloop
from dynamo_tpu.load import sim as jax_sim
from dynamo_tpu.load import traffic as jax_traffic
from dynamo_tpu.load import workers as jax_workers
from dynamo_tpu.obs import topology as jax_topology
from dynamo_tpu_torch.analysis import detloop
from dynamo_tpu_torch.load import sim, traffic, workers
from dynamo_tpu_torch.load.workers import LatencyModel
from dynamo_tpu_torch.obs import topology

PKG = Path(dynamo_tpu_torch.__file__).resolve().parent
CARD = json.loads((PKG / "load" / "card_latency.json").read_text())
FIGURES = {k: CARD[k] for k in ("prefill_ms_per_token", "decode_ms_per_step",
                                "router_ms_per_decision", "kv_bytes_per_block")}
PORT_PRIOR = topology.prior_cost_s


def _lats():
    """One latency model in each package, from the card's figures."""
    return (jax_workers.LatencyModel(**FIGURES, scale=1.0),
            LatencyModel(**FIGURES, scale=1.0))


@pytest.fixture
def one_prior(monkeypatch):
    """Both packages price a never-measured handoff with the port's
    NVLink prior, whatever path name their sim passes."""

    def prior(path, nbytes, topology=None):
        return PORT_PRIOR("nvlink", nbytes)

    monkeypatch.setattr(jax_topology, "prior_cost_s", prior)
    monkeypatch.setattr(topology, "prior_cost_s", prior)


# ---------------------------------------------------------------- traffic


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("family", sorted(traffic.FAMILIES))
def test_generate_matches_jax(family, seed):
    """Every family at two seeds: the same requests, token for token, and
    the same distribution oracles."""
    assert traffic.FAMILIES[family] == traffic.ScenarioSpec(
        **dataclasses.asdict(jax_traffic.FAMILIES[family]))
    kw = dict(seed=seed, rps=12.0, duration_s=20.0)
    ours = traffic.generate(traffic.FAMILIES[family], **kw)
    ref = jax_traffic.generate(jax_traffic.FAMILIES[family], **kw)
    assert len(ours) > 50
    assert [dataclasses.astuple(r) for r in ours] == [dataclasses.astuple(r) for r in ref]
    assert traffic.tenant_mass(ours, 2) == jax_traffic.tenant_mass(ref, 2)
    assert traffic.prefix_share(ours) == jax_traffic.prefix_share(ref)
    assert (traffic.arrival_histogram(ours, 20.0)
            == jax_traffic.arrival_histogram(ref, 20.0))


def test_multi_turn_prompts_share_prefixes():
    """Turn k's prompt extends turn k-1's, so its blocks' sequence hashes
    extend them too (the router's prefix hits)."""
    reqs = traffic.generate(traffic.FAMILIES["agentic"], seed=3, rps=10.0, duration_s=30.0)
    by_session: dict[str, list] = {}
    for r in reqs:
        by_session.setdefault(r.session, []).append(r)
    multi = [rs for rs in by_session.values() if len(rs) > 1]
    assert multi
    for rs in multi:
        rs.sort(key=lambda r: r.turn)
        for a, b in zip(rs, rs[1:]):
            assert b.token_ids[:a.isl] == a.token_ids
    assert traffic.prefix_share(reqs) > 0.3


# ---------------------------------------------------------------- workers


def _drive_workers(loop_mod, worker_mod, lat):
    """Three concurrent decodes with local prefill on a two-slot worker
    whose cache holds 6 blocks, a disagg prefill, then a kill mid-decode:
    every timing, return value, event and metrics snapshot."""
    loop = loop_mod.DetLoop(loop_mod.RandomScheduler(5), horizon_s=600.0)
    events: list[dict] = []
    got: list = []

    async def main():
        w = worker_mod.SimWorker(1, lat, publish=events.append, clock=loop.time,
                                 slots=2, kv_blocks=6, block_size=16)
        reqs = [([11, 12, 13], 48, 9), ([11, 12, 14, 15], 64, 5), ([21, 22], 32, 7)]

        async def one(hashes, isl, osl):
            got.append(("decode", hashes, await w.decode(hashes, osl, prefill_tokens=isl)))

        await asyncio.gather(*(one(*r) for r in reqs))
        got.append(("prefill", await w.prefill([11, 12, 31], 48, pre_delay_s=0.01)))
        m = w.metrics()
        got.append(("metrics", m.kv_active_blocks, m.request_active_slots, m.updated_at))

        async def doomed():
            try:
                await w.decode([41], 20)
            except worker_mod.SimWorkerDied as e:
                got.append(("died", str(e), loop.time()))

        t = asyncio.ensure_future(doomed())
        await asyncio.sleep(lat.decode_step_s() * 3)
        w.kill()
        await t
        w.restore()
        got.append(("restored", w.alive, w.completed, w.tokens_out, w.evicted_blocks))

    loop_mod.run_deterministic(loop, main())
    loop.close()
    return got, events


def test_sim_worker_timings_match_jax():
    jax_lat, port_lat = _lats()
    for fn in ("prefill_s", "decode_step_s", "router_s"):
        args = (300,) if fn == "prefill_s" else ()
        assert getattr(port_lat, fn)(*args) == getattr(jax_lat, fn)(*args)
    assert port_lat.transfer_bytes(7) == jax_lat.transfer_bytes(7)
    ours = _drive_workers(detloop, workers, port_lat)
    ref = _drive_workers(jax_detloop, jax_workers, jax_lat)
    assert ours == ref
    got, events = ours
    assert any(e["kind"] == "removed" for e in events)
    assert got[-1] == ("restored", True, 3, 9 + 5 + 7, got[-1][4]) and got[-1][4] > 0


# ------------------------------------------------------------------ cells


@pytest.mark.parametrize("cell", [f"{f}/{t}" for f, t in sim.CELLS])
def test_run_cell_bytes_match_jax(cell, one_prior):
    """Each of the 13 cells at level 1.0: the port's canonical bytes equal
    JAX's under one latency model and one handoff prior."""
    family, topo = cell.split("/")
    jax_lat, port_lat = _lats()
    ours = sim.run_cell(family, topo, seed=0, level=1.0, lat=port_lat)
    ref = jax_sim.run_cell(family, topo, seed=0, level=1.0, lat=jax_lat)
    assert ours["metrics"]["completed"] > 0
    assert sim.canonical_bytes(ours) == jax_sim.canonical_bytes(ref)


def test_sweep_knees_and_metrics_match_jax(one_prior):
    """The whole grid at the card's figures: every level's metrics, census,
    twin check and knee equal JAX's, and equal the port's committed
    surface (the patched prior is the port's own)."""
    jax_lat, port_lat = _lats()
    ours = sim.sweep(lat=port_lat)
    ref = jax_sim.sweep(lat=jax_lat)
    assert ours["cells"] == ref["cells"]
    committed = json.loads((PKG / "analysis" / "load_manifest.json").read_text())
    assert ours["cells"] == committed["cells"]
    assert {k: ours["params"][k] for k in ref["params"]} == ref["params"]


def test_twin_runs_are_deterministic():
    a = sim.run_cell("agentic", "w4", seed=3, level=2.0)
    b = sim.run_cell("agentic", "w4", seed=3, level=2.0)
    c = sim.run_cell("agentic", "w4", seed=4, level=2.0)
    assert sim.canonical_bytes(a) == sim.canonical_bytes(b)
    assert sim.canonical_bytes(a) != sim.canonical_bytes(c)


def test_disagg_handoff_is_priced_on_nvlink(monkeypatch):
    """Two simulated workers are two cards: the handoff's cost is asked
    for, and recorded, on the ``nvlink`` path, never the on-card ``ici``."""
    paths = []

    class Recording(sim.TransferCostTable):
        def cost_s(self, src, dst, path, nbytes):
            paths.append(path)
            return super().cost_s(src, dst, path, nbytes)

        def record(self, src, dst, path, nbytes, seconds):
            paths.append(path)
            super().record(src, dst, path, nbytes, seconds)

    monkeypatch.setattr(sim, "TransferCostTable", Recording)
    res = sim.run_cell("steady", "w16", seed=0, level=1.0)
    assert res["census"]["kv_transfers"] > 0
    assert paths and set(paths) == {"nvlink"}


def test_failure_storm_kills_restores_and_retries():
    res = sim.run_cell("failure", "w4", seed=0, level=1.0)
    c = res["census"]
    assert c["kills"] == 1 and c["restores"] == 1
    assert c.get("worker_died", 0) >= c.get("retried", 0)


def test_overload_level_sheds_and_knees():
    res = sim.run_cell("steady", "w1", seed=0, level=2.0)
    low = sim.run_cell("steady", "w1", seed=0, level=0.5)
    m = res["metrics"]
    assert m["ttft_p99_ms"] > m["sla_ttft_ms"] or m["shed_rate"] > 0.01
    assert low["metrics"]["shed_rate"] == 0.0
    levels = {"0.5": low["metrics"], "2": m}
    assert sim.knee_level(levels, m["sla_ttft_ms"]) == 2.0


# ------------------------------------------------- the card's latency model


def test_from_card_reads_the_committed_figures():
    lat = LatencyModel.from_card()
    for k, v in FIGURES.items():
        assert getattr(lat, k) == v
    assert lat.scale == CARD["scale"] == 1.0
    # the card the figures were measured on, as nvidia-smi names it
    assert "H100" in CARD["card"] and CARD["card"].endswith(" W")
    assert CARD["model"] and CARD["path"] and CARD["measured_by"]
    assert sim.run_cell("steady", "w1", seed=0)["metrics"] == sim.run_cell(
        "steady", "w1", seed=0, lat=lat)["metrics"]


def test_from_card_raises_on_a_missing_or_malformed_file(tmp_path):
    missing = tmp_path / "absent.json"
    with pytest.raises(FileNotFoundError, match="absent.json"):
        LatencyModel.from_card(missing)
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(ValueError, match="bad.json"):
        LatencyModel.from_card(bad)
    partial = tmp_path / "partial.json"
    partial.write_text(json.dumps({k: v for k, v in CARD.items()
                                   if k != "decode_ms_per_step"}))
    with pytest.raises(ValueError, match="decode_ms_per_step"):
        LatencyModel.from_card(partial)


def test_scale_override_marks_the_run(monkeypatch):
    monkeypatch.setenv("DTLOAD_SCALE", "2.5")
    assert LatencyModel.from_card().scale == 2.5
    assert LatencyModel.from_card(scale=3.0).scale == 3.0


def test_no_tpu_figure_survives():
    """No fallback constant, no perf-manifest reader and no TPU scale: the
    port's model is the card file's or nothing."""
    assert not [n for n in vars(workers) if n.startswith("_FALLBACK")]
    assert not hasattr(workers, "_DEFAULT_SCALE")
    assert not hasattr(LatencyModel, "from_perf_manifest")
    assert inspect.signature(LatencyModel).parameters["scale"].default == 1.0
    for mod in (workers, sim, traffic):
        text = Path(mod.__file__).read_text()
        assert "perf_manifest" not in text, mod.__name__
        assert not re.search(r"(?<![\d.])2000(\.0*)?(?!\d)", text), mod.__name__
