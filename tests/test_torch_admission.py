"""The port's admission controller against the JAX package's.

* On an injected clock, the same script of acquires, releases and clock
  steps gives the same decisions in both packages: who is admitted, who
  is shed with which Retry-After, the shed counts, the estimates and the
  queue.
* The token bucket's refill and the ``admission:`` config block parse
  alike.
* HTTP: over-rate and past-deadline requests get 429 with
  ``Retry-After``, counted in the shed family (read through the port's
  metric-name constants); admitted ones are answered; the controller's
  TTFT estimate is fed by the service.
"""

import asyncio
import dataclasses
import time

import pytest
from aiohttp import ClientSession

import dynamo_tpu.planner.admission as jax_adm
import dynamo_tpu_torch.planner.admission as port_adm
from dynamo_tpu_torch.llm.protocols import FinishReason, LLMEngineOutput
from dynamo_tpu_torch.obs.metric_names import HttpMetric as HM
from dynamo_tpu_torch.planner import (AdmissionConfig, AdmissionController, AdmissionRejected,
                                      PriorityClass, TokenBucket)
from dynamo_tpu_torch.runtime.engine import AsyncEngine


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def test_token_bucket_equals_jax():
    steps = [(1, 0.0), (1, 0.0), (1, 0.0), (0.5, 0.3), (2, 0.9), (1, 1.7), (3, 5.0), (1, 5.0)]
    for rate, burst in ((1.0, 2.0), (0.5, 3.0), (4.0, 1.0), (0.0, 2.0)):
        a, b = TokenBucket(rate, burst, 0.0), jax_adm.TokenBucket(rate, burst, 0.0)
        trace_a = [(a.try_take(n, t), a.time_until(1, t), a.tokens) for n, t in steps]
        trace_b = [(b.try_take(n, t), b.time_until(1, t), b.tokens) for n, t in steps]
        assert trace_a == trace_b


def test_config_from_dict_equals_jax():
    block = {"max_concurrent": 3, "rate_tokens_per_s": 2.5, "burst_tokens": 4,
             "default_priority": "low", "default_service_s": 0.25,
             "priorities": {"low": {"max_wait_s": 1.5}, "gold": {"level": 0, "max_queue_depth": 2}}}
    for d in (block, {}):
        assert (dataclasses.asdict(AdmissionConfig.from_dict(d))
                == dataclasses.asdict(jax_adm.AdmissionConfig.from_dict(d)))


def _config(mod):
    return mod.AdmissionConfig(
        max_concurrent=2, rate_tokens_per_s=1.0, burst_tokens=3.0, default_service_s=1.0,
        priorities={
            "high": mod.PriorityClass("high", 0, max_queue_depth=2, max_wait_s=30.0),
            "normal": mod.PriorityClass("normal", 1, max_queue_depth=1, max_wait_s=30.0),
            "low": mod.PriorityClass("low", 2, max_queue_depth=8, max_wait_s=0.75),
        })


async def _script(mod) -> list:
    """One scripted run on an injected clock: each step's outcome."""
    clock = [0.0]
    ctl = mod.AdmissionController(_config(mod), clock=lambda: clock[0])
    log, tickets, waiting = [], {}, {}

    async def acquire(name, tenant, priority):
        try:
            tickets[name] = await ctl.acquire(tenant, priority)
            log.append((name, "admitted", clock[0]))
        except mod.AdmissionRejected as e:
            log.append((name, "shed", e.retry_after_s, str(e)))

    def queue(name, tenant, priority):
        waiting[name] = asyncio.ensure_future(acquire(name, tenant, priority))

    await acquire("a1", "a", "normal")
    await acquire("b1", "b", "high")
    await acquire("c1", "c", "low")          # at capacity: est. wait 1.0 s > 0.75 s
    queue("b2", "b", "high")
    queue("c2", "c", "normal")
    await asyncio.sleep(0)
    await acquire("d1", "d", "normal")       # the normal queue is full
    queue("b3", "b", "high")
    await asyncio.sleep(0)
    await acquire("b4", "b", "high")         # tenant b has spent its burst of 3
    clock[0] = 0.5
    ctl.observe_ttft(0.2)
    tickets.pop("a1").release()              # the slot goes to b2 (high first)
    await asyncio.sleep(0)
    clock[0] = 1.25
    tickets.pop("b1").release()
    await asyncio.sleep(0)
    clock[0] = 2.0
    await acquire("b5", "b", "normal")       # refilled one token since 0.0
    for name in ("b2", "b3"):
        if name in tickets:
            tickets.pop(name).release()
            await asyncio.sleep(0)
    await asyncio.gather(*waiting.values())
    for t in list(tickets.values()):
        t.release()
    stats = ctl.stats()
    return log + [("stats", stats), ("shed_total", dict(ctl.shed_total))]


def test_decisions_on_injected_clock_equal_jax():
    port = run(_script(port_adm))
    assert port == run(_script(jax_adm))
    outcomes = {e[0]: e[1] for e in port if e[0] not in ("stats", "shed_total")}
    assert outcomes["c1"] == outcomes["d1"] == outcomes["b4"] == "shed"
    assert outcomes["b2"] == outcomes["b3"] == outcomes["c2"] == "admitted"


class SlowEcho(AsyncEngine):
    """Echoes the prompt's token ids back, one every ``delay_s``."""

    def __init__(self, delay_s: float):
        self.delay_s = delay_s

    def generate(self, request):
        return self._run(request)

    async def _run(self, request):
        inp = request.data
        n = min(inp.stops.max_tokens or len(inp.token_ids), len(inp.token_ids))
        for i in range(n):
            await asyncio.sleep(self.delay_s)
            yield LLMEngineOutput(token_ids=[inp.token_ids[i]],
                                  finish_reason=FinishReason.LENGTH if i + 1 == n else None)


@pytest.fixture
def card(tmp_path):
    from tokenizers import Tokenizer, models, pre_tokenizers

    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    vocab = {"<unk>": 0, "hello": 1, "world": 2, "foo": 3, "bar": 4}
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.save(str(tmp_path / "tokenizer.json"))
    return ModelDeploymentCard(name="m", tokenizer_path=str(tmp_path / "tokenizer.json"),
                               context_length=128)


async def _serve(card, admission, fn):
    from dynamo_tpu_torch.llm.engines import build_serving_pipeline
    from dynamo_tpu_torch.llm.http import HttpService, ModelManager

    manager = ModelManager()
    manager.add_model("m", build_serving_pipeline(SlowEcho(0.05), card), card)
    svc = HttpService(manager, port=0, admission=admission)
    await svc.start()
    try:
        async with ClientSession() as s:
            return await fn(s, f"http://127.0.0.1:{svc.port}")
    finally:
        await svc.stop()


BODY = {"model": "m", "prompt": "hello world foo bar", "max_tokens": 4}


def test_http_burst_sheds_over_rate_with_retry_after(card):
    """A burst of six against a bucket of two: four 429s with Retry-After,
    counted per priority; the two admitted are answered in full."""
    admission = AdmissionController(AdmissionConfig(max_concurrent=8, rate_tokens_per_s=0.5,
                                                    burst_tokens=2.0))

    async def fn(s, base):
        async def one(i):
            r = await s.post(f"{base}/v1/completions", json=BODY,
                             headers={"x-tenant": "t", "x-priority": "high" if i % 2 else "low"})
            return r.status, r.headers.get("Retry-After"), await r.json()

        results = await asyncio.gather(*(one(i) for i in range(6)))
        text = await (await s.get(f"{base}/metrics")).text()
        return results, text

    results, text = run(_serve(card, admission, fn))
    shed = [r for r in results if r[0] == 429]
    ok = [r for r in results if r[0] == 200]
    assert len(shed) == 4 and len(ok) == 2
    for _, retry_after, body in shed:
        assert int(retry_after) >= 1 and body["error"]["type"] == "overloaded"
    for _, _, body in ok:
        assert body["choices"][0]["text"].split() == ["hello", "world", "foo", "bar"]
    counted = sum(int(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                  if line.startswith(HM.ADMISSION_SHED_TOTAL + "{"))
    assert counted == 4 == sum(admission.shed_total.values())
    assert f"# TYPE {HM.ADMISSION_SHED_TOTAL} counter" in text
    assert admission.ttft_ewma is not None and admission.admitted_total == 2


def test_http_deadline_shed_by_priority(card):
    """One slot busy: low-priority requests whose estimated wait passes
    their deadline are shed at once, high ones queue and are answered."""
    admission = AdmissionController(AdmissionConfig(
        max_concurrent=1, default_service_s=2.0,
        priorities={"high": PriorityClass("high", 0, max_queue_depth=8, max_wait_s=30.0),
                    "normal": PriorityClass("normal", 1, max_queue_depth=8, max_wait_s=30.0),
                    "low": PriorityClass("low", 2, max_queue_depth=8, max_wait_s=0.25)}))

    async def fn(s, base):
        async def one(priority):
            t0 = time.monotonic()
            r = await s.post(f"{base}/v1/completions", json=BODY, headers={"x-priority": priority})
            return r.status, r.headers.get("Retry-After"), time.monotonic() - t0

        busy = asyncio.ensure_future(one("normal"))
        await asyncio.sleep(0.06)
        results = await asyncio.gather(one("low"), one("low"), one("high"), one("high"))
        text = await (await s.get(f"{base}/metrics")).text()
        return (await busy), results, text

    busy, results, text = run(_serve(card, admission, fn))
    assert busy[0] == 200
    assert [r[0] for r in results] == [429, 429, 200, 200]
    assert all(int(r[1]) >= 1 for r in results[:2])
    assert f'{HM.ADMISSION_SHED_TOTAL}{{model="m",priority="low"}} 2' in text
    assert isinstance(AdmissionRejected("x", 0.2).retry_after_s, int)
