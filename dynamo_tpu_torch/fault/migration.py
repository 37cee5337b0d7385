"""Mid-stream request migration (reference: lib/llm/src/migration.rs).

A copy of the JAX package's ``fault/migration.py``.

A stream interrupted by worker death is not an error the user should
see: the tokens generated so far are re-seeded into the prompt and the
request re-dispatched onto a surviving instance, which continues decoding
from exactly where the dead worker stopped.  Semantics carried over from
the reference:

  * ``migration_limit`` — bounded re-dispatches per request (default 3);
  * per-request opt-out — ``ctx.annotations["migration_limit"] = 0``
    (the HTTP frontend maps an ``x-migration-limit`` request header here);
  * the response is marked — ``ctx.annotations["migrations"]`` counts
    hops, surfaced as ``x-migrated`` by the HTTP layer;
  * connect-time failures (nothing emitted yet) retry with jittered
    backoff without burning migration budget.

The wrapper is a plain AsyncEngine over BackendInput → LLMEngineOutput,
so it slots into build_serving_pipeline wherever a bare distributed
Client would.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import random as _random
from typing import Any, AsyncIterator, Callable, Optional

from dynamo_tpu_torch.fault.counters import counters
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context

log = logging.getLogger("dynamo_tpu_torch.fault")

__all__ = ["MigratingClient", "MigrationExhausted"]

# stream failures worth moving the request for: transport loss
# (EndpointDisconnected et al.) and remote `error` frames (RuntimeError) —
# a worker mid-crash often reports one before the socket dies
_MIGRATABLE = (ConnectionError, RuntimeError, KeyError)


class MigrationExhausted(ConnectionError):
    """Every re-dispatch attempt failed within the migration budget."""


class MigratingClient(AsyncEngine):
    """Fault-tolerant wrapper over a ``runtime.distributed.Client``.

    ``pick`` defaults to the client's suspect-aware random pick; pass a
    callable ``(exclude_ids) -> instance_id`` to integrate an external
    router decision (e.g. the KV-aware scheduler re-querying on failure).
    """

    def __init__(
        self,
        client,
        migration_limit: int = 3,
        connect_retries: int = 3,
        backoff_s: float = 0.05,
        backoff_max_s: float = 1.0,
        rng: Optional[_random.Random] = None,
        pick: Optional[Callable[[set], int]] = None,
    ):
        self.client = client
        self.migration_limit = migration_limit
        self.connect_retries = connect_retries
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self._rng = rng or _random.Random()
        self._pick = pick

    # ------------------------------------------------------------- internals
    def _limit_for(self, ctx: Context) -> int:
        limit = ctx.annotations.get("migration_limit")
        if limit is None:
            ann = getattr(ctx.data, "annotations", None)
            if isinstance(ann, dict):
                limit = ann.get("migration_limit")
        return self.migration_limit if limit is None else max(0, int(limit))

    @staticmethod
    def _reseedable(payload: Any) -> bool:
        return dataclasses.is_dataclass(payload) and hasattr(payload, "token_ids") \
            and hasattr(payload, "stops")

    @staticmethod
    def _reseed(payload: Any, emitted: list[int]) -> Any:
        """Original prompt + tokens already generated = the new prompt;
        max_tokens shrinks by what the user already received."""
        stops = payload.stops
        if stops.max_tokens is not None:
            stops = dataclasses.replace(
                stops, max_tokens=max(1, stops.max_tokens - len(emitted)))
        return dataclasses.replace(
            payload,
            token_ids=list(payload.token_ids) + list(emitted),
            stops=stops,
        )

    async def _backoff(self, attempt: int) -> None:
        base = min(self.backoff_max_s, self.backoff_s * (2 ** attempt))
        # full jitter: desynchronize a thundering herd of retrying requests
        await asyncio.sleep(base * (0.5 + self._rng.random() / 2))

    def _choose(self, exclude: set) -> int:
        if self._pick is not None:
            return self._pick(exclude)
        return self.client.pick_random(exclude=exclude)

    # --------------------------------------------------------------- generate
    def generate(self, request: Context) -> AsyncIterator[Any]:
        return self._run(request)

    async def _run(self, ctx: Context) -> AsyncIterator[Any]:
        limit = self._limit_for(ctx)
        payload = ctx.data
        emitted: list[int] = []
        failed: set[int] = set()
        migrations = 0
        connects = 0
        while True:
            if not self.client.instance_ids():
                # transient empty window (boot, watch replay) — same grace
                # the plain routed stream gives discovery
                await self.client._wait_until(
                    lambda: self.client._instances, 3.0)
            try:
                iid = self._choose(failed)
            except (RuntimeError, LookupError) as e:
                if connects + migrations >= self.connect_retries + limit:
                    raise MigrationExhausted(
                        f"no live instance of {self.client.endpoint.url} "
                        f"after {connects + migrations} attempts") from e
                connects += 1
                await self._backoff(connects)
                continue
            sub = ctx.map(self._reseed(payload, emitted)
                          if emitted else payload)
            got_this_hop = False
            try:
                async for item in self.client.direct(sub, iid):
                    toks = getattr(item, "token_ids", None)
                    if toks:
                        emitted.extend(toks)
                        got_this_hop = True
                    yield item
                return
            except _MIGRATABLE as e:
                if ctx.is_stopped or ctx.is_killed:
                    return  # the caller cancelled; nothing to save
                failed.add(iid)
                if not emitted:
                    # nothing delivered yet: plain connect retry, own budget
                    if connects >= self.connect_retries:
                        raise MigrationExhausted(
                            f"{self.client.endpoint.url}: connect failed "
                            f"{connects + 1}x") from e
                    connects += 1
                    log.info("connect retry %d/%d for %s after %r",
                             connects, self.connect_retries, ctx.id[:8], e)
                    await self._backoff(connects)
                    continue
                if not self._reseedable(payload):
                    raise  # can't rebuild the prompt — surface the loss
                if migrations >= limit:
                    raise MigrationExhausted(
                        f"request {ctx.id[:8]} exceeded migration_limit="
                        f"{limit} ({len(emitted)} tokens salvaged)") from e
                migrations += 1
                ctx.annotations["migrations"] = migrations
                counters.migrations_total += 1
                log.warning(
                    "migrating %s off instance %x (%d tokens re-seeded, "
                    "hop %d/%d): %r", ctx.id[:8], iid, len(emitted),
                    migrations, limit, e)
                if not got_this_hop:
                    # two dead hops in a row without progress: back off so
                    # a flapping pool doesn't spin the request red-hot
                    await self._backoff(migrations)
