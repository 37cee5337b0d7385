"""Conditional disaggregation router — local vs remote prefill decision.

A copy of the JAX package's ``llm/disagg_router.py`` (the same coordinator
key and value, so either package's workers read the other's published
thresholds).

Reference parity: lib/llm/src/disagg_router.rs (DisaggregatedRouter,
decision `prefill_length − prefix_hit_length > max_local_prefill_length`
at :236-244) and examples/llm/components/disagg_router.py (queue-size
guard).  The config hot-reloads from a coordinator watch, mirroring
DisaggRouterConf::from_etcd_with_watcher (disagg_router.rs:37-140).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

log = logging.getLogger("dynamo_tpu_torch.disagg_router")

__all__ = ["DisaggRouterConf", "DisaggregatedRouter", "CONF_KEY"]

CONF_KEY = "disagg_router_conf"  # under {namespace}/


@dataclass
class DisaggRouterConf:
    # prompts whose non-cached remainder exceeds this go to a prefill worker
    max_local_prefill_length: int = 512
    # but never when the prefill queue is already this deep (backpressure)
    max_prefill_queue_size: int = 16
    # ... nor when the KV handoff itself would cost more wall-clock than
    # this (NetKV-style transfer-cost term: the predicted cost_s() of
    # moving the request's KV from prefill to decode — obs/costs.py EWMA,
    # topology prior on cold edges).  inf = transfer cost never vetoes.
    max_transfer_cost_s: float = float("inf")


class DisaggregatedRouter:
    def __init__(self, conf: Optional[DisaggRouterConf] = None, namespace: str = "default"):
        self.conf = conf or DisaggRouterConf()
        self.namespace = namespace
        self._watch_id: Optional[int] = None

    def prefill_remote(
        self,
        prefill_length: int,
        prefix_hit_length: int,
        queue_size: int = 0,
        transfer_cost_s: float = 0.0,
    ) -> bool:
        """True = enqueue remote prefill; False = prefill locally.

        ``transfer_cost_s`` is the predicted seconds to move this
        request's KV from the prefill worker into this decode engine
        over the CHEAPEST handoff path (stream colocated or over TCP vs
        persist-tier restore — llm/kv/stream.py ``choose_handoff_path``);
        a remote prefill whose handoff costs more than
        ``max_transfer_cost_s`` stays local, because the transfer would
        eat the TTFT the remote prefill was supposed to save."""
        return (
            prefill_length - prefix_hit_length > self.conf.max_local_prefill_length
            and queue_size < self.conf.max_prefill_queue_size
            and transfer_cost_s <= self.conf.max_transfer_cost_s
        )

    # ------------------------------------------------------ dynamic config
    def _key(self) -> str:
        return f"{self.namespace}/{CONF_KEY}"

    async def watch(self, coordinator) -> None:
        """Hot-reload the thresholds from the coordinator KV plane."""

        def on_event(event: str, key: str, value) -> None:
            if event == "put" and isinstance(value, dict):
                self.conf = DisaggRouterConf(
                    max_local_prefill_length=int(
                        value.get("max_local_prefill_length", self.conf.max_local_prefill_length)
                    ),
                    max_prefill_queue_size=int(
                        value.get("max_prefill_queue_size", self.conf.max_prefill_queue_size)
                    ),
                    max_transfer_cost_s=float(
                        value.get("max_transfer_cost_s", self.conf.max_transfer_cost_s)
                    ),
                )
                log.info("disagg router conf updated: %s", self.conf)

        self._watch_id, snapshot = await coordinator.watch(self._key(), on_event)
        if self._key() in snapshot:
            on_event("put", self._key(), snapshot[self._key()])

    async def publish(self, coordinator, conf: DisaggRouterConf) -> None:
        """Write new thresholds for every watching worker to pick up."""
        await coordinator.kv_put(
            self._key(),
            {
                "max_local_prefill_length": conf.max_local_prefill_length,
                "max_prefill_queue_size": conf.max_prefill_queue_size,
                "max_transfer_cost_s": conf.max_transfer_cost_s,
            },
        )
