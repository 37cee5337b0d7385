"""Consistent-hash session affinity across stateless HTTP frontends.

A copy of the JAX package's ``llm/http/affinity.py`` on the port's ring
and coordinator: both packages' frontends reach the same decisions for
the same members and keys, and read each other's persist-affinity records.

N frontends terminate streams; a multi-turn session is cheapest on the
frontend/router pair whose persist tier already holds the session's
prefix blocks.  The ring (utils/chash.py) maps a session key to its
owning frontend deterministically — every frontend computes the same
answer, so no shared state is needed on the hot path, and one frontend
restart moves only the ~1/N of sessions that hashed to it.

On an **affinity miss** — the ring's owner is not the frontend whose
persist tier is warm (typical after a membership change re-mapped the
session) — the content-addressed persist index is the cross-replica
source of truth: every frontend records "I served this session prefix"
under the xxh3 digest of the session key, and the resolver prefers that
recorded holder over the ring's cold answer.  `CoordAffinityIndex`
stores the records in the coordinator KV plane; `LocalAffinityIndex`
is the in-process equivalent for tests and single-host runs.

The decision surfaces as headers — ``x-affinity-owner`` on every
response carrying a session, plus an optional 307 redirect to the
owner's base URL when ``redirect=True`` — so dumb load balancers can
learn the mapping without a config push.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Mapping, Optional

from dynamo_tpu_torch.tokens import compute_hash
from dynamo_tpu_torch.utils.chash import HashRing

__all__ = ["AffinityDecision", "SessionAffinity",
           "LocalAffinityIndex", "CoordAffinityIndex"]


@dataclass
class AffinityDecision:
    session_key: str
    owner: Optional[str]       # frontend id that should serve this session
    is_local: bool             # owner == this frontend
    source: str                # "ring" | "persist" | "none"
    redirect_url: Optional[str] = None


class LocalAffinityIndex:
    """In-process persist-affinity records; share one instance across
    frontends to model the cross-replica index in tests."""

    def __init__(self) -> None:
        self._holders: dict[int, str] = {}

    async def note(self, digest: int, frontend: str) -> None:
        self._holders[digest] = frontend

    async def lookup(self, digest: int) -> Optional[str]:
        return self._holders.get(digest)


class CoordAffinityIndex:
    """Persist-affinity records on the coordinator KV plane, keyed by
    content digest under ``prefix`` — the deployment-grade source of
    truth (same plane the persist replicator already uses)."""

    def __init__(self, coordinator, prefix: str = "/persist_affinity"):
        self.coord = coordinator
        self.prefix = prefix

    def _key(self, digest: int) -> str:
        return f"{self.prefix}/{digest:016x}"

    async def note(self, digest: int, frontend: str) -> None:
        await self.coord.kv_put(self._key(digest), frontend)

    async def lookup(self, digest: int) -> Optional[str]:
        return await self.coord.kv_get(self._key(digest))


class SessionAffinity:
    def __init__(self, self_id: str,
                 frontends: Mapping[str, str] | Iterable[str] = (),
                 persist_index=None, redirect: bool = False):
        self.self_id = self_id
        self.persist_index = persist_index
        self.redirect = redirect
        self._urls: dict[str, str] = {}
        self.ring = HashRing()
        if isinstance(frontends, Mapping):
            for fid, url in frontends.items():
                self.add_frontend(fid, url)
        else:
            for fid in frontends:
                self.add_frontend(fid)
        if self_id not in self.ring:
            self.add_frontend(self_id)

    # ------------------------------------------------------------- membership
    def add_frontend(self, frontend_id: str, base_url: str = "") -> None:
        self.ring.add(frontend_id)
        if base_url:
            self._urls[frontend_id] = base_url

    def remove_frontend(self, frontend_id: str) -> None:
        self.ring.remove(frontend_id)
        self._urls.pop(frontend_id, None)

    # -------------------------------------------------------------- decisions
    @staticmethod
    def digest(session_key: str) -> int:
        return compute_hash(session_key.encode())

    async def resolve(self, session_key: str) -> AffinityDecision:
        owner = self.ring.lookup(session_key)
        source = "ring" if owner else "none"
        if owner != self.self_id and self.persist_index is not None:
            # affinity miss: the ring's answer may be cold (membership
            # changed since the session started) — the recorded warm
            # holder wins if it is still a live frontend
            warm = await self.persist_index.lookup(self.digest(session_key))
            if warm is not None and warm in self.ring:
                owner, source = warm, "persist"
        return AffinityDecision(
            session_key=session_key,
            owner=owner,
            is_local=(owner is None or owner == self.self_id),
            source=source,
            redirect_url=self._urls.get(owner) if owner else None,
        )

    async def note_served(self, session_key: str) -> None:
        """We terminated a turn of this session — our persist tier is
        now the warm one; record it for everyone else's misses."""
        if self.persist_index is not None:
            await self.persist_index.note(self.digest(session_key),
                                          self.self_id)
