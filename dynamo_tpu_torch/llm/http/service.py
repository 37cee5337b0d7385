"""The OpenAI-compatible HTTP service (aiohttp).

The counterpart of ``dynamo_tpu/llm/http/service.py``, with the same routes,
bodies and SSE framing:

  POST /v1/chat/completions   — streaming (SSE) and unary, n > 1, logprobs, tools
  POST /v1/completions        — streaming (SSE) and unary, n > 1, logprobs
  GET  /v1/models
  GET  /metrics               — Prometheus text format
  GET  /health, /live, /ready

A caller's ``x-request-id`` becomes the engine-side request id and is
echoed on the response.  Models are served through a ModelManager registry.
Client disconnects kill the request context so engines stop generating.
Tracing spans and ``/debug/traces``, admission control, session affinity
and mid-stream migration are not ported yet.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
from dataclasses import dataclass
from typing import AsyncIterator, Optional

from aiohttp import web

from dynamo_tpu_torch.llm.http.metrics import Metrics
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.openai import (
    SSE_DONE,
    OpenAIError,
    chat_chunk,
    chat_logprobs_block,
    chat_response,
    completion_chunk,
    completion_logprobs_block,
    completion_response,
    new_id,
    parse_request,
    sse_encode,
    usage_dict,
)
from dynamo_tpu_torch.llm.protocols import FinishReason, LLMEngineOutput
from dynamo_tpu_torch.llm.tool_calls import ToolCallParser
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context

log = logging.getLogger("dynamo_tpu_torch.http")

__all__ = ["ModelManager", "HttpService"]


def _tool_parser(parsed) -> ToolCallParser:
    """Parser honoring a named tool_choice (only that function's calls)."""
    only = None
    if isinstance(parsed.tool_choice, dict):
        only = parsed.tool_choice.get("function", {}).get("name")
    return ToolCallParser(only=only)


@dataclass
class ModelEntry:
    card: ModelDeploymentCard
    engine: AsyncEngine  # full pipeline: Context[ParsedRequest] → LLMEngineOutput(text)


class ModelManager:
    """Registry of served models."""

    def __init__(self) -> None:
        self._models: dict[str, ModelEntry] = {}

    def add_model(self, name: str, engine: AsyncEngine, card: Optional[ModelDeploymentCard] = None) -> None:
        self._models[name] = ModelEntry(card or ModelDeploymentCard(name=name), engine)

    def get(self, name: str) -> ModelEntry:
        entry = self._models.get(name)
        if entry is None:
            raise OpenAIError(f"model '{name}' not found", status=404, err_type="model_not_found")
        return entry

    def list_models(self) -> list[str]:
        return sorted(self._models)


class HttpService:
    def __init__(self, manager: Optional[ModelManager] = None, host: str = "127.0.0.1",
                 port: int = 8080, core=None):
        """``core``: the EngineCore behind the served model, whose counters
        ``/metrics`` renders (None renders them as zeros)."""
        self.manager = manager or ModelManager()
        self.metrics = Metrics(core)
        self.host = host
        self.port = port
        self._runner: Optional[web.AppRunner] = None
        self.app = web.Application()
        self.app.router.add_post("/v1/chat/completions", self._chat)
        self.app.router.add_post("/v1/completions", self._completions)
        self.app.router.add_get("/v1/models", self._models)
        self.app.router.add_get("/metrics", self._metrics)
        for p in ("/health", "/live", "/ready"):
            self.app.router.add_get(p, self._health)

    # ------------------------------------------------------------- lifecycle
    async def start(self) -> None:
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        # resolve ephemeral port
        for s in self._runner.sites:
            server = getattr(s, "_server", None)
            if server and server.sockets:
                self.port = server.sockets[0].getsockname()[1]
        log.info("http service listening on %s:%s", self.host, self.port)

    async def stop(self) -> None:
        if self._runner:
            await self._runner.cleanup()

    # --------------------------------------------------------------- handlers
    async def _health(self, request: web.Request) -> web.Response:
        return web.json_response({"status": "ok", "models": self.manager.list_models()})

    async def _models(self, request: web.Request) -> web.Response:
        return web.json_response(
            {
                "object": "list",
                "data": [
                    {"id": m, "object": "model", "owned_by": "dynamo_tpu"}
                    for m in self.manager.list_models()
                ],
            }
        )

    async def _metrics(self, request: web.Request) -> web.Response:
        return web.Response(text=self.metrics.render(), content_type="text/plain")

    async def _chat(self, request: web.Request) -> web.StreamResponse:
        return await self._serve(request, chat=True)

    async def _completions(self, request: web.Request) -> web.StreamResponse:
        return await self._serve(request, chat=False)

    async def _serve(self, request: web.Request, chat: bool) -> web.StreamResponse:
        endpoint = "chat_completions" if chat else "completions"
        try:
            body = await request.json()
        except json.JSONDecodeError:
            err = OpenAIError("invalid JSON body")
            return web.json_response(err.body(), status=err.status)

        guard = None
        # client-supplied correlation id: accepted, propagated as the
        # engine-side request id, and echoed back on every response
        xrid = request.headers.get("x-request-id") or ""
        try:
            parsed = parse_request(body, chat=chat)
            entry = self.manager.get(parsed.model)
            guard = self.metrics.guard(parsed.model, endpoint)
            rid = new_id("chatcmpl" if chat else "cmpl")
            # n>1: independent generations of the same prompt; the engine's
            # reserved-block registry lets them share one prefill
            if parsed.n > 1 and parsed.sampling.seed is not None:
                # per-choice seeds: one seed would make all n choices identical
                variants = [
                    dataclasses.replace(parsed, sampling=dataclasses.replace(
                        parsed.sampling, seed=parsed.sampling.seed + i))
                    for i in range(parsed.n)
                ]
                ctxs = [Context(v) for v in variants]
            else:
                ctxs = [Context(parsed) for _ in range(parsed.n)]
            if xrid:
                # the caller's id becomes the engine-visible request id
                # (choice-suffixed for n>1 so ids stay unique)
                for i, c in enumerate(ctxs):
                    c.id = xrid if parsed.n == 1 else f"{xrid}-{i}"
            streams = [entry.engine.generate(c) for c in ctxs]
            if parsed.stream:
                return await self._stream_response(
                    request, ctxs, streams, rid, parsed, chat, guard, xrid=xrid)
            return await self._unary_response(ctxs, streams, rid, parsed, chat, guard, xrid=xrid)
        except OpenAIError as e:
            if guard:
                guard.status("error")
            return web.json_response(e.body(), status=e.status)
        except Exception:
            log.exception("request failed")
            err = OpenAIError("internal error", status=500, err_type="internal_error")
            return web.json_response(err.body(), status=err.status)
        finally:
            if guard:
                guard.close()

    # ------------------------------------------------------------- responders
    def _chunk(
        self, rid: str, parsed, chat: bool, out: LLMEngineOutput, index: int,
        text_off: int, finish_override: Optional[str] = None,
    ) -> list[dict]:
        finish = finish_override or (
            out.finish_reason.as_openai() if out.finish_reason else None
        )
        # logprob entries must flow even when the stop-string jail withholds
        # text (the entry's token was still produced this delta)
        if not (out.text or finish or out.logprob_content):
            return []
        lp_block = None
        if out.logprob_content:
            lp_block = (
                chat_logprobs_block(out.logprob_content)
                if chat
                else completion_logprobs_block(out.logprob_content, text_off)
            )
        if chat:
            return [chat_chunk(rid, parsed.model, content=out.text or "",
                               finish_reason=finish, index=index,
                               logprobs=lp_block)]
        return [completion_chunk(rid, parsed.model, out.text or "",
                                 finish_reason=finish, index=index,
                                 logprobs=lp_block)]

    async def _stream_response(
        self, request: web.Request, ctxs: list[Context],
        streams: list[AsyncIterator[LLMEngineOutput]],
        rid: str, parsed, chat: bool, guard, xrid: str = "",
    ) -> web.StreamResponse:
        headers = {
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive",
        }
        if xrid:
            headers["x-request-id"] = xrid
        resp = web.StreamResponse(headers=headers)
        await resp.prepare(request)
        n = len(streams)
        n_out = 0
        text_off = [0] * n
        # bounded: the pumps' `await put()` applies backpressure to the
        # engine streams when the SSE writer (the client's socket) is slow
        merged: asyncio.Queue = asyncio.Queue(maxsize=max(16, 4 * n))

        async def pump(i: int, s: AsyncIterator[LLMEngineOutput]) -> None:
            try:
                async for out in s:
                    await merged.put((i, out))
                    if out.finished:
                        break
            except Exception:  # surface engine errors as a finish
                log.exception("choice %d stream failed", i)
                await merged.put((i, LLMEngineOutput(finish_reason=FinishReason.ERROR)))
            finally:
                await merged.put((i, None))

        tasks = [asyncio.ensure_future(pump(i, s)) for i, s in enumerate(streams)]
        # tool-call extraction per choice: stream content through the jail,
        # emit parsed calls as one tool_calls delta at finish
        parsers = [
            _tool_parser(parsed) if chat and parsed.wants_tools else None
            for _ in range(n)
        ]
        try:
            if chat:
                for i in range(n):
                    await resp.write(sse_encode(
                        chat_chunk(rid, parsed.model, role="assistant", content="", index=i)
                    ))
            live = n
            while live:
                i, out = await merged.get()
                if out is None:
                    live -= 1
                    continue
                if out.token_ids:
                    guard.tokens(len(out.token_ids))
                n_out += len(out.token_ids)
                finish_override = None
                if parsers[i] is not None:
                    visible = parsers[i].feed(out.text or "")
                    if out.finish_reason is not None:
                        leftover, calls = parsers[i].finish()
                        # leftover = non-call prose (flushed either way)
                        out.text = visible + leftover
                        if calls:
                            finish_override = "tool_calls"
                            await resp.write(sse_encode(chat_chunk(
                                rid, parsed.model, tool_calls=calls, index=i
                            )))
                    else:
                        out.text = visible
                for chunk in self._chunk(rid, parsed, chat, out, i, text_off[i], finish_override):
                    await resp.write(sse_encode(chunk))
                text_off[i] += len(out.text or "")
            usage = usage_dict(ctxs[0].annotations.get("prompt_tokens", 0), n_out)
            if chat:
                await resp.write(sse_encode(chat_chunk(rid, parsed.model, usage=usage)))
            await resp.write(SSE_DONE)
            guard.ok()
            self.metrics.tokens_out[parsed.model] += n_out
            self._observe_queue_wait(parsed.model, ctxs)
        except (ConnectionResetError, asyncio.CancelledError):
            # client went away — stop the engine
            for ctx in ctxs:
                ctx.kill()
            guard.status("disconnect")
        finally:
            for t in tasks:
                if not t.done():
                    t.cancel()
        await resp.write_eof()
        return resp

    def _observe_queue_wait(self, model: str, ctxs: list[Context]) -> None:
        for c in ctxs:
            qw = c.annotations.get("queue_wait_s")
            if qw is not None:
                self.metrics.queue_wait[model].observe(qw)

    async def _unary_response(
        self, ctxs: list[Context], streams: list[AsyncIterator[LLMEngineOutput]],
        rid: str, parsed, chat: bool, guard, xrid: str = "",
    ) -> web.Response:
        n = len(streams)
        texts: list[list[str]] = [[] for _ in range(n)]
        lp_entries: list[list[dict]] = [[] for _ in range(n)]
        finishes = [FinishReason.STOP] * n
        counts = [0] * n

        async def collect(i: int, s: AsyncIterator[LLMEngineOutput]) -> None:
            async for out in s:
                if out.token_ids:
                    guard.tokens(len(out.token_ids))
                counts[i] += len(out.token_ids)
                if out.text:
                    texts[i].append(out.text)
                if out.logprob_content:
                    lp_entries[i].extend(out.logprob_content)
                if out.finish_reason:
                    finishes[i] = out.finish_reason
                if out.finished:
                    break

        try:
            await asyncio.gather(*(collect(i, s) for i, s in enumerate(streams)))
        except asyncio.CancelledError:
            # client dropped the connection mid-generation — free the slots
            for ctx in ctxs:
                ctx.kill()
            guard.status("disconnect")
            raise
        n_out = sum(counts)
        usage = usage_dict(ctxs[0].annotations.get("prompt_tokens", 0), n_out)
        resp: Optional[dict] = None
        for i in range(n):
            text = "".join(texts[i])
            calls = None
            finish = finishes[i].as_openai()
            if chat and parsed.wants_tools:
                p = _tool_parser(parsed)
                visible = p.feed(text)
                leftover, calls = p.finish()
                text = visible + leftover
                if calls:
                    finish = "tool_calls"
            lp_block = None
            if lp_entries[i]:
                lp_block = (
                    chat_logprobs_block(lp_entries[i]) if chat
                    else completion_logprobs_block(lp_entries[i])
                )
            piece = (
                chat_response(rid, parsed.model, text, finish, usage,
                              index=i, logprobs=lp_block, tool_calls=calls)
                if chat else
                completion_response(rid, parsed.model, text,
                                    finishes[i].as_openai(), usage,
                                    index=i, logprobs=lp_block)
            )
            if resp is None:
                resp = piece
            else:
                resp["choices"].extend(piece["choices"])
        guard.ok()
        self.metrics.tokens_out[parsed.model] += n_out
        self._observe_queue_wait(parsed.model, ctxs)
        headers = {"x-request-id": xrid} if xrid else None
        return web.json_response(resp, headers=headers)
