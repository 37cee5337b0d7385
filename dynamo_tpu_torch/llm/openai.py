"""OpenAI-compatible protocol: request parsing, response building, SSE.

Covers /v1/chat/completions and /v1/completions (streaming and unary),
including the ``nvext`` extension fields (ignore_eos, annotations), which
are accepted under both "nvext" and "ext" keys.  The counterpart of
``dynamo_tpu/llm/openai.py``: the same validation, messages and bodies.
A ``json_schema`` response format is translated to a schema regex and a
``guided_regex`` is parsed here (``engine/grammar.py``), so a bad pattern
is a 400 rather than an engine error.
"""

from __future__ import annotations

import json
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

from dynamo_tpu_torch.llm.protocols import SamplingOptions, StopConditions


class OpenAIError(Exception):
    def __init__(self, message: str, status: int = 400, err_type: str = "invalid_request_error"):
        super().__init__(message)
        self.status = status
        self.err_type = err_type

    def body(self) -> dict:
        return {"error": {"message": str(self), "type": self.err_type, "code": self.status}}


@dataclass
class ParsedRequest:
    """A validated OpenAI request, engine-ready except for tokenization."""

    model: str
    messages: Optional[list[dict]] = None   # chat mode
    prompt: Optional[str] = None            # completions mode
    prompt_token_ids: Optional[list[int]] = None
    stream: bool = False
    n: int = 1
    sampling: SamplingOptions = field(default_factory=SamplingOptions)
    stops: StopConditions = field(default_factory=StopConditions)
    echo: bool = False
    annotations: list[str] = field(default_factory=list)
    # tool calling (chat mode): validated OpenAI tool schemas + choice
    tools: Optional[list[dict]] = None
    tool_choice: Any = None  # "none"|"auto"|"required"|{function ref}|None
    # response_format: None | "json_object" | "json_schema"; schema kept
    # for prompt injection; enforcement = schema-shaped regex when the
    # schema translates (schema_regex), else the generic JSON grammar
    response_format: Optional[str] = None
    json_schema: Optional[dict] = None
    schema_regex: Optional[str] = None
    raw: dict = field(default_factory=dict)

    @property
    def is_chat(self) -> bool:
        return self.messages is not None

    @property
    def wants_tools(self) -> bool:
        return bool(self.tools) and self.tool_choice != "none"


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise OpenAIError(msg)


def parse_request(body: dict, chat: bool) -> ParsedRequest:
    _require(isinstance(body, dict), "request body must be a JSON object")
    model = body.get("model")
    _require(isinstance(model, str) and model, "'model' is required")

    req = ParsedRequest(model=model, raw=body, stream=bool(body.get("stream", False)))

    if chat:
        messages = body.get("messages")
        _require(isinstance(messages, list) and messages, "'messages' must be a non-empty array")
        for m in messages:
            _require(isinstance(m, dict) and "role" in m, "each message needs a 'role'")
            if m["role"] == "tool":
                _require("tool_call_id" in m, "tool messages need 'tool_call_id'")
        req.messages = messages
        tools = body.get("tools")
        if tools is not None:
            from dynamo_tpu_torch.llm.tool_calls import validate_tools

            try:
                validate_tools(tools, body.get("tool_choice"))
            except ValueError as e:
                raise OpenAIError(str(e))
            req.tools = tools
            req.tool_choice = body.get("tool_choice", "auto")
    else:
        prompt = body.get("prompt")
        _require(prompt is not None, "'prompt' is required")
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            req.prompt_token_ids = prompt
        elif isinstance(prompt, list):
            _require(len(prompt) == 1, "batched prompts not yet supported")
            req.prompt = prompt[0]
        else:
            _require(isinstance(prompt, str), "'prompt' must be a string or token array")
            req.prompt = prompt
        req.echo = bool(body.get("echo", False))

    temperature = body.get("temperature")
    top_p = body.get("top_p")
    top_k = body.get("top_k")  # extension (vLLM-compatible)
    try:  # extension (vLLM-compatible)
        min_p = float(body.get("min_p") or 0.0)
    except (TypeError, ValueError):
        raise OpenAIError("'min_p' must be a number")
    _require(0.0 <= min_p <= 1.0, "'min_p' must be in [0, 1]")
    seed = body.get("seed")
    if seed is not None:
        _require(isinstance(seed, int) and not isinstance(seed, bool)
                 and -(2 ** 63) <= seed < 2 ** 63,
                 "'seed' must be an integer")
    logit_bias = body.get("logit_bias")
    if logit_bias is not None:
        _require(isinstance(logit_bias, dict), "'logit_bias' must be an object")
        _require(len(logit_bias) <= 300, "'logit_bias' supports at most 300 tokens")
        try:
            logit_bias = {int(k): float(v) for k, v in logit_bias.items()}
        except (TypeError, ValueError):
            raise OpenAIError("'logit_bias' keys must be token ids, values numbers")
        _require(all(-100.0 <= v <= 100.0 for v in logit_bias.values()),
                 "'logit_bias' values must be in [-100, 100]")
    freq_pen = float(body.get("frequency_penalty") or 0.0)
    pres_pen = float(body.get("presence_penalty") or 0.0)
    _require(-2.0 <= freq_pen <= 2.0, "'frequency_penalty' must be in [-2, 2]")
    _require(-2.0 <= pres_pen <= 2.0, "'presence_penalty' must be in [-2, 2]")

    # logprobs: chat = bool 'logprobs' + int 'top_logprobs' (0-20);
    # completions = int-or-null 'logprobs' meaning top-N
    if chat:
        want_lp = bool(body.get("logprobs", False))
        top_lp = int(body.get("top_logprobs") or 0)
        _require(0 <= top_lp <= 20, "'top_logprobs' must be in [0, 20]")
        _require(top_lp == 0 or want_lp,
                 "'top_logprobs' requires 'logprobs': true")
    else:
        lp = body.get("logprobs")
        want_lp = lp is not None and lp is not False
        top_lp = int(lp) if isinstance(lp, int) and not isinstance(lp, bool) else 0
        _require(0 <= top_lp <= 20, "'logprobs' must be in [0, 20]")

    # response_format: json_object / json_schema switch the engine to
    # grammar-constrained decoding (engine/grammar.py).  json_object is
    # endpoint-agnostic; json_schema needs a chat transcript to inject the
    # schema instruction into, so it is chat-only.
    rf = body.get("response_format")
    if rf is not None:
        _require(isinstance(rf, dict) and "type" in rf,
                 "'response_format' must be an object with a 'type'")
        rft = rf["type"]
        _require(rft in ("text", "json_object", "json_schema"),
                 "'response_format.type' must be 'text', 'json_object' or "
                 "'json_schema'")
        _require(rft != "json_schema" or chat,
                 "'json_schema' response_format is only supported on chat "
                 "completions")
        if rft == "json_schema":
            js = rf.get("json_schema")
            _require(isinstance(js, dict) and isinstance(js.get("schema"), dict),
                     "'response_format.json_schema.schema' is required")
            req.response_format = rft
            req.json_schema = js
            # enforce the schema's SHAPE when it translates to the bounded
            # regex engine; otherwise the generic JSON grammar and the
            # preprocessor's schema instruction apply
            from dynamo_tpu_torch.engine.grammar import json_schema_to_regex

            req.schema_regex = json_schema_to_regex(js["schema"])
            if req.schema_regex and len(req.schema_regex) > 4096:
                req.schema_regex = None  # generic JSON grammar instead
        elif rft == "json_object":
            req.response_format = rft

    # guided_choice (vLLM-compatible extension): output constrained to
    # exactly one of the given strings (engine/grammar.py choice trie)
    guided_choice = body.get("guided_choice")
    if guided_choice is not None:
        _require(isinstance(guided_choice, list) and guided_choice
                 and all(isinstance(c, str) and c for c in guided_choice),
                 "'guided_choice' must be a non-empty array of strings")
        _require(len(guided_choice) <= 256,
                 "'guided_choice' supports at most 256 choices")
        _require(sum(len(c.encode("utf-8")) for c in guided_choice) <= 4096,
                 "'guided_choice' total length exceeds 4096 bytes")
        _require(rf is None,
                 "'guided_choice' cannot be combined with 'response_format'")

    # guided_regex (vLLM-compatible extension): bounded regex subset,
    # validated up front so syntax errors are 400s, not engine errors
    guided_regex = body.get("guided_regex")
    if guided_regex is not None:
        _require(isinstance(guided_regex, str) and guided_regex,
                 "'guided_regex' must be a non-empty string")
        _require(len(guided_regex) <= 1024,
                 "'guided_regex' exceeds 1024 chars")
        _require(rf is None and guided_choice is None,
                 "'guided_regex' cannot be combined with 'response_format' "
                 "or 'guided_choice'")
        from dynamo_tpu_torch.engine.grammar import RegexError, _parse_regex

        try:
            _parse_regex(guided_regex)
        except RegexError as e:
            raise OpenAIError(f"'guided_regex': {e}")

    req.sampling = SamplingOptions(
        temperature=1.0 if temperature is None else float(temperature),
        top_p=1.0 if top_p is None else float(top_p),
        top_k=0 if top_k is None else int(top_k),
        min_p=min_p,
        logit_bias=logit_bias or None,
        guided_choice=guided_choice,
        guided_regex=guided_regex or req.schema_regex,
        seed=seed,
        frequency_penalty=freq_pen,
        presence_penalty=pres_pen,
        logprobs=want_lp,
        top_logprobs=top_lp,
        # json_mode stays set alongside a schema regex: the engine prefers
        # the regex grammar and falls back to generic JSON if its DFA
        # exceeds the cap
        json_mode=req.response_format is not None,
    )

    max_tokens = body.get("max_completion_tokens", body.get("max_tokens"))
    stop = body.get("stop") or []
    if isinstance(stop, str):
        stop = [stop]
    _require(isinstance(stop, list), "'stop' must be a string or array")
    req.stops = StopConditions(
        max_tokens=int(max_tokens) if max_tokens is not None else 16 if not chat else None,
        stop=[s for s in stop if s],
        min_tokens=int(body.get("min_tokens", 0)),
    )

    ext = body.get("nvext") or body.get("ext") or {}
    if isinstance(ext, dict):
        req.stops.ignore_eos = bool(ext.get("ignore_eos", body.get("ignore_eos", False)))
        ann = ext.get("annotations", [])
        if isinstance(ann, list):
            req.annotations = ann

    n = int(body.get("n", 1))
    _require(1 <= n <= 16, "'n' must be in [1, 16]")
    req.n = n
    return req


# --------------------------------------------------------------------- builders

def _now() -> int:
    return int(time.time())


def new_id(prefix: str) -> str:
    return f"{prefix}-{uuid.uuid4().hex}"


def chat_chunk(
    rid: str, model: str, *, role: Optional[str] = None, content: Optional[str] = None,
    finish_reason: Optional[str] = None, usage: Optional[dict] = None,
    index: int = 0, logprobs: Optional[dict] = None,
    tool_calls: Optional[list[dict]] = None,
) -> dict:
    delta: dict[str, Any] = {}
    if role is not None:
        delta["role"] = role
    if content:
        delta["content"] = content
    if tool_calls:
        delta["tool_calls"] = [
            {"index": i, **c} for i, c in enumerate(tool_calls)
        ]
    choice: dict[str, Any] = {
        "index": index, "delta": delta, "finish_reason": finish_reason,
    }
    if logprobs is not None:
        choice["logprobs"] = logprobs
    out = {
        "id": rid,
        "object": "chat.completion.chunk",
        "created": _now(),
        "model": model,
        "choices": [choice],
    }
    if usage is not None:
        out["usage"] = usage
    return out


def chat_response(
    rid: str, model: str, content: str, finish_reason: str, usage: dict,
    *, index: int = 0, logprobs: Optional[dict] = None,
    tool_calls: Optional[list[dict]] = None,
) -> dict:
    message: dict[str, Any] = {"role": "assistant", "content": content}
    if tool_calls:
        message["content"] = content or None  # OpenAI: null content on calls
        message["tool_calls"] = tool_calls
    choice: dict[str, Any] = {
        "index": index,
        "message": message,
        "finish_reason": finish_reason,
    }
    if logprobs is not None:
        choice["logprobs"] = logprobs
    return {
        "id": rid,
        "object": "chat.completion",
        "created": _now(),
        "model": model,
        "choices": [choice],
        "usage": usage,
    }


def completion_chunk(
    rid: str, model: str, text: str, finish_reason: Optional[str] = None,
    usage: Optional[dict] = None, *, index: int = 0,
    logprobs: Optional[dict] = None,
) -> dict:
    choice: dict[str, Any] = {
        "index": index, "text": text, "finish_reason": finish_reason,
    }
    if logprobs is not None:
        choice["logprobs"] = logprobs
    out = {
        "id": rid,
        "object": "text_completion",
        "created": _now(),
        "model": model,
        "choices": [choice],
    }
    if usage is not None:
        out["usage"] = usage
    return out


def completion_response(
    rid: str, model: str, text: str, finish_reason: str, usage: dict,
    *, index: int = 0, logprobs: Optional[dict] = None,
) -> dict:
    choice: dict[str, Any] = {
        "index": index, "text": text, "finish_reason": finish_reason,
    }
    if logprobs is not None:
        choice["logprobs"] = logprobs
    return {
        "id": rid,
        "object": "text_completion",
        "created": _now(),
        "model": model,
        "choices": [choice],
        "usage": usage,
    }


def chat_logprobs_block(content: list[dict]) -> dict:
    """Chat-format logprobs: {"content": [{token, logprob, bytes,
    top_logprobs: [...]}]} — entries come from Backend detokenization."""
    return {"content": content}


def completion_logprobs_block(
    content: list[dict], text_offset_base: int = 0
) -> dict:
    """Completions-format logprobs: parallel arrays (tokens, token_logprobs,
    top_logprobs, text_offset) built from the same Backend entries."""
    tokens, lps, tops, offsets = [], [], [], []
    off = text_offset_base
    for e in content:
        tokens.append(e["token"])
        lps.append(e["logprob"])
        tops.append({t["token"]: t["logprob"] for t in e.get("top_logprobs", [])} or None)
        offsets.append(off)
        off += len(e["token"])
    return {
        "tokens": tokens,
        "token_logprobs": lps,
        "top_logprobs": tops,
        "text_offset": offsets,
    }


def usage_dict(prompt_tokens: int, completion_tokens: int) -> dict:
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }


def sse_encode(data: dict | str) -> bytes:
    if isinstance(data, dict):
        data = json.dumps(data, separators=(",", ":"))
    return f"data: {data}\n\n".encode()


SSE_DONE = b"data: [DONE]\n\n"
