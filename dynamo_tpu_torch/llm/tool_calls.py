"""Tool calling: prompt-side rendering + output-side parsing.

The counterpart of ``dynamo_tpu/llm/tool_calls.py``.  Three wire formats
cover the served model families (llama/qwen/mistral/hermes):

  hermes       <tool_call>{"name": ..., "arguments": {...}}</tool_call>
               (Qwen2, Hermes, most chat-template models)
  llama3_json  {"name": ..., "parameters": {...}} as the whole message,
               optionally behind <|python_tag|>, ';'-separated for multiple
  mistral      [TOOL_CALLS] [{...}, ...]

Streaming uses a stop-string-style jail: text is released to the client
until a suffix could begin a tool-call marker, then held until the call
is complete or disproven — so normal content streams, and tool calls are
emitted as a single `tool_calls` delta at the end (what OpenAI clients
handle today).
"""

from __future__ import annotations

import json
import uuid
from typing import Optional

__all__ = ["ToolCallParser", "render_tools_system", "validate_tools"]

HERMES_OPEN = "<tool_call>"
HERMES_CLOSE = "</tool_call>"
MISTRAL_TAG = "[TOOL_CALLS]"
PYTHON_TAG = "<|python_tag|>"

# streaming jail triggers: any of these starting in the pending tail holds
# back emission until resolved
_MARKERS = (HERMES_OPEN, MISTRAL_TAG, PYTHON_TAG)


def validate_tools(tools, tool_choice) -> None:
    """Raise ValueError on malformed tools/tool_choice (caller wraps in
    OpenAIError)."""
    if not isinstance(tools, list) or not tools:
        raise ValueError("'tools' must be a non-empty array")
    for t in tools:
        if not isinstance(t, dict) or t.get("type") != "function":
            raise ValueError("each tool must be {'type': 'function', ...}")
        fn = t.get("function")
        if not isinstance(fn, dict) or not fn.get("name"):
            raise ValueError("each tool needs function.name")
    if tool_choice is not None:
        if isinstance(tool_choice, str):
            if tool_choice not in ("none", "auto", "required"):
                raise ValueError(
                    "'tool_choice' must be none|auto|required or a function ref"
                )
        elif not (
            isinstance(tool_choice, dict)
            and tool_choice.get("type") == "function"
            and isinstance(tool_choice.get("function"), dict)
            and tool_choice["function"].get("name")
        ):
            raise ValueError("'tool_choice' object must name a function")


def render_tools_system(tools: list[dict], tool_choice=None) -> str:
    """System-prompt block teaching a template-less model the hermes
    format — used when the model card's chat template has no native tools
    support.

    tool_choice 'required' / a named function is enforced prompt-side (MUST
    instructions); there is no grammar-level constraint yet, so a
    non-compliant model can still answer in prose."""
    lines = [
        "You have access to the following tools. To call a tool, reply with",
        '<tool_call>{"name": <tool-name>, "arguments": <args-json>}</tool_call>',
        "Available tools:",
    ]
    for t in tools:
        fn = t.get("function", {})
        lines.append(json.dumps(
            {
                "name": fn.get("name"),
                "description": fn.get("description", ""),
                "parameters": fn.get("parameters", {}),
            },
            separators=(",", ":"),
        ))
    if tool_choice == "required":
        lines.append("You MUST call at least one tool before answering.")
    elif isinstance(tool_choice, dict):
        name = tool_choice.get("function", {}).get("name")
        lines.append(
            f"You MUST respond with a call to the tool '{name}' and nothing else."
        )
    return "\n".join(lines)


def _call_id() -> str:
    return f"call_{uuid.uuid4().hex[:24]}"


def _mk_call(name: str, arguments) -> dict:
    if not isinstance(arguments, str):
        arguments = json.dumps(arguments or {}, separators=(",", ":"))
    return {
        "id": _call_id(),
        "type": "function",
        "function": {"name": name, "arguments": arguments},
    }


def _parse_obj(obj) -> Optional[dict]:
    """One tool-call JSON object → OpenAI tool_call dict (None if not one)."""
    if not isinstance(obj, dict) or not obj.get("name"):
        return None
    args = obj.get("arguments", obj.get("parameters", {}))
    return _mk_call(str(obj["name"]), args)


def _parse_json_calls(text: str) -> list[dict]:
    """Parse raw JSON tool calls: a single object, an array of objects, or
    ';'-separated objects (llama3 multi-call)."""
    text = text.strip()
    try:
        data = json.loads(text)
        objs = data if isinstance(data, list) else [data]
        calls = [c for c in (_parse_obj(o) for o in objs) if c]
        return calls
    except json.JSONDecodeError:
        pass
    calls = []
    for part in text.split(";"):
        part = part.strip()
        if not part:
            continue
        try:
            c = _parse_obj(json.loads(part))
        except json.JSONDecodeError:
            return []
        if c is None:
            return []
        calls.append(c)
    return calls


class ToolCallParser:
    """Incremental tool-call extractor over a streamed text channel.

    feed(delta) -> text safe to emit now (may be "");
    finish() -> (remaining_text, tool_calls).

    ``only`` (from a named tool_choice) keeps just calls to that function.
    """

    def __init__(self, fmt: str = "auto", only: Optional[str] = None):
        self.fmt = fmt
        self.only = only
        self._pending = ""       # text withheld from the client
        self._emitted_any = False
        self._jailed = False     # a marker matched: hold everything

    # ------------------------------------------------------------- streaming
    def feed(self, delta: str) -> str:
        self._pending += delta
        if self._jailed:
            return ""
        p = self._pending
        # the whole MESSAGE may be a bare JSON call (llama3): jail only when
        # the message-initial non-space char is '{' or '[' — a brace after
        # emitted prose is ordinary content (JSON-shaped answers must
        # stream, not be eaten as fake tool calls)
        lead = p.lstrip()
        if not self._emitted_any and lead[:1] in ("{", "["):
            self._jailed = True
            return ""
        # full marker anywhere → jail from its start
        for m in _MARKERS:
            at = p.find(m)
            if at >= 0:
                out, self._pending = p[:at], p[at:]
                self._jailed = True
                self._emitted_any = self._emitted_any or bool(out.strip())
                return out
        # hold back a tail that could still become a marker
        hold = 0
        for m in _MARKERS:
            for k in range(min(len(m) - 1, len(p)), 0, -1):
                if p.endswith(m[:k]):
                    hold = max(hold, k)
                    break
        out, self._pending = p[: len(p) - hold], p[len(p) - hold:]
        # whitespace-only output must NOT count as emitted prose: a leading
        # "\n" delta before a bare-JSON llama3 call would otherwise disarm
        # the message-initial jail and stream the call out as content
        self._emitted_any = self._emitted_any or bool(out.strip())
        return out

    # --------------------------------------------------------------- parsing
    def finish(self) -> tuple[str, list[dict]]:
        """Parse whatever is withheld; returns (text_to_flush, tool_calls).

        Text outside the call markup (e.g. prose after the last
        ``</tool_call>``) flushes as content alongside the calls.  When a
        named tool_choice filters every parsed call out, the raw markup is
        dropped — never leaked to the client as content."""
        text = self._pending
        self._pending = ""
        calls, remainder = self._parse(text)
        if calls and self.only:
            calls = [c for c in calls if c["function"]["name"] == self.only]
            return remainder, calls  # markup never leaks, even if all filtered
        if calls:
            return remainder, calls
        return text, []

    def _parse(self, text: str) -> tuple[list[dict], str]:
        """Returns (calls, non-call remainder text)."""
        stripped = text.strip()
        if not stripped:
            return [], ""
        fmt = self.fmt
        if fmt in ("auto", "hermes") and HERMES_OPEN in stripped:
            return self._parse_hermes(text)
        if fmt in ("auto", "mistral") and stripped.startswith(MISTRAL_TAG):
            return _parse_json_calls(stripped[len(MISTRAL_TAG):]), ""
        if fmt in ("auto", "llama3_json"):
            if stripped.startswith(PYTHON_TAG):
                stripped = stripped[len(PYTHON_TAG):].strip()
            if stripped[:1] in ("{", "["):
                return _parse_json_calls(stripped), ""
        return [], ""

    @staticmethod
    def _parse_hermes(text: str) -> tuple[list[dict], str]:
        calls = []
        outside: list[str] = []
        pos = 0
        while True:
            start = text.find(HERMES_OPEN, pos)
            if start < 0:
                outside.append(text[pos:])
                break
            outside.append(text[pos:start])
            end = text.find(HERMES_CLOSE, start)
            body = text[start + len(HERMES_OPEN): end if end >= 0 else None]
            try:
                c = _parse_obj(json.loads(body.strip()))
            except json.JSONDecodeError:
                c = None
            if c:
                calls.append(c)
            if end < 0:
                break
            pos = end + len(HERMES_CLOSE)
        return calls, "".join(outside).strip(" \n") if calls else ""
