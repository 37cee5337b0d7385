"""OpenAIPreprocessor — OpenAI request → BackendInput (tokens + config).

Renders the model's chat template (jinja), tokenizes with the model card's
tokenizer, applies stop-condition and sampling defaults, and records
annotations (formatted_prompt, token_ids) on the request context.  The
counterpart of ``dynamo_tpu/llm/preprocessor.py``: the same template
environment, BOS probe and tool-prompt injection, so both packages give
the same token ids for the same request.
"""

from __future__ import annotations

import json
from typing import Optional

from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.openai import OpenAIError, ParsedRequest
from dynamo_tpu_torch.llm.protocols import BackendInput
from dynamo_tpu_torch.llm.tokenizer import TokenizerWrapper
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.pipeline import Operator

__all__ = ["OpenAIPreprocessor", "PromptFormatter"]

# a minimal fallback template for models that ship none (role-tagged lines)
DEFAULT_CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "<|{{ message['role'] }}|> {{ message['content'] }}\n"
    "{% endfor %}"
    "<|assistant|>"
)


class PromptFormatter:
    """Jinja chat-template renderer."""

    def __init__(self, template: Optional[str], bos_token: str = "", eos_token: str = ""):
        import jinja2
        from jinja2 import meta

        env = jinja2.Environment(trim_blocks=True, lstrip_blocks=True)
        env.globals["raise_exception"] = self._raise
        src = template or DEFAULT_CHAT_TEMPLATE
        self._template = env.from_string(src)
        # does the template actually consume a `tools` variable?  (A
        # substring probe misfires on templates merely mentioning the word;
        # the AST check is exact.)
        try:
            free = meta.find_undeclared_variables(env.parse(src))
            self.supports_tools = "tools" in free
        except Exception:
            self.supports_tools = False
        self._bos = bos_token
        self._eos = eos_token
        # Templates that emit BOS themselves must not ALSO get the
        # tokenizer's special-token insertion (double-BOS corrupts real
        # models).  Decided by a probe RENDER, not source inspection — a
        # substring test would misfire on '<s>' inside a hardcoded
        # '</s>', and a bare variable reference with an EMPTY bos string
        # renders nothing (the tokenizer must then keep inserting BOS).
        self.renders_bos = False
        if bos_token:
            sentinel = "\x00BOS\x00"
            try:
                probe = self._template.render(
                    messages=[{"role": "user", "content": "x"}],
                    add_generation_prompt=True,
                    bos_token=sentinel, eos_token=eos_token, tools=None,
                )
                self.renders_bos = (sentinel in probe
                                    or probe.startswith(bos_token))
            except Exception:
                pass  # template needs richer inputs: keep tokenizer BOS

    @staticmethod
    def _raise(msg: str):
        raise OpenAIError(f"chat template error: {msg}")

    def render(
        self,
        messages: list[dict],
        add_generation_prompt: bool = True,
        tools: Optional[list[dict]] = None,
    ) -> str:
        return self._template.render(
            messages=messages,
            add_generation_prompt=add_generation_prompt,
            bos_token=self._bos,
            eos_token=self._eos,
            tools=tools,
        )


class OpenAIPreprocessor(Operator):
    """Pipeline operator: Context[ParsedRequest] → Context[BackendInput]."""

    def __init__(self, card: ModelDeploymentCard, tokenizer: Optional[TokenizerWrapper] = None):
        self.card = card
        if tokenizer is None:
            if card.tokenizer_path is None:
                raise ValueError(f"model card {card.name} has no tokenizer")
            tokenizer = TokenizerWrapper.from_file(card.tokenizer_path)
        self.tokenizer = tokenizer
        # token STRINGS reach the template: real templates interpolate
        # {{ bos_token }}/{{ eos_token }}.  Card strings (from
        # tokenizer_config.json) win; ids resolve through the tokenizer
        # as fallback (GGUF cards carry only ids)
        bos = card.bos_token
        if bos is None and card.bos_token_id is not None:
            bos = self.tokenizer.id_to_token(card.bos_token_id)
        eos = card.eos_token
        if eos is None and card.eos_token_ids:
            eos = self.tokenizer.id_to_token(card.eos_token_ids[0])
        self.formatter = PromptFormatter(
            card.chat_template, bos_token=bos or "", eos_token=eos or "")

    async def forward(self, request: Context[ParsedRequest]) -> Context[BackendInput]:
        parsed = request.data
        if parsed.is_chat:
            messages = parsed.messages
            tools = parsed.tools if parsed.wants_tools else None
            if tools and not self.formatter.supports_tools:
                # template has no native tools support: inject a hermes-
                # format instruction block as a leading system message
                from dynamo_tpu_torch.llm.tool_calls import render_tools_system

                messages = [
                    {
                        "role": "system",
                        "content": render_tools_system(
                            tools, parsed.tool_choice
                        ),
                    }
                ] + list(messages)
                tools = None
            if parsed.response_format == "json_schema" and parsed.json_schema:
                # the grammar guarantees *syntactic* JSON; steer the model
                # toward the schema's shape with an injected instruction
                schema = parsed.json_schema.get("schema", {})
                messages = [
                    {
                        "role": "system",
                        "content": "Respond ONLY with a JSON value matching "
                        "this JSON Schema:\n"
                        + json.dumps(schema, indent=2),
                    }
                ] + list(messages)
            prompt = self.formatter.render(messages, tools=tools)
            # a template that already emitted BOS must not get a second
            # one from the tokenizer's special-token post-processor
            token_ids = self.tokenizer.encode(
                prompt,
                add_special_tokens=not self.formatter.renders_bos,
            )
        elif parsed.prompt_token_ids is not None:
            prompt = None
            token_ids = list(parsed.prompt_token_ids)
        else:
            prompt = parsed.prompt
            token_ids = self.tokenizer.encode(prompt)

        if len(token_ids) >= self.card.context_length:
            raise OpenAIError(
                f"prompt ({len(token_ids)} tokens) exceeds model context length "
                f"({self.card.context_length})",
            )

        stops = parsed.stops
        # resolve stop strings that are single tokens into token-level stops
        for s in stops.stop:
            tid = self.tokenizer.token_to_id(s)
            if tid is not None and tid not in stops.stop_token_ids:
                stops.stop_token_ids.append(tid)

        inp = BackendInput(
            token_ids=token_ids,
            sampling=parsed.sampling,
            stops=stops,
            model=parsed.model,
        )
        request.annotations["prompt_tokens"] = len(token_ids)
        if "formatted_prompt" in parsed.annotations and prompt is not None:
            request.annotations["formatted_prompt"] = prompt
        if "token_ids" in parsed.annotations:
            request.annotations["token_ids"] = token_ids
        return request.map(inp)
