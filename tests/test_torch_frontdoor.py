"""The port's front door against the JAX package's, on the CPU.

* model card: ``from_hf_dir`` dicts and ``mdcsum`` equal;
* ``parse_request``: the parsed fields, or the error status and body, equal
  over a table of request bodies (``json_schema`` response formats that
  translate to a schema regex, that do not, or whose regex is over the
  4,096-character cap; good and bad ``guided_regex`` patterns);
* the preprocessor: rendered prompts and token ids equal for completions,
  token-id prompts, chats, tool injection and the chat-template cases of
  ``tests/test_chat_templates.py``;
* the detokenizing Backend: text, finish reasons and logprob entries equal
  on scripted engine streams, stop strings included;
* the HTTP service on the same tiny f32 model (the JAX random init carried
  over by ``params_from_jax``) behind each package's own engine: the same
  requests, sent one at a time, give the same statuses, headers and bodies
  apart from ``id`` and ``created`` (logprob values within 1e-4, f32 on
  both sides), so greedy text is identical; ``/metrics`` renders the JAX
  names and the same request, token and histogram counts, and the port's
  engine families are the served engine's own counters;
* an engine's own ``prefill_counters`` and ``lookahead_counters`` equal
  the JAX package's process-global pair after the same default-path and
  token-budget engine runs;
* constrained and seeded requests over HTTP on a byte-level tokenizer:
  both packages' services give the same bodies for a ``json_object`` chat,
  a ``json_schema`` chat, ``guided_regex`` and ``guided_choice``
  completions and a seeded completion, and the JSON answers parse (or,
  cut at max_tokens, are a prefix the JSON grammar accepts).
"""

import asyncio
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch
from aiohttp import ClientSession

from dynamo_tpu.engine import AsyncLLMEngine as JaxAsyncLLMEngine
from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import EngineCore as JaxEngineCore
from dynamo_tpu.engine import counters as jax_counters
from dynamo_tpu.engine.request import EngineRequest as JaxEngineRequest
from dynamo_tpu.llm import backend as jax_backend
from dynamo_tpu.llm import engines as jax_engines
from dynamo_tpu.llm import model_card as jax_card
from dynamo_tpu.llm import openai as jax_openai
from dynamo_tpu.llm import preprocessor as jax_pre
from dynamo_tpu.llm import protocols as jax_protocols
from dynamo_tpu.llm import tokenizer as jax_tok
from dynamo_tpu.llm.http import HttpService as JaxHttpService
from dynamo_tpu.llm.http import ModelManager as JaxModelManager
from dynamo_tpu.models.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models.llama import LlamaModel as JaxLlamaModel
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore
from dynamo_tpu_torch.engine.request import EngineRequest
from dynamo_tpu_torch.llm import backend, engines, model_card, openai, preprocessor, protocols
from dynamo_tpu_torch.llm import tokenizer as tok
from dynamo_tpu_torch.llm.http import HttpService, ModelManager
from dynamo_tpu_torch.llm.http.metrics import Metrics
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.llama import LlamaModel
from dynamo_tpu_torch.obs.metric_names import (EngineMetric, HttpMetric, KvStreamMetric,
                                                KvTransferMetric)
from dynamo_tpu_torch.runtime.engine import Context
from tests.test_chat_templates import LLAMA3_TEMPLATE, MISTRAL_TEMPLATE

LOGPROB_ATOL = 1e-4
EOS = 2
MODEL = "tiny"
# the word-level vocabulary of the served tiny model: specials, the
# default template's role markers, then words w6.. up to the model's vocab
SPECIALS = ["<unk>", "<s>", "</s>", "<|user|>", "<|assistant|>", "<|system|>"]
VOCAB = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


@pytest.fixture(scope="module")
def tokenizer_file(tmp_path_factory):
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    vocab = {w: i for i, w in enumerate(SPECIALS)}
    for i in range(len(SPECIALS), VOCAB):
        vocab[f"w{i}"] = i
    tk = Tokenizer(models.WordLevel(vocab=vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tk.add_special_tokens(["<s>", "</s>"])
    # BOS on add_special_tokens, so BOS detection changes the token ids
    tk.post_processor = processors.TemplateProcessing(single="<s> $A", special_tokens=[("<s>", 1)])
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    tk.save(str(path))
    return str(path)


# ------------------------------------------------------------------ card
def _card_dirs(root, tokenizer_file):
    """Directories exercising every branch of ``from_hf_dir``."""
    import shutil

    dirs = {}
    for name, cfg, tk_cfg, extra in [
        ("plain", {"eos_token_id": 2, "bos_token_id": 1, "max_position_embeddings": 128},
         None, {}),
        ("token-strings", {"eos_token_id": [2, 5], "bos_token_id": 1},
         {"chat_template": LLAMA3_TEMPLATE, "bos_token": {"content": "<s>", "lstrip": False},
          "eos_token": "</s>"}, {}),
        ("eos-from-tokenizer", {"max_position_embeddings": 64}, {"eos_token": "</s>"}, {}),
        ("template-file", {}, None, {"chat_template.jinja": MISTRAL_TEMPLATE}),
        ("no-tokenizer", {"eos_token_id": 2}, {"eos_token": "</s>"}, None),
    ]:
        d = root / name
        d.mkdir()
        (d / "config.json").write_text(json.dumps(cfg))
        if tk_cfg is not None:
            (d / "tokenizer_config.json").write_text(json.dumps(tk_cfg))
        if extra is not None:
            shutil.copy(tokenizer_file, d / "tokenizer.json")
            for fname, text in extra.items():
                (d / fname).write_text(text)
        dirs[name] = d
    return dirs


def test_card_from_hf_dir_matches_jax(tmp_path, tokenizer_file):
    for name, d in _card_dirs(tmp_path, tokenizer_file).items():
        ref = jax_card.ModelDeploymentCard.from_hf_dir(d)
        card = model_card.ModelDeploymentCard.from_hf_dir(d)
        assert card.to_dict() == ref.to_dict(), name
        assert card.mdcsum == ref.mdcsum, name
        named = model_card.ModelDeploymentCard.from_hf_dir(d, name="served")
        assert named.mdcsum == jax_card.ModelDeploymentCard.from_hf_dir(d, name="served").mdcsum


# ----------------------------------------------------------- parse_request
TOOLS = [{"type": "function", "function": {"name": "get_weather", "description": "weather",
                                           "parameters": {"type": "object"}}}]
CHAT = [{"role": "user", "content": "w7 w8"}]
SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"}, "n": {"type": "integer"}},
          "required": ["ok", "n"]}
# translates, but to a regex over the 4,096-character cap
LONG_SCHEMA = {"type": "string", "enum": ["x" * 200 + str(i) for i in range(30)]}


def _schema_format(schema):
    return {"type": "json_schema", "json_schema": {"name": "r", "schema": schema}}


REQUEST_BODIES = [
    (False, {"model": "m", "prompt": "w7 w8"}),
    (False, {"model": "m", "prompt": [7, 8, 9], "max_tokens": 4, "echo": True}),
    (False, {"model": "m", "prompt": ["w7 w8"]}),
    (False, {"model": "m", "prompt": ["a", "b"]}),
    (False, {"model": "m", "prompt": 5}),
    (False, {"model": "m"}),
    (False, {"prompt": "x"}),
    (False, ["not", "an", "object"]),
    (False, {"model": "m", "prompt": "x", "temperature": 0, "top_p": 0.9, "top_k": 5,
             "min_p": 0.1, "seed": 7, "stop": "w9", "max_tokens": 3, "min_tokens": 1}),
    (False, {"model": "m", "prompt": "x", "min_p": 2}),
    (False, {"model": "m", "prompt": "x", "min_p": "a"}),
    (False, {"model": "m", "prompt": "x", "seed": True}),
    (False, {"model": "m", "prompt": "x", "logit_bias": {"7": 5, "9": -100}}),
    (False, {"model": "m", "prompt": "x", "logit_bias": {"7": 500}}),
    (False, {"model": "m", "prompt": "x", "logit_bias": {"a": 1}}),
    (False, {"model": "m", "prompt": "x", "logit_bias": [1]}),
    (False, {"model": "m", "prompt": "x", "frequency_penalty": 0.5, "presence_penalty": -1}),
    (False, {"model": "m", "prompt": "x", "frequency_penalty": 3.5}),
    (False, {"model": "m", "prompt": "x", "logprobs": 3}),
    (False, {"model": "m", "prompt": "x", "logprobs": 21}),
    (False, {"model": "m", "prompt": "x", "logprobs": True}),
    (False, {"model": "m", "prompt": "x", "response_format": {"type": "json_object"}}),
    (False, {"model": "m", "prompt": "x", "response_format": {"type": "json_schema"}}),
    (False, {"model": "m", "prompt": "x", "response_format": {"type": "xml"}}),
    (False, {"model": "m", "prompt": "x", "response_format": "json"}),
    (False, {"model": "m", "prompt": "x", "guided_choice": ["yes", "no"]}),
    (False, {"model": "m", "prompt": "x", "guided_choice": []}),
    (False, {"model": "m", "prompt": "x", "guided_choice": ["y"],
             "response_format": {"type": "text"}}),
    (False, {"model": "m", "prompt": "x", "guided_regex": ""}),
    (False, {"model": "m", "prompt": "x", "guided_regex": "a" * 1025}),
    (False, {"model": "m", "prompt": "x", "guided_regex": "a+", "guided_choice": ["a"]}),
    (False, {"model": "m", "prompt": "x", "n": 3, "stream": True}),
    (False, {"model": "m", "prompt": "x", "n": 17}),
    (False, {"model": "m", "prompt": "x", "stop": ["w9", "", "w10"]}),
    (False, {"model": "m", "prompt": "x", "stop": 5}),
    (False, {"model": "m", "prompt": "x", "nvext": {"ignore_eos": True,
                                                    "annotations": ["token_ids"]}}),
    (False, {"model": "m", "prompt": "x", "ext": {"annotations": ["formatted_prompt"]},
             "ignore_eos": True}),
    (True, {"model": "m", "messages": CHAT}),
    (True, {"model": "m", "messages": CHAT, "max_completion_tokens": 9, "max_tokens": 3}),
    (True, {"model": "m", "messages": []}),
    (True, {"model": "m"}),
    (True, {"model": "m", "messages": [{"content": "x"}]}),
    (True, {"model": "m", "messages": CHAT + [{"role": "tool", "content": "r"}]}),
    (True, {"model": "m", "messages": CHAT + [{"role": "tool", "content": "r",
                                               "tool_call_id": "c1"}]}),
    (True, {"model": "m", "messages": CHAT, "tools": TOOLS}),
    (True, {"model": "m", "messages": CHAT, "tools": TOOLS, "tool_choice": "required"}),
    (True, {"model": "m", "messages": CHAT, "tools": TOOLS,
            "tool_choice": {"type": "function", "function": {"name": "get_weather"}}}),
    (True, {"model": "m", "messages": CHAT, "tools": TOOLS, "tool_choice": "sometimes"}),
    (True, {"model": "m", "messages": CHAT, "tools": []}),
    (True, {"model": "m", "messages": CHAT, "tools": [{"type": "function", "function": {}}]}),
    (True, {"model": "m", "messages": CHAT, "logprobs": True, "top_logprobs": 4}),
    (True, {"model": "m", "messages": CHAT, "top_logprobs": 4}),
    (True, {"model": "m", "messages": CHAT, "logprobs": True, "top_logprobs": 25}),
    (True, {"model": "m", "messages": CHAT, "response_format": {"type": "json_schema"}}),
    (True, {"model": "m", "messages": CHAT, "response_format": _schema_format(SCHEMA)}),
    (True, {"model": "m", "messages": CHAT,
            "response_format": _schema_format({"type": "object"})}),
    (True, {"model": "m", "messages": CHAT, "response_format": _schema_format(LONG_SCHEMA)}),
    (True, {"model": "m", "messages": CHAT,
            "response_format": _schema_format({"type": "integer", "minimum": "5"})}),
    (True, {"model": "m", "messages": CHAT,
            "response_format": {"type": "json_schema", "json_schema": {"schema": [1]}}}),
    (True, {"model": "m", "messages": CHAT, "response_format": {
        "type": "json_schema", "json_schema": {"schema": {"type": "object"}}}}),
    (False, {"model": "m", "prompt": "x", "guided_regex": "[a-z]+"}),
    (False, {"model": "m", "prompt": "x", "guided_regex": r"(up|down) [0-9][0-9]?%"}),
    (False, {"model": "m", "prompt": "x", "guided_regex": "(unclosed"}),
    (False, {"model": "m", "prompt": "x", "guided_regex": "a{2,5}"}),
    (False, {"model": "m", "prompt": "x", "guided_regex": 5}),
    (True, {"model": "m", "messages": CHAT, "response_format": {"type": "json_object"},
            "guided_choice": ["a"]}),
]


def _parse(mod, body, chat):
    try:
        return "ok", dataclasses.asdict(mod.parse_request(body, chat=chat))
    except mod.OpenAIError as e:
        return e.status, e.body()


@pytest.mark.parametrize("i", range(len(REQUEST_BODIES)))
def test_parse_request_matches_jax(i):
    chat, body = REQUEST_BODIES[i]
    assert _parse(openai, body, chat) == _parse(jax_openai, body, chat)


def test_schema_fields_parse_as_in_jax():
    """The schema regex rides ``guided_regex`` with ``json_mode`` kept as
    the engine's fallback; an untranslatable or over-long schema leaves
    the generic JSON grammar."""
    for schema, translated in ((SCHEMA, True), ({"type": "object"}, False),
                               (LONG_SCHEMA, False)):
        req = openai.parse_request({"model": "m", "messages": CHAT,
                                    "response_format": _schema_format(schema)}, chat=True)
        assert req.sampling.json_mode and req.json_schema["schema"] == schema
        assert (req.schema_regex is not None) == translated
        assert req.sampling.guided_regex == req.schema_regex


# ------------------------------------------------------------ preprocessor
PRE_CASES = [
    (False, {"model": "m", "prompt": "w7 w8 w9", "stop": ["w9", "w10 w11"]}),
    (False, {"model": "m", "prompt": [7, 8, 9]}),
    (False, {"model": "m", "prompt": "w7", "nvext": {"annotations": ["formatted_prompt",
                                                                    "token_ids"]}}),
    (True, {"model": "m", "messages": [{"role": "system", "content": "w6"},
                                       {"role": "user", "content": "w7 w8"}],
            "nvext": {"annotations": ["formatted_prompt", "token_ids"]}}),
    (True, {"model": "m", "messages": CHAT, "tools": TOOLS, "tool_choice": "required",
            "nvext": {"annotations": ["formatted_prompt"]}}),
    (True, {"model": "m", "messages": CHAT, "tools": TOOLS, "tool_choice": "none"}),
    (True, {"model": "m", "messages": CHAT, "response_format": _schema_format(SCHEMA),
            "nvext": {"annotations": ["formatted_prompt"]}}),
]
TEMPLATES = {
    "default": (None, None, None),
    "llama3": (LLAMA3_TEMPLATE, "<s>", "</s>"),
    "mistral": (MISTRAL_TEMPLATE, "<s>", "</s>"),
    "hardcoded-eos": ("{% for m in messages %}[INST] {{ m['content'] }} [/INST]</s>"
                      "{% endfor %}", "<s>", "</s>"),
    "empty-bos": (LLAMA3_TEMPLATE, "", ""),
    "ids-only": (MISTRAL_TEMPLATE, None, None),
    "tools-native": ("{% if tools %}{{ tools | length }} tools {% endif %}"
                     "{% for m in messages %}{{ m['content'] }} {% endfor %}", None, None),
}


async def _preprocess(mod_card, mod_pre, mod_tok, mod_openai, mod_ctx, tokenizer_file,
                      template, chat, body):
    tpl, bos, eos = TEMPLATES[template]
    card = mod_card.ModelDeploymentCard(
        name="m", tokenizer_path=tokenizer_file, context_length=64, chat_template=tpl,
        bos_token=bos, eos_token=eos, bos_token_id=1, eos_token_ids=[2])
    pre = mod_pre.OpenAIPreprocessor(card, mod_tok.TokenizerWrapper.from_file(tokenizer_file))
    ctx = await pre.forward(mod_ctx(mod_openai.parse_request(json.loads(json.dumps(body)),
                                                             chat=chat)))
    inp = ctx.data
    return (pre.formatter.renders_bos, pre.formatter.supports_tools, inp.token_ids,
            dataclasses.asdict(inp.sampling), dataclasses.asdict(inp.stops), inp.model,
            dict(ctx.annotations))


@pytest.mark.parametrize("template", sorted(TEMPLATES))
@pytest.mark.parametrize("case", range(len(PRE_CASES)))
def test_preprocessor_token_ids_match_jax(tokenizer_file, template, case):
    chat, body = PRE_CASES[case]
    ref = _run(_preprocess(jax_card, jax_pre, jax_tok, jax_openai, JaxContext, tokenizer_file,
                           template, chat, body))
    out = _run(_preprocess(model_card, preprocessor, tok, openai, Context, tokenizer_file,
                           template, chat, body))
    assert out == ref


def test_preprocessor_rejects_a_prompt_past_the_context(tokenizer_file):
    card = model_card.ModelDeploymentCard(name="m", tokenizer_path=tokenizer_file,
                                          context_length=4)
    pre = preprocessor.OpenAIPreprocessor(card)
    body = {"model": "m", "prompt": "w7 w8 w9 w10"}
    with pytest.raises(openai.OpenAIError) as e:
        _run(pre.forward(Context(openai.parse_request(body, chat=False))))
    jcard = jax_card.ModelDeploymentCard(name="m", tokenizer_path=tokenizer_file,
                                         context_length=4)
    with pytest.raises(jax_openai.OpenAIError) as je:
        _run(jax_pre.OpenAIPreprocessor(jcard).forward(
            JaxContext(jax_openai.parse_request(body, chat=False))))
    assert e.value.body() == je.value.body()


# ----------------------------------------------------------------- backend
def _scripted(proto):
    """An engine stream of one or two tokens per output, with logprobs and
    top candidates, ending on a length finish."""
    ids = [[7, 8], [9], [10, 11], [12], [13]]
    outs = []
    for j, toks in enumerate(ids):
        outs.append(proto.LLMEngineOutput(
            token_ids=list(toks), logprobs=[-0.25 * (t % 5) for t in toks],
            top_logprobs=[[(t, -0.1), (t + 1, -2.5)] for t in toks],
            finish_reason=proto.FinishReason.LENGTH if j == len(ids) - 1 else None))
    return outs


async def _detok(mod_backend, mod_tok, mod_proto, ctx_cls, tokenizer_file, stop):
    back = mod_backend.Backend(mod_tok.TokenizerWrapper.from_file(tokenizer_file))
    ctx = ctx_cls(mod_proto.BackendInput(token_ids=[7], stops=mod_proto.StopConditions(stop=stop)))

    async def stream():
        for o in _scripted(mod_proto):
            yield o

    return [(o.text, o.finish_reason and o.finish_reason.value, o.logprob_content)
            async for o in back.backward(stream(), ctx)], ctx.is_stopped


@pytest.mark.parametrize("stop", [[], ["w10"], ["w11 w12", "w13"], ["w9 w99"], ["w8 w9"]])
def test_backend_stop_jail_and_logprobs_match_jax(tokenizer_file, stop):
    ref = _run(_detok(jax_backend, jax_tok, jax_protocols, JaxContext, tokenizer_file, stop))
    out = _run(_detok(backend, tok, protocols, Context, tokenizer_file, stop))
    assert out == ref


def test_decode_stream_matches_jax(tokenizer_file):
    ids = [1, 7, 3, 8, 2, 255, 6]
    for skip in (True, False):
        a = tok.TokenizerWrapper.from_file(tokenizer_file).decode_stream(skip)
        b = jax_tok.TokenizerWrapper.from_file(tokenizer_file).decode_stream(skip)
        assert [a.step(t) for t in ids] == [b.step(t) for t in ids]


# -------------------------------------------------------------- tool calls
TOOL_STREAMS = [
    ["I will check. ", "<tool_call>", '{"name": "get_weather", ', '"arguments": {"city": "Paris"}}',
     "</tool_call>"],
    ["[TOOL_CALLS] ", '[{"name": "a", "arguments": {}}, ', '{"name": "get_weather", "arguments": {"x": 1}}]'],
    ["\n", '{"name": "get_weather", "parameters": {"city": "Oslo"}}'],
    ['<|python_tag|>{"name": "a", "parameters": {}}; ', '{"name": "b", "parameters": {"k": 2}}'],
    ["it is ", "sunny <tool", "_call> no, just prose"],
    ["The answer: ", '{"not": "a call"}'],
    ["<tool_call>", '{"name": "get_weather", "arguments": {}}', "</tool_call>", " and after"],
]


def _parse_stream(mod, deltas, only):
    p = mod.ToolCallParser(only=only)
    visible = [p.feed(d) for d in deltas]
    tail, calls = p.finish()
    return visible, tail, _strip(calls)


@pytest.mark.parametrize("only", [None, "get_weather"])
@pytest.mark.parametrize("i", range(len(TOOL_STREAMS)))
def test_tool_call_parser_matches_jax(i, only):
    from dynamo_tpu.llm import tool_calls as jax_tool_calls
    from dynamo_tpu_torch.llm import tool_calls

    assert _parse_stream(tool_calls, TOOL_STREAMS[i], only) == \
        _parse_stream(jax_tool_calls, TOOL_STREAMS[i], only)


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("i", [0, 1, 4])
def test_http_tool_calls_match_jax(i, stream):
    """A scripted engine behind each package's service: the tool_calls
    message or delta, the finish reason and the prose around the calls."""
    body = {"model": "scripted", "messages": CHAT, "tools": TOOLS, "stream": stream}

    async def answer(service_cls, manager_cls, scripted):
        manager = manager_cls()
        manager.add_model("scripted", scripted(TOOL_STREAMS[i]))
        svc = service_cls(manager, port=0)
        await svc.start()
        try:
            out, _ = await _exchange(svc.port, [("POST", "/v1/chat/completions", body, {})])
            return out[0]
        finally:
            await svc.stop()

    ref = _run(answer(JaxHttpService, JaxModelManager, jax_engines.ScriptedEngine))
    out = _run(answer(HttpService, ModelManager, engines.ScriptedEngine))
    assert out[:3] == ref[:3]
    assert _strip(out[3]) == _strip(ref[3])


# ------------------------------------------------------- HTTP, both engines
ENGINE = dict(max_batch_size=4, max_model_len=128, block_size=8, num_blocks=64,
              prefill_buckets=[16, 32, 64, 128])
GREEDY = {"temperature": 0}


def _requests(stop_word: str):
    """(method, path, body or raw bytes, headers) in the order sent."""
    chat = [{"role": "user", "content": "w7 w8 w9 w10"}]
    c = {"model": MODEL, "prompt": "w12 w40 w33 w9 w71", "max_tokens": 6, **GREEDY}
    return [
        ("GET", "/health", None, {}),
        ("GET", "/v1/models", None, {}),
        ("POST", "/v1/completions", c, {"x-request-id": "req-a"}),
        ("POST", "/v1/completions", {**c, "stream": True}, {"x-request-id": "req-b"}),
        ("POST", "/v1/completions", {**c, "prompt": [1, 30, 31, 32]}, {}),
        ("POST", "/v1/chat/completions", {"model": MODEL, "messages": chat, "max_tokens": 5,
                                          **GREEDY}, {}),
        ("POST", "/v1/chat/completions", {"model": MODEL, "messages": chat, "max_tokens": 5,
                                          "stream": True, **GREEDY}, {}),
        ("POST", "/v1/completions", {**c, "n": 2}, {}),
        ("POST", "/v1/chat/completions", {"model": MODEL, "messages": chat, "max_tokens": 4,
                                          "n": 2, "stream": True, **GREEDY}, {}),
        ("POST", "/v1/completions", {**c, "logprobs": 3}, {}),
        ("POST", "/v1/completions", {**c, "logprobs": 2, "stream": True}, {}),
        ("POST", "/v1/chat/completions", {"model": MODEL, "messages": chat, "max_tokens": 4,
                                          "logprobs": True, "top_logprobs": 2, **GREEDY}, {}),
        ("POST", "/v1/chat/completions", {"model": MODEL, "messages": chat, "max_tokens": 4,
                                          "logprobs": True, "stream": True, **GREEDY}, {}),
        ("POST", "/v1/completions", {**c, "stop": [stop_word]}, {}),
        ("POST", "/v1/completions", {**c, "stop": [stop_word], "stream": True}, {}),
        ("POST", "/v1/chat/completions", {"model": MODEL, "messages": chat, "max_tokens": 4,
                                          "tools": TOOLS, **GREEDY}, {}),
        ("POST", "/v1/completions", {"model": "nope", "prompt": "w7"}, {}),
        ("POST", "/v1/chat/completions", {"model": MODEL}, {}),
        ("POST", "/v1/completions", {**c, "n": 99}, {}),
        ("POST", "/v1/completions", b"{not json", {}),
    ]


async def _exchange(port, reqs):
    """Each request's (status, x-request-id, content type, body): JSON, or
    the SSE events' data (JSON objects and the closing [DONE])."""
    out = []
    async with ClientSession() as s:
        for method, path, body, headers in reqs:
            url = f"http://127.0.0.1:{port}{path}"
            kw = {"data": body} if isinstance(body, bytes) else {"json": body}
            async with s.request(method, url, headers=headers, **kw) as r:
                raw = (await r.read()).decode()
                ctype = r.headers.get("Content-Type", "").split(";")[0]
                if ctype == "text/event-stream":
                    data = [l[6:] for l in raw.splitlines() if l.startswith("data: ")]
                    parsed = [d if d == "[DONE]" else json.loads(d) for d in data]
                else:
                    parsed = json.loads(raw)
                out.append((r.status, r.headers.get("x-request-id"), ctype, parsed))
        metrics = await (await s.get(f"http://127.0.0.1:{port}/metrics")).text()
    return out, metrics


async def _serve(service_cls, manager_cls, pipeline, card, reqs, **svc_kw):
    manager = manager_cls()
    manager.add_model(MODEL, pipeline, card)
    svc = service_cls(manager, port=0, **svc_kw)
    await svc.start()
    try:
        return await _exchange(svc.port, reqs)
    finally:
        await svc.stop()


def _served_by_jax(jmodel, jparams, tokenizer_file, reqs, engine=ENGINE):
    core = JaxEngineCore(jmodel, jparams, JaxEngineConfig(**engine), eos_token_ids=[EOS])
    eng = JaxAsyncLLMEngine(core).start()
    card = jax_card.ModelDeploymentCard(name=MODEL, tokenizer_path=tokenizer_file,
                                        context_length=engine["max_model_len"],
                                        eos_token_ids=[EOS])
    try:
        return _run(_serve(JaxHttpService, JaxModelManager,
                           jax_engines.build_serving_pipeline(eng, card), card, reqs))
    finally:
        eng.shutdown()


def _served_by_port(model, tokenizer_file, reqs, engine=ENGINE):
    core = EngineCore(model, EngineConfig(**engine), eos_token_ids=[EOS], device="cpu")
    eng = AsyncLLMEngine(core).start()
    card = model_card.ModelDeploymentCard(name=MODEL, tokenizer_path=tokenizer_file,
                                          context_length=engine["max_model_len"],
                                          eos_token_ids=[EOS])
    try:
        return _run(_serve(HttpService, ModelManager,
                           engines.build_serving_pipeline(eng, card), card, reqs, core=core))
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def served(tokenizer_file):
    """The request sequence answered by each package: (requests, JAX
    answers, JAX /metrics, port answers, port /metrics).  The stop string
    is the third word of the JAX package's greedy completion."""
    jmodel = JaxLlamaModel(JaxModelConfig.tiny(vocab_size=VOCAB))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = ModelConfig.tiny(vocab_size=VOCAB)
    model = LlamaModel.from_state(cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                                       device="cpu"))
    first, _ = _served_by_jax(jmodel, jparams, tokenizer_file, _requests("w6")[2:3])
    stop_word = first[0][3]["choices"][0]["text"].split()[2]
    reqs = _requests(stop_word)
    ref, ref_metrics = _served_by_jax(jmodel, jparams, tokenizer_file, reqs)
    out, out_metrics = _served_by_port(model, tokenizer_file, reqs)
    return reqs, ref, ref_metrics, out, out_metrics


def _strip(x):
    """Drop ``id`` and ``created`` everywhere, and tool-call ids."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in ("id", "created")}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _close(a, b, where="") -> None:
    """Equal structure and values; floats (logprobs) within LOGPROB_ATOL."""
    if isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=0, abs_tol=LOGPROB_ATOL), where
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (where, a, b)
        for k in a:
            _close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def _by_choice(events):
    """SSE events grouped by choice index, in arrival order per choice
    (choices of an n > 1 stream interleave by timing); usage and [DONE]
    stay last."""
    groups, tail = {}, []
    for e in events:
        if e == "[DONE]" or not e.get("choices"):
            tail.append(e)
        else:
            groups.setdefault(e["choices"][0]["index"], []).append(e)
    return [groups[k] for k in sorted(groups)] + [tail]


@pytest.mark.parametrize("i", range(len(_requests("w6"))))
def test_http_answers_match_jax(served, i):
    reqs, ref, _, out, _ = served
    (status, rid, ctype, body), (jstatus, jrid, jctype, jbody) = out[i], ref[i]
    assert (status, rid, ctype) == (jstatus, jrid, jctype), reqs[i]
    if ctype == "text/event-stream":
        _close(_by_choice(_strip(body)), _by_choice(_strip(jbody)))
    else:
        _close(_strip(body), _strip(jbody))


def test_http_greedy_text_and_stop(served):
    reqs, ref, _, out, _ = served
    assert out[2][3]["choices"][0]["finish_reason"] == "length"
    assert len(out[2][3]["choices"][0]["text"].split()) == 6
    stop = reqs[13][2]["stop"][0]
    assert stop not in out[13][3]["choices"][0]["text"]
    assert out[13][3]["choices"][0]["finish_reason"] == "stop"
    streamed = "".join(e["choices"][0]["text"] for e in out[3][3] if e != "[DONE]")
    assert streamed == out[2][3]["choices"][0]["text"]
    assert [r[0] for r in out[-4:]] == [404, 400, 400, 400]


def _samples(text):
    """{series: value} of a Prometheus text page."""
    rows = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, _, val = line.rpartition(" ")
            rows[name] = float(val)
    return rows


def test_http_metrics_match_jax(served):
    _, _, ref_text, _, out_text = served
    ref, out = _samples(ref_text), _samples(out_text)
    assert set(out) <= set(ref)
    for name, val in out.items():
        if name.startswith((HttpMetric.REQUESTS_TOTAL, HttpMetric.OUTPUT_TOKENS_TOTAL,
                            HttpMetric.INFLIGHT_REQUESTS)) or "_count{" in name:
            assert val == ref[name], name
    # the served engine prefilled every request: its counters, not zeros
    assert out[EngineMetric.PREFILL_DISPATCHES_TOTAL] > 0
    assert out[EngineMetric.PREFILL_TOKENS_TOTAL] > 0
    families = {l.split()[2] for l in out_text.splitlines() if l.startswith("# TYPE")}

    def names(cls):
        return {v for k, v in vars(cls).items() if k.isupper()}

    # the transfer-cost families render once an edge has a sample
    assert families - names(KvTransferMetric) == (
        names(HttpMetric) | names(EngineMetric) | names(KvStreamMetric))


def test_metrics_latency_histograms():
    m = Metrics()
    g = m.guard("m1", "completions")
    g.first_token()
    g.first_token()  # idempotent: one TTFT sample per request
    g.tokens(3)
    g.ok()
    g.close()
    text = m.render()
    assert f'{HttpMetric.TTFT_SECONDS}_count{{model="m1"}} 1' in text
    assert f'{HttpMetric.INTER_TOKEN_SECONDS}_count{{model="m1"}} 3' in text
    assert f'{HttpMetric.REQUEST_SECONDS}_count{{model="m1",status="success"}} 1' in text
    vals = [int(l.rpartition(" ")[2]) for l in text.splitlines()
            if l.startswith(f"{HttpMetric.TTFT_SECONDS}_bucket")]
    assert vals == sorted(vals) and vals[-1] == 1


# ---------------------------------------------------------------- counters
COUNTER_RUNS = {
    "default": dict(max_batch_size=4, max_model_len=128, block_size=8, num_blocks=64,
                    prefill_buckets=[16, 32, 64, 128]),
    "token-budget": dict(max_batch_size=4, max_model_len=128, block_size=8, num_blocks=64,
                         prefill_buckets=[16, 32, 64, 128], prefill_chunk_tokens=16,
                         prefill_token_budget=32, lookahead_dispatch=True, decode_steps=4),
}


def _counter_specs():
    rng = np.random.RandomState(5)
    return [(f"r{i}", [int(x) for x in rng.randint(6, 250, size=n)], mt)
            for i, (n, mt) in enumerate([(9, 6), (30, 5), (17, 7), (3, 4)])]


def _step_run(core, request_cls, proto):
    """Two requests, a few steps, then the rest; step until idle."""
    reqs = [request_cls(request_id=rid, prompt=p, emit=lambda o: None,
                        sampling=proto.SamplingOptions(temperature=0.0),
                        stops=proto.StopConditions(max_tokens=mt))
            for rid, p, mt in _counter_specs()]
    for r in reqs[:2]:
        core.submit(r)
    for _ in range(2):
        core.step()
    for r in reqs[2:]:
        core.submit(r)
    for _ in range(500):
        if not core.step():
            break


def _snapshot(pc, lc):
    return ({k: v for k, v in vars(pc).items()},
            {k: v for k, v in vars(lc).items()},
            (pc.batch_occupancy, pc.budget_utilization, pc.unified_budget_utilization))


@pytest.fixture(scope="module")
def jax_counter_runs():
    jmodel = JaxLlamaModel(JaxModelConfig.tiny())
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    out = {}
    for name, cfg in COUNTER_RUNS.items():
        jax_counters.counters.reset()
        jax_counters.lookahead_counters.reset()
        core = JaxEngineCore(jmodel, jparams, JaxEngineConfig(**cfg), eos_token_ids=[EOS])
        _step_run(core, JaxEngineRequest, jax_protocols)
        out[name] = _snapshot(jax_counters.counters, jax_counters.lookahead_counters)
    return jmodel, jparams, out


@pytest.mark.parametrize("run", sorted(COUNTER_RUNS))
def test_engine_counters_match_jax(jax_counter_runs, run):
    jmodel, jparams, ref = jax_counter_runs
    cfg = ModelConfig.tiny()
    model = LlamaModel.from_state(cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                                       device="cpu"))
    core = EngineCore(model, EngineConfig(**COUNTER_RUNS[run]), eos_token_ids=[EOS],
                      device="cpu")
    _step_run(core, EngineRequest, protocols)
    out = _snapshot(core.prefill_counters, core.lookahead_counters)
    assert out == ref[run]
    assert out[0]["dispatches_total"] > 0
    if run == "token-budget":
        assert out[0]["unified_dispatches_total"] > 0 and out[1]["bursts_total"] > 0


# ------------------------------------------ constrained and seeded, HTTP
BYTE_VOCAB = 320
# one token per byte: the chat template and the schema instruction take
# several hundred
BYTE_ENGINE = dict(ENGINE, max_model_len=1024, num_blocks=160,
                   prefill_buckets=[64, 128, 256, 512, 1024])


@pytest.fixture(scope="module")
def byte_tokenizer_file(tmp_path_factory):
    """A byte-level BPE with no merges: three specials, then the 256 bytes
    in GPT-2's printable alphabet (id 3 + byte), so every text is one token
    per byte and ``token_bytes_map`` sees real bytes."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers

    from dynamo_tpu_torch.engine.grammar import _gpt2_unicode_to_bytes

    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    vocab.update({ch: 3 + b for ch, b in _gpt2_unicode_to_bytes().items()})
    tk = Tokenizer(models.BPE(vocab=vocab, merges=[], unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tk.decoder = decoders.ByteLevel()
    tk.add_special_tokens(["<s>", "</s>"])
    path = tmp_path_factory.mktemp("bytetok") / "tokenizer.json"
    tk.save(str(path))
    return str(path)


def _grammar_requests():
    chat = [{"role": "user", "content": "Give me a JSON object."}]
    c = {"model": MODEL, "prompt": "Phone: ", "max_tokens": 12}
    return [
        ("POST", "/v1/chat/completions", {"model": MODEL, "messages": chat, "max_tokens": 24,
                                          "response_format": {"type": "json_object"},
                                          **GREEDY}, {}),
        ("POST", "/v1/chat/completions", {"model": MODEL, "messages": chat, "max_tokens": 24,
                                          "response_format": _schema_format(SCHEMA), **GREEDY},
         {}),
        ("POST", "/v1/completions", {**c, "guided_regex": "[0-9][0-9][0-9]-[0-9][0-9]",
                                     **GREEDY}, {}),
        ("POST", "/v1/completions", {**c, "guided_choice": ["red", "green"], "temperature": 1.0,
                                     "seed": 4}, {}),
        ("POST", "/v1/completions", {**c, "temperature": 0.9, "seed": 11}, {}),
        ("POST", "/v1/completions", {**c, "temperature": 0.9, "seed": 11, "stream": True}, {}),
        ("POST", "/v1/completions", {**c, "guided_regex": "(bad"}, {}),
    ]


@pytest.fixture(scope="module")
def served_grammar(byte_tokenizer_file):
    """``_grammar_requests`` answered by each package's service over one
    tiny f32 model: (JAX answers, port answers)."""
    jmodel = JaxLlamaModel(JaxModelConfig.tiny(vocab_size=BYTE_VOCAB))
    jparams = jmodel.init_params(jax.random.PRNGKey(1))
    cfg = ModelConfig.tiny(vocab_size=BYTE_VOCAB)
    model = LlamaModel.from_state(cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                                       device="cpu"))
    reqs = _grammar_requests()
    ref, _ = _served_by_jax(jmodel, jparams, byte_tokenizer_file, reqs, BYTE_ENGINE)
    out, _ = _served_by_port(model, byte_tokenizer_file, reqs, BYTE_ENGINE)
    return ref, out


@pytest.mark.parametrize("i", range(len(_grammar_requests())))
def test_http_constrained_and_seeded_match_jax(served_grammar, i):
    ref, out = served_grammar
    (status, _, ctype, body), (jstatus, _, jctype, jbody) = out[i], ref[i]
    assert (status, ctype) == (jstatus, jctype)
    _close(_strip(body), _strip(jbody))


def test_http_json_answers_are_json(served_grammar):
    """A ``json_object`` chat answers JSON — or, stopped at max_tokens, a
    prefix the JSON grammar accepts byte by byte; the schema chat's answer
    has the schema's shape; the seeded completion repeats itself."""
    import re

    from dynamo_tpu_torch.engine.grammar import INIT_STATE, compile_vocab, json_schema_to_regex

    _, out = served_grammar
    tables = compile_vocab([bytes([b]) for b in range(256)], eos_ids=[])
    for i in (0, 1):
        assert "choices" in out[i][3], out[i]
        choice = out[i][3]["choices"][0]
        text = choice["message"]["content"]
        if choice["finish_reason"] == "stop":
            json.loads(text)
        else:
            assert choice["finish_reason"] == "length"
            s, d, st = INIT_STATE, 0, 0
            for b in text.encode():
                assert tables.valid_mask(s, d, st)[b], text
                s, d, st = tables.advance(s, d, st, b)
    schema_text = out[1][3]["choices"][0]["message"]["content"]
    if out[1][3]["choices"][0]["finish_reason"] == "stop":
        assert re.fullmatch(json_schema_to_regex(SCHEMA), schema_text)
    assert re.fullmatch("[0-9][0-9][0-9]-[0-9][0-9]", out[2][3]["choices"][0]["text"])
    assert out[3][3]["choices"][0]["text"] in ("red", "green")
    streamed = "".join(e["choices"][0]["text"] for e in out[5][3] if e != "[DONE]")
    assert streamed == out[4][3]["choices"][0]["text"]
    assert out[6][0] == 400
