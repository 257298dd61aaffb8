"""OpenAI-ish JSON request/response shapes (reference: src/api-types.hpp).

The fork's web UI reads the non-standard ``generated_text`` field
(web-ui/app.js:27-40); standard clients read ``choices``. Responses carry
both."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..serving.qos import Priority


@dataclass
class ChatMessage:
    role: str
    content: str


def parse_chat_messages(body: dict) -> list[ChatMessage]:
    """api-types.hpp:166-177."""
    messages = body.get("messages")
    if not isinstance(messages, list) or not messages:
        raise ValueError("missing messages")
    out = []
    for m in messages:
        if not isinstance(m, dict) or "role" not in m or "content" not in m:
            raise ValueError("message entries need role and content")
        content = m["content"]
        if isinstance(content, list):  # OpenAI content-part arrays
            content = "".join(
                p.get("text", "") for p in content if isinstance(p, dict) and p.get("type") == "text"
            )
        out.append(ChatMessage(role=str(m["role"]), content=str(content)))
    return out


@dataclass
class InferenceParams:
    """Per-request generation params. Sampled requests run on the device
    (exact full-vocab nucleus and JAX's draw, runtime/sampling.py)."""

    max_tokens: int = 128
    temperature: float = 0.0
    top_p: float = 0.9
    seed: int | None = None
    stop: list[str] = field(default_factory=list)
    stream: bool = False
    # the OpenAI API's end-user field (the fair-share key) and the
    # admission class (serving/qos.py)
    user: str = ""
    priority: int = Priority.NORMAL
    # structured output (grammar/): {"type": "json_object"} or {"type":
    # "json_schema", ...}, validated at parse time so a malformed schema
    # gets a 400 before any admission work
    response_format: dict | None = None

    @staticmethod
    def from_body(body: dict) -> "InferenceParams":
        p = InferenceParams()
        if "max_tokens" in body:
            p.max_tokens = max(1, int(body["max_tokens"]))
        if "temperature" in body and body["temperature"] is not None:
            p.temperature = float(body["temperature"])
        if "top_p" in body and body["top_p"] is not None:
            p.top_p = float(body["top_p"])
        if "seed" in body and body["seed"] is not None:
            p.seed = int(body["seed"])
        stop = body.get("stop")
        if isinstance(stop, str):
            p.stop = [stop]
        elif isinstance(stop, list):
            p.stop = [str(s) for s in stop]
        p.stream = bool(body.get("stream", False))
        if body.get("response_format") is not None:
            # GrammarError is a ValueError -> the route's typed 400
            from ..grammar.automaton import validate_response_format

            validate_response_format(body["response_format"])
            p.response_format = dict(body["response_format"])
        if body.get("user") is not None:
            p.user = str(body["user"])
        if body.get("priority") is not None:
            p.priority = Priority.parse(body["priority"])  # ValueError -> 400
        return p


def chat_completion_response(
    model: str, req_id: int, text: str, prompt_tokens: int, completion_tokens: int,
    finish_reason: str = "stop", summary: dict | None = None,
) -> dict:
    out = {
        "id": f"chatcmpl-{req_id}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "generated_text": text,  # fork-compat field (dllama-api.cpp:283)
        "choices": [
            {
                "index": 0,
                "message": {"role": "assistant", "content": text},
                "finish_reason": finish_reason,
            }
        ],
        "usage": {
            "prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens,
        },
    }
    if summary is not None:
        # per-request latency summary (telemetry RequestTrace.summary)
        out["summary"] = summary
    return out


def chat_chunk_response(
    model: str, req_id: int, delta: str | None, done: bool,
    finish_reason: str = "stop", summary: dict | None = None,
) -> dict:
    choice: dict = {"index": 0, "delta": {}, "finish_reason": finish_reason if done else None}
    if delta:
        choice["delta"] = {"content": delta}
    out = {
        "id": f"chatcmpl-{req_id}",
        "object": "chat.completion.chunk",
        "created": int(time.time()),
        "model": model,
        "choices": [choice],
    }
    if done and summary is not None:
        out["summary"] = summary  # terminal chunk only, same dict as non-stream
    return out


def parse_completion_prompt(body: dict) -> str:
    """Raw prompt for /v1/completions: a string, or a 1-element list of
    strings (the OpenAI API's batched-prompt form; >1 is unsupported —
    submit them as separate requests, the batching loop runs them
    concurrently anyway)."""
    prompt = body.get("prompt")
    if isinstance(prompt, list):
        if len(prompt) > 1:
            raise ValueError(
                "prompt lists with more than one entry are unsupported; "
                "submit separate requests (they batch concurrently)"
            )
        prompt = prompt[0] if prompt else None
    if not isinstance(prompt, str) or not prompt:
        raise ValueError(
            "missing or empty 'prompt' (must be a non-empty string or a "
            "1-element list of strings; token-id prompts are unsupported)"
        )
    return prompt


def completion_response(
    model: str, req_id: int, text: str, prompt_tokens: int, completion_tokens: int,
    finish_reason: str = "stop", summary: dict | None = None,
) -> dict:
    out = {
        "id": f"cmpl-{req_id}",
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "generated_text": text,  # fork-compat field, same as the chat route
        "choices": [
            {"index": 0, "text": text, "finish_reason": finish_reason}
        ],
        "usage": {
            "prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens,
        },
    }
    if summary is not None:
        out["summary"] = summary  # per-request latency summary
    return out


def completion_chunk_response(
    model: str, req_id: int, delta: str | None, done: bool,
    finish_reason: str = "stop", summary: dict | None = None,
) -> dict:
    out = {
        "id": f"cmpl-{req_id}",
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [
            {
                "index": 0,
                "text": delta or "",
                "finish_reason": finish_reason if done else None,
            }
        ],
    }
    if done and summary is not None:
        out["summary"] = summary  # terminal chunk only, same dict as non-stream
    return out


def models_response(model: str) -> dict:
    return {
        "object": "list",
        "data": [
          
            {"id": model, "object": "model", "created": int(time.time()), "owned_by": "user"}
        ],
    }
