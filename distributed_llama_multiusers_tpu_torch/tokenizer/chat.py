"""Chat template rendering + chat stop strings.

Port of ChatTemplateGenerator / TokenizerChatStops (src/tokenizer.cpp:512-612):
hard-coded renderers for llama2 / llama3 / deepSeek3, auto-detected from the
Jinja template string stored in the tokenizer file.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

from .tokenizer import Tokenizer


class TemplateType(IntEnum):
    UNKNOWN = 0
    LLAMA2 = 1
    LLAMA3 = 2
    DEEP_SEEK3 = 3
    # framework extension beyond the reference's three renderers
    # (src/tokenizer.cpp:538-559): ChatML, the Qwen2-family turn format
    CHATML = 4


@dataclass
class ChatItem:
    role: str
    message: str


@dataclass
class GeneratedChat:
    content: str
    public_prompt: str | None  # deepSeek3 exposes its injected "<think>\n" tail


def template_type_from_name(name: str | None) -> TemplateType:
    """CLI --chat-template value -> TemplateType (None = auto-detect)."""
    return {
        None: TemplateType.UNKNOWN,
        "llama2": TemplateType.LLAMA2,
        "llama3": TemplateType.LLAMA3,
        "deepSeek3": TemplateType.DEEP_SEEK3,
        "chatml": TemplateType.CHATML,
    }[name]


def eos_piece_of(tokenizer: Tokenizer) -> str:
    """The first EOS token's text — the template's turn terminator."""
    if not tokenizer.eos_token_ids:
        return ""
    return tokenizer.vocab[tokenizer.eos_token_ids[0]].decode("utf-8", errors="replace")


def chat_generator_for(tokenizer: Tokenizer, name_or_type=None) -> "ChatTemplateGenerator":
    """Build a ChatTemplateGenerator from a tokenizer + optional CLI name."""
    t = name_or_type if isinstance(name_or_type, TemplateType) else template_type_from_name(name_or_type)
    return ChatTemplateGenerator(t, tokenizer.chat_template, eos_piece_of(tokenizer))


class TokenizerChatStops:
    """Stop strings = the pieces of the tokenizer's EOS tokens
    (src/tokenizer.cpp:512-525)."""

    def __init__(self, tokenizer: Tokenizer):
        self.stops: list[str] = [
            tokenizer.vocab[t].decode("utf-8", errors="replace") for t in tokenizer.eos_token_ids
        ]
        self.max_stop_length = max((len(s) for s in self.stops), default=0)


class ChatTemplateGenerator:
    def __init__(self, template_type: TemplateType, chat_template: str | None, eos: str):
        if template_type == TemplateType.UNKNOWN:
            if chat_template is None:
                raise ValueError("The tokenizer does not include chat template")
            if "[INST]" in chat_template:
                template_type = TemplateType.LLAMA2
            elif "<|start_header_id|>" in chat_template:
                template_type = TemplateType.LLAMA3
            elif "<｜Assistant｜>" in chat_template:
                template_type = TemplateType.DEEP_SEEK3
            elif "<|im_start|>" in chat_template:
                template_type = TemplateType.CHATML
            else:
                raise ValueError("Not supported chat template")
        self.type = template_type
        self.eos = eos

    def generate(self, items: list[ChatItem], append_generation_prompt: bool) -> GeneratedChat:
        buf = []
        public_prompt_size = 0
        eos = self.eos
        if self.type == TemplateType.LLAMA2:
            i = 0
            if len(items) >= 2 and items[0].role == "system" and items[1].role == "user":
                buf.append(
                    "[INST] <<SYS>>\n" + items[0].message + "\n<</SYS>>\n\n" + items[1].message + " [/INST]" + eos
                )
                i = 2
            for item in items[i:]:
                if item.role == "assistant":
                    buf.append(item.message + eos)
                elif item.role == "user":
                    buf.append("[INST] " + item.message + " [/INST]" + eos)
        elif self.type == TemplateType.LLAMA3:
            for item in items:
                buf.append(
                    "<|start_header_id|>" + item.role + "<|end_header_id|>\n\n" + item.message + eos
                )
            if append_generation_prompt:
                buf.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
        elif self.type == TemplateType.CHATML:
            # <|im_start|>role\ncontent<|im_end|>\n per turn; the terminator
            # comes from the tokenizer's EOS piece (<|im_end|> for Qwen2).
            # Qwen's own template prepends a default system turn when the
            # conversation does not open with one — mirror that with the
            # Qwen2 default ("You are a helpful assistant."; Qwen2.5 ships a
            # longer brand-specific default — pass an explicit system
            # message to match it exactly).
            if not items or items[0].role != "system":
                buf.append(
                    "<|im_start|>system\nYou are a helpful assistant."
                    + eos + "\n"
                )
            for item in items:
                buf.append("<|im_start|>" + item.role + "\n" + item.message + eos + "\n")
            if append_generation_prompt:
                buf.append("<|im_start|>assistant\n")
        elif self.type == TemplateType.DEEP_SEEK3:
            i = 0
            if items and items[0].role == "system":
                buf.append(items[0].message)
                i = 1
            for item in items[i:]:
                if item.role == "user":
                    buf.append("<｜User｜>" + item.message)
                elif item.role == "assistant":
                    buf.append("<｜Assistant｜>" + item.message)
            if append_generation_prompt:
                buf.append("<｜Assistant｜><think>\n")
                public_prompt_size = 8
        content = "".join(buf)
        public_prompt = content[-public_prompt_size:] if public_prompt_size > 0 else None
        return GeneratedChat(content=content, public_prompt=public_prompt)
