"""Tokenization, chat templating and tool-call parsing (port of
``engine/tokenizer.py``; host code, the same behaviour).

* :class:`ByteTokenizer` — hermetic byte-level tokenizer (256 byte ids +
  specials): tests, smoke runs and random-weight serving need no files.
* :class:`HFTokenizer` — a local ``transformers`` tokenizer directory,
  imported when one is asked for (the card's machine has no
  ``transformers``).
* :class:`IncrementalDetokenizer` — streaming token → text.
* :func:`parse_tool_calls` — ``<tool_call>`` blocks → OpenAI tool calls.

Chat formatting is ChatML as the Qwen3 family writes it, with
``<tool_call>`` emission and ``<tool_response>`` feeding.
"""
from __future__ import annotations

import json
import re
import uuid
from dataclasses import dataclass
from typing import Sequence

TOOL_CALL_RE = re.compile(r"<tool_call>\s*(\{.*?\})\s*</tool_call>", re.DOTALL)


@dataclass
class Special:
    bos: str = "<|im_start|>"
    eot: str = "<|im_end|>"         # end of turn (generation stop)
    think_open: str = "<think>"
    think_close: str = "</think>"


class ChatTemplate:
    """ChatML renderer with tool support (Qwen3 convention)."""

    def __init__(self, special: Special | None = None):
        self.sp = special or Special()

    def render(self, messages: Sequence[dict], tools: Sequence[dict] | None = None,
               add_generation_prompt: bool = True) -> str:
        sp = self.sp
        out = []
        msgs = list(messages)
        sys_content = ""
        if msgs and msgs[0].get("role") == "system":
            sys_content = msgs[0].get("content") or ""
            msgs = msgs[1:]
        if tools:
            tool_block = "\n".join(json.dumps(t, ensure_ascii=False) for t in tools)
            sys_content = (
                (sys_content + "\n\n" if sys_content else "")
                + "# Tools\n\nYou may call one or more functions to assist with "
                "the user query.\n\nYou are provided with function signatures "
                "within <tools></tools> XML tags:\n<tools>\n" + tool_block +
                "\n</tools>\n\nFor each function call, return a json object "
                "with function name and arguments within <tool_call></tool_call> "
                'XML tags:\n<tool_call>\n{"name": <function-name>, "arguments": '
                "<args-json-object>}\n</tool_call>"
            )
        if sys_content:
            out.append(f"{sp.bos}system\n{sys_content}{sp.eot}\n")
        for m in msgs:
            role, content = m.get("role"), m.get("content") or ""
            if role == "tool":
                out.append(f"{sp.bos}user\n<tool_response>\n{content}\n"
                           f"</tool_response>{sp.eot}\n")
            elif role == "assistant":
                body = content
                for tc in m.get("tool_calls") or []:
                    fn = tc.get("function", tc)
                    args = fn.get("arguments", {})
                    if isinstance(args, str):
                        try:
                            args = json.loads(args)
                        except json.JSONDecodeError:
                            pass
                    body += "\n<tool_call>\n" + json.dumps(
                        {"name": fn.get("name"), "arguments": args}, ensure_ascii=False
                    ) + "\n</tool_call>"
                out.append(f"{sp.bos}assistant\n{body}{sp.eot}\n")
            else:
                out.append(f"{sp.bos}{role}\n{content}{sp.eot}\n")
        if add_generation_prompt:
            out.append(f"{sp.bos}assistant\n")
        return "".join(out)


def parse_tool_calls(text: str) -> tuple[str, list[dict]]:
    """Split generated text into (content, OpenAI-style tool_call dicts)."""
    calls = []
    for m in TOOL_CALL_RE.finditer(text):
        try:
            obj = json.loads(m.group(1))
        except json.JSONDecodeError:
            continue
        calls.append({
            "id": f"call_{uuid.uuid4().hex[:12]}",
            "type": "function",
            "function": {
                "name": obj.get("name", ""),
                "arguments": json.dumps(obj.get("arguments", {}), ensure_ascii=False),
            },
        })
    return TOOL_CALL_RE.sub("", text).strip(), calls


class IncrementalDetokenizer:
    """Streaming token → text with BPE / UTF-8 boundary handling: re-decode a
    small window and emit only the stable suffix."""

    CTX = 4  # emitted tokens re-decoded as context for BPE boundary merges

    def __init__(self, tokenizer):
        self.tk = tokenizer
        self.ids: list[int] = []
        self.text = ""
        self._start = 0  # first id not yet emitted as text

    def push(self, token_id: int) -> str:
        self.ids.append(int(token_id))
        pending = self.ids[self._start:]
        cur = self.tk.decode(pending)
        if cur.endswith("�") and len(pending) < 4:
            # possibly an incomplete UTF-8 sequence: hold it (a real one
            # completes within 4 bytes; longer is genuinely invalid)
            return ""
        ctx_start = max(0, self._start - self.CTX)
        with_ctx = self.tk.decode(self.ids[ctx_start:])
        ctx_only = self.tk.decode(self.ids[ctx_start:self._start])
        piece = with_ctx[len(ctx_only):] if with_ctx.startswith(ctx_only) else cur
        self._start = len(self.ids)
        self.text += piece
        return piece


class ByteTokenizer:
    """UTF-8 byte tokenizer with a small special-token table: ids 0..255 are
    bytes, specials get ids >= 256. Deterministic and total."""

    SPECIALS = ["<|im_start|>", "<|im_end|>", "<pad>",
                "<tool_call>", "</tool_call>", "<think>", "</think>",
                "<|begin_search_query|>", "<|end_search_query|>",
                "<|begin_search_result|>", "<|end_search_result|>",
                "<|begin_click_link|>", "<|end_click_link|>"]

    def __init__(self):
        self._sp_to_id = {s: 256 + i for i, s in enumerate(self.SPECIALS)}
        self._id_to_sp = {v: k for k, v in self._sp_to_id.items()}
        self.vocab_size = 256 + len(self.SPECIALS)
        self.eos_id = self._sp_to_id["<|im_end|>"]
        self.pad_id = self._sp_to_id["<pad>"]
        self.chat = ChatTemplate()
        self._sp_re = re.compile("|".join(re.escape(s) for s in self.SPECIALS))

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        pos = 0
        for m in self._sp_re.finditer(text):
            ids.extend(text[pos:m.start()].encode("utf-8"))
            ids.append(self._sp_to_id[m.group(0)])
            pos = m.end()
        ids.extend(text[pos:].encode("utf-8"))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out: list[str] = []
        buf = bytearray()
        for i in ids:
            i = int(i)
            if i in self._id_to_sp:
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                out.append(self._id_to_sp[i])
            else:
                # out-of-range ids fold onto bytes, so decode is total (test
                # models may have a larger vocab than this tokenizer)
                buf.append(i % 256)
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)

    def apply_chat_template(self, messages, tools=None, add_generation_prompt=True) -> str:
        return self.chat.render(messages, tools, add_generation_prompt)


class HFTokenizer:
    """Adapter over a locally available HuggingFace tokenizer directory."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self.tk = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = len(self.tk)
        self.eos_id = self.tk.eos_token_id
        self.pad_id = self.tk.pad_token_id or self.tk.eos_token_id
        self.chat = ChatTemplate()

    def encode(self, text: str) -> list[int]:
        return self.tk.encode(text, add_special_tokens=False)

    def decode(self, ids) -> str:
        return self.tk.decode(list(ids), skip_special_tokens=False)

    def apply_chat_template(self, messages, tools=None, add_generation_prompt=True) -> str:
        try:
            return self.tk.apply_chat_template(
                messages, tools=list(tools) if tools else None,
                tokenize=False, add_generation_prompt=add_generation_prompt)
        except Exception:
            return self.chat.render(messages, tools, add_generation_prompt)
