"""Answer extraction from raw model output.

The port's own copy of ``evaluate/extract.py`` (same behaviour; imports resolve in this package).

Mode-dependent extraction semantics matching the reference's
``extract_answer_fn`` (reference: scripts/evaluate/evaluate.py:20-65; the
string heuristics here are load-bearing for accuracy — see SURVEY.md §7(c)):

* qa / math / choose — last ``\\boxed{...}`` (balanced braces), else text
  after a trailing ``ANSWER:`` marker; ``choose`` additionally unwraps
  ``\\text{...}`` and surrounding parens.
* codegen            — last fenced ```` ```python ```` block.
* summary / infogen / research — content after ``</think>`` or after the
  ``**Final Information**`` marker, truncated (2500 chars; research 6000;
  infogen first 5 lines), falling back to the output's tail lines.
"""
from __future__ import annotations

import re

FINAL_INFO_MARK = "**Final Information"
CLICK_TOKEN = "<|begin_click_link|>"


def extract_boxed(text: str, last: bool = True) -> str:
    """Extract the contents of a ``\\boxed{...}`` with balanced braces.

    The reference uses the greedy regex ``\\boxed\\{(.*)\\}``; balanced-brace
    scanning is strictly more correct for nested LaTeX while agreeing on the
    flat cases.
    """
    spans = []
    i = 0
    while True:
        j = text.find(r"\boxed{", i)
        if j < 0:
            break
        depth = 0
        k = j + len(r"\boxed{") - 1
        start = k + 1
        while k < len(text):
            if text[k] == "{":
                depth += 1
            elif text[k] == "}":
                depth -= 1
                if depth == 0:
                    spans.append(text[start:k])
                    break
            k += 1
        else:
            break
        i = k + 1
    if not spans:
        return ""
    return spans[-1] if last else spans[0]


def _strip_text_wrapper(s: str) -> str:
    m = re.findall(r"\\text\{(.*)\}", s)
    if m:
        s = m[-1]
    return s.strip("()")


def _tail_lines(text: str, n: int) -> str:
    lines = text.replace("\n\n", "\n").strip().split("\n")
    return "\n".join(lines[-n:])


def extract_answer_fn(output: str, mode: str = "qa", extract_answer: bool = False) -> str:
    output = output or ""
    if not extract_answer and mode not in ("infogen", "summary", "research"):
        if mode == "qa":
            return output.strip()
        return _tail_lines(output, 3)

    if mode == "codegen":
        blocks = re.findall(r"```python\s*(.*?)\s*```", output, re.DOTALL | re.IGNORECASE)
        return blocks[-1].strip() if blocks else ""

    if mode in ("infogen", "summary", "research"):
        if "</think>\n" in output:
            text = output.split("</think>\n")[-1]
        elif FINAL_INFO_MARK in output:
            text = output.split(FINAL_INFO_MARK)[-1]
        else:
            tail = "\n".join(
                output.strip().replace("</think>\n", "").replace("\n\n", "\n").split("\n")[-5:]
            )
            return tail[:6000] if mode == "research" else tail[:2500]
        text = text.split(CLICK_TOKEN)[0]
        text = text.replace(FINAL_INFO_MARK, "").strip(":**").strip("\n").strip("```").strip()
        if mode == "infogen":
            text = "\n".join(text.replace("\n\n", "\n").split("\n")[:5])
        return text[:6000] if mode == "research" else text[:2500]

    if mode in ("math", "choose", "qa"):
        ans = extract_boxed(output)
        if not ans and "ANSWER:" in output:
            ans = output.split("ANSWER:")[-1].strip("**").strip()
        if mode == "choose":
            ans = _strip_text_wrapper(ans)
        return ans

    return output.strip()


_FLOAT_RE = re.compile(r"[-+]?\d*\.?\d+")


def extract_confidence(text: str) -> float | None:
    """Parse a verifier's boxed confidence score into a float in [0, 1].

    Accepts ``\\boxed{0.75}``, ``\\boxed{\\text{3/4}}``, bare fractions, and
    percentages (reference: scripts/deep_search.py verify_problem boxed parse).
    """
    raw = extract_boxed(text)
    if not raw:
        return None
    raw = _strip_text_wrapper(raw).strip().rstrip("%")
    frac = re.match(r"^\s*(\d+(?:\.\d+)?)\s*/\s*(\d+(?:\.\d+)?)\s*$", raw)
    try:
        if frac:
            denom = float(frac.group(2))
            val = float(frac.group(1)) / denom if denom else 0.0
        else:
            m = _FLOAT_RE.search(raw)
            if not m:
                return None
            val = float(m.group(0))
        if val > 1.0 and val <= 100.0:
            val /= 100.0
        return max(0.0, min(1.0, val))
    except (ValueError, ZeroDivisionError):
        return None
