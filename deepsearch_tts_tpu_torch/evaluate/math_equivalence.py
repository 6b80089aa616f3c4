"""LaTeX-aware math answer equivalence.

The port's own copy of ``evaluate/math_equivalence.py`` (same behaviour; imports resolve in this package).

Hendrycks-MATH-style string normalization + equivalence, matching the
semantics of the reference's ``scripts/utils/math_equivalence.py`` (is_equiv,
frac/sqrt repair, unit stripping). Implemented fresh; the normalization steps
are the published MATH-benchmark canonicalization.
"""
from __future__ import annotations

import re


def _repair_fracs(s: str) -> str:
    """Turn \\frac12, \\fracab, \\frac{1}2 into \\frac{1}{2} form."""
    parts = s.split("\\frac")
    out = parts[0]
    for sub in parts[1:]:
        out += "\\frac"
        if not sub:
            continue
        if sub[0] == "{":
            # numerator already braced; brace a bare single-char denominator
            depth, i = 0, 0
            while i < len(sub):
                if sub[i] == "{":
                    depth += 1
                elif sub[i] == "}":
                    depth -= 1
                    if depth == 0:
                        break
                i += 1
            num, rest = sub[: i + 1], sub[i + 1 :]
            if rest and rest[0] != "{":
                out += num + "{" + rest[0] + "}" + rest[1:]
            else:
                out += sub
        else:
            if len(sub) >= 2:
                a, b, rest = sub[0], sub[1], sub[2:]
                if b == "{":
                    out += "{" + a + "}" + sub[1:]
                else:
                    out += "{" + a + "}{" + b + "}" + rest
            else:
                out += "{" + sub + "}"
    return out


def _repair_sqrt(s: str) -> str:
    """\\sqrt3 → \\sqrt{3}."""
    return re.sub(r"\\sqrt(\s*)([^{\s])", r"\\sqrt{\2}", s)


def _repair_a_slash_b(s: str) -> str:
    """A bare a/b with integer a,b becomes \\frac{a}{b}."""
    m = re.fullmatch(r"\s*(-?\d+)\s*/\s*(-?\d+)\s*", s)
    if m:
        return f"\\frac{{{m.group(1)}}}{{{m.group(2)}}}"
    return s


_REMOVALS = [
    "\\left", "\\right", "\\!", "\\,", "\\$", "$", "\\%", "%",
    "^{\\circ}", "^\\circ", "\\ ", " ",
]


def _strip_units(s: str) -> str:
    # drop trailing "\\text{ ...}" unit annotations
    return s.split("\\text{ ")[0]


def normalize_math(s: str) -> str:
    if s is None:
        return ""
    s = s.strip()
    # linebreaks & escaped chars
    s = s.replace("\\\\", "\\").replace("\n", "")
    s = s.replace("tfrac", "frac").replace("dfrac", "frac").replace("\\cfrac", "\\frac")
    s = _strip_units(s)
    for tok in _REMOVALS:
        s = s.replace(tok, "")
    s = s.replace("\\text", "").replace("\\mbox", "")
    s = s.replace("{,}", "")  # thousand separators written {,}
    # 0.5 → .5 canonical form (MATH convention)
    if s.startswith("0."):
        s = s[1:]
    s = re.sub(r"(?<![\d.])0\.(\d)", r".\1", s)
    # X = answer → answer
    if "=" in s and len(s.split("=")) == 2:
        lhs, rhs = s.split("=")
        if len(lhs) <= 2:
            s = rhs
    s = _repair_sqrt(s)
    s = _repair_fracs(s)
    # bare integer "5." → "5"
    if s.endswith("."):
        s = s[:-1]
    s = _repair_a_slash_b(s)
    return s


def is_equiv(a: str | None, b: str | None, verbose: bool = False) -> bool:
    """String equivalence after MATH canonicalization; numeric fallback."""
    if a is None and b is None:
        return True
    if a is None or b is None:
        return False
    na, nb = normalize_math(str(a)), normalize_math(str(b))
    if na == nb:
        return True
    # numeric comparison fallback (handles 0.5 vs 1/2 vs 50%)
    va, vb = _to_number(na), _to_number(nb)
    if va is not None and vb is not None:
        return abs(va - vb) <= 1e-6 * max(1.0, abs(va), abs(vb))
    return False


def _to_number(s: str) -> float | None:
    s = s.strip().replace(",", "")
    try:
        return float(s)
    except ValueError:
        pass
    m = re.fullmatch(r"\\frac\{(-?[\d.]+)\}\{(-?[\d.]+)\}", s)
    if m:
        try:
            return float(m.group(1)) / float(m.group(2))
        except (ValueError, ZeroDivisionError):
            return None
    m = re.fullmatch(r"(-?[\d.]+)%", s)
    if m:
        try:
            return float(m.group(1)) / 100.0
        except ValueError:
            return None
    return None
