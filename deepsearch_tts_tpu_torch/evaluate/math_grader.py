"""Symbolic math grading — full decision-ladder parity with the reference's
vendored qwen_math_eval_toolkit.

The port's own copy of ``evaluate/math_grader.py`` (same behaviour; imports resolve in this package).

The reference vendors a 1.8k-LoC grader/parser pair
(reference: scripts/qwen_math_eval_toolkit/grader.py:73-259,
parser.py:212-352) built on sympy + latex2sympy. This module re-implements
the same capability surface natively:

* answer normalization (``strip_string``-class: units, degrees, dollars,
  percent, matrix environments, trailing ``.0``) — parser.py:212-352
* multiple-choice cleanup (A–E extraction) — grader.py:26-37
* numeric equivalence with thousands separators, percent forms, and the
  x100/÷100 percentage ambiguity at rel-tol 1e-4 — grader.py:40-56,98-116
* interval/tuple element-wise equivalence — grader.py:150-166
* matrix equivalence (pmatrix/bmatrix/array, and ``{a, b}`` set-literal
  coercion) — grader.py:59-70,167-223
* equation equivalence (two-sided ``a=b`` difference up to sign; one-sided
  ``x = expr`` unwrapping) — grader.py:225-248
* symbolic equivalence via a native LaTeX→sympy conversion (no antlr /
  latex2sympy dependency, neither of which exists in this environment)
* an optional hard timeout around sympy (grader.py:333-345) using a worker
  process, since pathological simplify() calls can hang

Gated: if sympy is unavailable, grading degrades to string/numeric
equivalence.
"""
from __future__ import annotations

import re

from .extract import extract_boxed
from .math_equivalence import is_equiv, normalize_math

try:
    import sympy
    from sympy.parsing.sympy_parser import (
        implicit_multiplication_application,
        parse_expr,
        standard_transformations,
    )

    _TRANSFORMS = standard_transformations + (implicit_multiplication_application,)
    HAS_SYMPY = True
except Exception:  # pragma: no cover
    HAS_SYMPY = False


# --------------------------------------------------------------- normalization

_UNIT_WORDS = [
    "degrees?", "dollars?", "units?", "miles?", "inches", "inch", "feet",
    "foot", "cm", "km", "meters?", "seconds?", "minutes?", "hours?", "days?",
    "weeks?", "months?", "years?", "square", "cubic", "per", "mph", "kmh",
    "p\\.?m\\.?", "a\\.?m\\.?",
]

_WORD_NUMBERS = {
    "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
    "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9",
    "ten": "10", "eleven": "11", "twelve": "12",
}


def strip_answer_string(s: str) -> str:
    """Normalize an extracted answer the way the toolkit's ``strip_string``
    does (parser.py:212-352): drop presentation LaTeX, units, currency,
    degree marks; canonicalize matrix environments and trailing zeros."""
    s = str(s).strip().replace("\n", "").rstrip(".")
    s = s.replace("\\!", "").replace("\\,", "").replace("\\;", "")
    # matrix environments → pmatrix
    s = re.sub(r"\\begin\{array\}\{[^}]*\}", r"\\begin{pmatrix}", s)
    s = s.replace("\\end{array}", "\\end{pmatrix}").replace("bmatrix", "pmatrix")
    s = s.replace("tfrac", "frac").replace("dfrac", "frac")
    s = s.replace("\\left", "").replace("\\right", "")
    s = s.replace("\\{", "{").replace("\\}", "}")
    # trailing \text{unit}
    s = re.sub(r"\\text\{.*?\}$", "", s).strip() or s
    # plain-word units (only when something remains)
    for unit in _UNIT_WORDS:
        cand = re.sub(r"(^|\W)" + unit + r"($|\W)", r"\1\2", s).strip()
        if cand:
            s = cand
    s = s.replace("^{\\circ}", "").replace("^\\circ", "")
    s = s.replace("\\$", "").replace("$", "")
    s = s.replace("\\(", "").replace("\\)", "")
    s = re.sub(r"\\text\{(.*?)\}", r"\1", s)
    for word, digit in _WORD_NUMBERS.items():
        if s.strip().lower() == word:
            s = digit
    # leading variable assignment / set-membership wrappers
    for key in ("x=", "y=", "z=", "x\\in", "y\\in", "z\\in"):
        if s.startswith(key):
            s = s[len(key):]
    s = s.replace("\\emptyset", "{}")
    s = s.replace(" .", " 0.")
    if s.startswith("."):
        s = "0" + s
    s = s.replace("\\mathbf", "")
    s = re.sub(r"\\mbox\{.*?\}", "", s)
    # 3.0 -> 3, 2.50 -> 2.5 (toolkit: parser.py:335-337)
    s = re.sub(r"(\d+)\.0+($|\D)", r"\1\2", s)
    s = re.sub(r"(\.\d*?)0+($|\D)", r"\1\2", s)
    s = s.rstrip(".")
    return s.strip()


def choice_answer_clean(pred: str) -> str:
    """Extract the final multiple-choice letter (grader.py:26-37): last
    standalone A–E in the text, else the stripped literal."""
    pred = str(pred).strip("\n").rstrip(".").rstrip("/").strip(" ").lstrip(":")
    hits = re.findall(r"\b(A|B|C|D|E)\b", pred.upper())
    out = hits[-1] if hits else pred.strip().strip(".")
    return out.rstrip(".").rstrip("/")


# ------------------------------------------------------------------- numerics

def parse_digits(num) -> float | None:
    """Float parse with thousands-commas, percent, and a/b fractions
    (grader.py:40-52)."""
    s = str(num).replace(",", "").strip()
    try:
        return float(s)
    except ValueError:
        pass
    if s.endswith("%"):
        s = s[:-1].rstrip("\\")
        try:
            return float(s) / 100.0
        except ValueError:
            return None
    m = re.fullmatch(r"\s*(-?[\d.]+)\s*/\s*(-?[\d.]+)\s*", s)
    if m:
        try:
            return float(m.group(1)) / float(m.group(2))
        except (ValueError, ZeroDivisionError):
            return None
    return None


def is_digit(num) -> bool:
    return parse_digits(num) is not None


def numeric_equal(prediction: float, reference: float) -> bool:
    """rel-tol 1e-4, the toolkit's GSM-Hard-calibrated tolerance
    (grader.py:263-272)."""
    from math import isclose

    return isclose(reference, prediction, rel_tol=1e-4)


# --------------------------------------------------------------- LaTeX→sympy

_SQRT_N = re.compile(r"\\sqrt\[([^\]]*)\]\{([^{}]*)\}")
_SQRT = re.compile(r"\\sqrt\{([^{}]*)\}")
_SQRT_BARE = re.compile(r"\\sqrt(\d)")
_FRAC = re.compile(r"\\[dt]?frac\{([^{}]*)\}\{([^{}]*)\}")
_FRAC_BARE = re.compile(r"\\[dt]?frac(\d)(\d)")

_LATEX_SIMPLE = [
    (r"\\left", ""), (r"\\right", ""), (r"\\cdot", "*"), (r"\\times", "*"),
    (r"\\div", "/"), (r"\\pm", "+"), (r"\\pi", "(pi)"), (r"\\infty", "oo"),
    (r"\\%", "/100"), (r"\\ln", "log"), (r"\\log", "log"), (r"\\exp", "exp"),
    (r"\\sin", "sin"), (r"\\cos", "cos"), (r"\\tan", "tan"),
    (r"\\sec", "sec"), (r"\\csc", "csc"), (r"\\cot", "cot"),
    (r"\\text\{[^}]*\}", ""), (r"\\mathrm\{[^}]*\}", ""),
    (r"\\!|\\,|\\;|\\ ", ""), (r"\$", ""), (r"\\%", ""), (r"°", ""),
]


def latex_to_expr_string(s: str) -> str:
    """Best-effort LaTeX → python-expression string. Nested frac/sqrt are
    rewritten innermost-first until fixpoint."""
    s = s.strip()
    for _ in range(8):  # nested structures: innermost braces match first
        new = _FRAC.sub(r"((\1)/(\2))", s)
        new = _SQRT_N.sub(r"((\2)**(1/(\1)))", new)
        new = _SQRT.sub(r"sqrt(\1)", new)
        if new == s:
            break
        s = new
    s = _FRAC_BARE.sub(r"((\1)/(\2))", s)
    s = _SQRT_BARE.sub(r"sqrt(\1)", s)
    for pat, rep in _LATEX_SIMPLE:
        s = re.sub(pat, rep, s)
    s = s.replace("^", "**")
    s = s.replace("{", "(").replace("}", ")")
    s = re.sub(r"(\d),(\d{3})", r"\1\2", s)  # thousands separators
    return s.strip()


def parse_math(s: str):
    """LaTeX/plain string → sympy expression (or Eq/Matrix), or None."""
    if not HAS_SYMPY or not str(s).strip():
        return None
    s = str(s).strip()
    mat = _parse_matrix_literal(s)
    if mat is not None:
        try:
            rows = [[parse_math(c) for c in row] for row in mat]
            if all(all(c is not None for c in row) for row in rows):
                return sympy.Matrix(rows)
        except Exception:
            return None
        return None
    txt = latex_to_expr_string(s)
    if "=" in txt and txt.count("=") == 1 and "==" not in txt and "<=" not in txt and ">=" not in txt:
        lhs, rhs = txt.split("=")
        try:
            return sympy.Eq(
                parse_expr(lhs, transformations=_TRANSFORMS, evaluate=True),
                parse_expr(rhs, transformations=_TRANSFORMS, evaluate=True),
            )
        except Exception:
            return None
    try:
        return parse_expr(txt, transformations=_TRANSFORMS, evaluate=True)
    except Exception:
        return None


def _parse_matrix_literal(s: str) -> list[list[str]] | None:
    """``\\begin{pmatrix} a & b \\\\ c & d \\end{pmatrix}`` → [[a,b],[c,d]]."""
    s = s.strip()
    s = re.sub(r"\\begin\{array\}\{[^}]*\}", r"\\begin{pmatrix}", s)
    s = s.replace("\\end{array}", "\\end{pmatrix}").replace("bmatrix", "pmatrix")
    m = re.fullmatch(r"\(?\\begin\{pmatrix\}(.*)\\end\{pmatrix\}\)?", s,
                     re.DOTALL)
    if not m:
        return None
    body = m.group(1)
    rows = [r.strip() for r in body.split("\\\\") if r.strip()]
    return [[c.strip() for c in r.split("&")] for r in rows] or None


def symbolic_equal(a: str, b: str, tol: float = 1e-4) -> bool:
    """sympy equivalence ladder (grader.py:276-331): direct, .equals,
    simplify(a-b)==0, equation |lhs-rhs| match, numeric N(), matrix."""
    ea, eb = parse_math(a), parse_math(b)
    if ea is None or eb is None:
        return False
    try:
        if str(ea) == str(eb) or ea == eb:
            return True
    except Exception:
        pass
    try:
        if ea.equals(eb) or sympy.simplify(ea - eb) == 0:
            return True
    except Exception:
        pass
    try:  # equations up to overall sign / rearrangement
        if (abs(ea.lhs - ea.rhs)).equals(abs(eb.lhs - eb.rhs)):
            return True
    except Exception:
        pass
    try:
        va, vb = complex(sympy.N(ea)), complex(sympy.N(eb))
        if abs(va - vb) <= tol * max(1.0, abs(va), abs(vb)):
            return True
    except Exception:
        pass
    try:  # matrices: element-wise to 3 decimals (grader.py:316-326)
        if ea.shape == eb.shape:
            _a = ea.applyfunc(lambda x: sympy.Float(x, 4))
            _b = eb.applyfunc(lambda x: sympy.Float(x, 4))
            if _a.equals(_b) or (ea - eb).norm() < tol:
                return True
    except Exception:
        pass
    return False


# ------------------------------------------------------------ decision ladder

_BRACKETED = re.compile(r"(\(|\[).+(\)|\])", re.DOTALL)


def _set_to_matrix(s: str) -> str:
    """``{a, b, c}`` set literals → pmatrix string (grader.py:59-70)."""
    groups = re.findall(r"\{.*?,.*?\}", s)
    mats = []
    for g in groups:
        body = g.strip("{}")
        mats.append("\\begin{pmatrix}" + body.replace(",", "\\\\")
                    + "\\end{pmatrix}")
    return ", ".join(mats)


def math_equal(prediction, reference, include_percentage: bool = True,
               is_close: bool = True, timeout: bool = False,
               depth: int = 0) -> bool:
    """The toolkit's full grading ladder (grader.py:73-259), freshly built:

    string → choice → numeric(±percent) → bracket-stripped → interval /
    tuple element-wise → matrix element-wise → equation → symbolic.
    """
    if prediction is None or reference is None or depth > 4:
        return False
    prediction, reference = str(prediction), str(reference)
    if prediction.strip().lower() == reference.strip().lower():
        return True
    pred_s = strip_answer_string(prediction)
    ref_s = strip_answer_string(reference)
    if pred_s.lower() == ref_s.lower():
        return True
    if normalize_math(prediction) == normalize_math(reference):
        return True
    if is_equiv(prediction, reference):
        return True

    # multiple choice: gold is a bare letter (grader.py:90-94)
    if reference.strip() in ("A", "B", "C", "D", "E") \
            and choice_answer_clean(prediction) == reference.strip():
        return True

    # numeric with percentage ambiguity (grader.py:96-116)
    if is_digit(pred_s) and is_digit(ref_s):
        pnum, rnum = parse_digits(pred_s), parse_digits(ref_s)
        cands = [rnum / 100.0, rnum, rnum * 100.0] if include_percentage else [rnum]
        for c in cands:
            if (numeric_equal(pnum, c) if is_close else pnum == c):
                return True
        return False

    if not pred_s:
        return False
    prediction, reference = pred_s, ref_s

    # {a,b} set literal vs pmatrix (grader.py:127-129)
    if "pmatrix" in prediction and "pmatrix" not in reference:
        reference = _set_to_matrix(reference) or reference
    elif "pmatrix" in reference and "pmatrix" not in prediction:
        prediction = _set_to_matrix(prediction) or prediction

    # bracket-stripped string equality (grader.py:131-146)
    ps, rs = prediction, reference
    if (ps.startswith("[") and ps.endswith("]") and not rs.startswith("(")) or \
       (ps.startswith("(") and ps.endswith(")") and not rs.startswith("[")):
        ps, rs = ps.strip("[]()"), rs.strip("[]()")
    for ch in "{}()":
        ps, rs = ps.replace(ch, ""), rs.replace(ch, "")
    if ps.lower() == rs.lower():
        return True

    # interval / tuple: element-wise recursive match (grader.py:150-166)
    if _BRACKETED.fullmatch(prediction) and _BRACKETED.fullmatch(reference):
        pp = _split_top(prediction[1:-1])
        rp = _split_top(reference[1:-1])
        if len(pp) == len(rp) and len(pp) > 1:
            if all(math_equal(pp[i], rp[i], include_percentage, is_close,
                              depth=depth + 1) for i in range(len(pp))):
                # interval kinds must agree when both look like intervals
                if prediction[0] in "([" and reference[0] in "([" and \
                        len(pp) == 2 and _is_interval(prediction) and _is_interval(reference):
                    return (prediction[0], prediction[-1]) == \
                        (reference[0], reference[-1])
                return True

    # matrix literals element-wise (grader.py:167-223)
    pm, rm = _parse_matrix_literal(prediction), _parse_matrix_literal(reference)
    if pm is not None and rm is not None:
        if len(pm) == len(rm) and all(len(a) == len(b) for a, b in zip(pm, rm)):
            if all(math_equal(a, b, include_percentage, is_close,
                              depth=depth + 1)
                   for ra, rb in zip(pm, rm) for a, b in zip(ra, rb)):
                return True

    # equations (grader.py:225-248)
    if prediction.count("=") == 1 and reference.count("=") == 1:
        pl, pr = prediction.split("=")
        rl, rr = reference.split("=")
        pd = f"({pl.strip()}) - ({pr.strip()})"
        rd = f"({rl.strip()}) - ({rr.strip()})"
        if _sym(pd, rd, timeout) or _sym(f"-({pd})", rd, timeout):
            return True
    elif prediction.count("=") == 1 and len(prediction.split("=")[0].strip()) <= 2 \
            and "=" not in reference:
        if math_equal(prediction.split("=")[1], reference,
                      include_percentage, is_close, depth=depth + 1):
            return True
    elif reference.count("=") == 1 and len(reference.split("=")[0].strip()) <= 2 \
            and "=" not in prediction:
        if math_equal(prediction, reference.split("=")[1],
                      include_percentage, is_close, depth=depth + 1):
            return True

    return _sym(prediction, reference, timeout)


def _is_interval(s: str) -> bool:
    """Heuristic: a 2-element bracketed group whose ends differ in kind or
    that uses mixed brackets reads as an interval, e.g. ``(0, 1]``."""
    return s[0] in "([" and s[-1] in ")]" and (s[0] == "(" or s[-1] == "]") \
        and not (s[0] == "(" and s[-1] == ")")


def _split_top(s: str) -> list[str]:
    """Split on commas at top-level brace/paren depth."""
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur).strip())
    return parts


def _sym(a: str, b: str, timeout: bool) -> bool:
    if timeout:
        return call_with_timeout(symbolic_equal, a, b)
    return symbolic_equal(a, b)


def call_with_timeout(func, *args, timeout: float = 3.0, **kwargs) -> bool:
    """Run ``func`` in a worker process with a hard kill (grader.py:333-345):
    sympy's simplify can hang on adversarial inputs."""
    import multiprocessing as mp

    ctx = mp.get_context("fork")
    q = ctx.Queue()

    def run(q, args, kwargs):
        try:
            q.put(bool(func(*args, **kwargs)))
        except Exception:
            q.put(False)

    p = ctx.Process(target=run, args=(q, args, kwargs))
    p.start()
    p.join(timeout)
    if p.is_alive():
        p.terminate()
        p.join()
        return False
    try:
        return q.get_nowait()
    except Exception:
        return False


def extract_math_answer(output: str) -> str:
    """Pull the final math answer from model output: boxed first, then
    ``ANSWER:``, then the last number-like token (parser.py:499-574)."""
    boxed = extract_boxed(output)
    if boxed:
        return strip_answer_string(boxed)
    if "ANSWER:" in output:
        return strip_answer_string(output.split("ANSWER:")[-1].strip().strip("*"))
    nums = re.findall(r"-?\d[\d,]*(?:\.\d+)?(?:/\d+)?", output.replace(",", ""))
    return nums[-1] if nums else ""
