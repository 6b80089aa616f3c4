"""Benchmark dataset loading.

The port's own copy of ``datasets/loaders.py`` (same behaviour; imports resolve in this package).

Handles the 10 benchmark formats shipped by the reference under ``data/``
(reference: data/*/; key aliasing semantics at scripts/deep_search.py:4236-4242
— a record's question may live under ``question``, ``Question``, ``problem``,
or ``prompt``). Also implements the XOR-canary decryption used by the
BrowseComp / xbench datasets (reference: data/xbench-deepsearch/decrypt.py:4-20).
"""
from __future__ import annotations

import base64
import csv
import json
import os
from dataclasses import dataclass
from typing import Callable


def xor_decrypt(data: bytes, key: str) -> bytes:
    """XOR a byte string against a repeating UTF-8 key (canary scheme)."""
    kb = key.encode("utf-8")
    n = len(kb)
    return bytes(b ^ kb[i % n] for i, b in enumerate(data))


def decrypt_canary_field(value: str, canary: str) -> str:
    """Decode a base64+XOR'd dataset field using its per-row canary key."""
    return xor_decrypt(base64.b64decode(value), canary).decode("utf-8")


QUESTION_KEYS = ("question", "Question", "problem", "prompt", "task", "query")
ANSWER_KEYS = ("answer", "Answer", "labeled_answer", "Correct Answer")


def extract_question(record: dict) -> str:
    """Pull the question text out of a record, honoring all key aliases."""
    for k in QUESTION_KEYS:
        v = record.get(k)
        if isinstance(v, str) and v.strip():
            return v
    return ""


def extract_answer(record: dict) -> str:
    for k in ANSWER_KEYS:
        v = record.get(k)
        if isinstance(v, str) and v.strip():
            return v
    return ""


@dataclass
class DatasetSpec:
    """Static description of one benchmark."""

    name: str
    default_file: str
    domain_field: str | None = None  # e.g. GAIA "Level", GPQA "High-level domain"
    mode: str = "qa"                 # eval extraction mode: qa / choose / math / research
    encrypted_fields: tuple[str, ...] = ()  # fields XOR'd with the row canary
    postprocess: Callable[[dict], dict] | None = None


def _gpqa_choices(rec: dict) -> dict:
    """GPQA rows carry 4 answer options; render a multiple-choice question."""
    if "Correct Answer" in rec and "Question" in rec and "choices_rendered" not in rec:
        import random

        opts = [rec.get("Correct Answer", "")] + [
            rec.get(f"Incorrect Answer {i}", "") for i in (1, 2, 3)
        ]
        rng = random.Random(rec.get("id", 0))
        order = list(range(4))
        rng.shuffle(order)
        letters = "ABCD"
        lines = []
        correct_letter = "A"
        for pos, oi in enumerate(order):
            lines.append(f"({letters[pos]}) {opts[oi]}")
            if oi == 0:
                correct_letter = letters[pos]
        rec = dict(rec)
        rec["Question"] = rec["Question"].rstrip() + "\n\nChoices:\n" + "\n".join(lines)
        rec["Correct Choice"] = rec.get("Correct Choice", correct_letter)
        rec["choices_rendered"] = True
    return rec


DATASET_REGISTRY: dict[str, DatasetSpec] = {
    "browsecomp_en": DatasetSpec("browsecomp_en", "BrowseCompEN/test.json"),
    "browsecomp_en_sample100": DatasetSpec(
        "browsecomp_en_sample100", "BrowseCompEN-Sample100/all_data_random100_sample1.json"
    ),
    "browsecomp_zh": DatasetSpec("browsecomp_zh", "BrowseCompZH/test.json"),
    "browsecomp_zh_sample100": DatasetSpec(
        "browsecomp_zh_sample100", "BrowseCompZH-Sample100/all_data_random100_sample1.json"
    ),
    "gaia": DatasetSpec("gaia", "GAIA/dev.json", domain_field="Level"),
    "gpqa": DatasetSpec(
        "gpqa", "GPQA/diamond.json", domain_field="High-level domain",
        mode="choose", postprocess=_gpqa_choices,
    ),
    "hle": DatasetSpec("hle", "HLE/test.json", domain_field="category"),
    "webwalkerqa": DatasetSpec("webwalkerqa", "WebWalkerQA/test.json", domain_field="domain"),
    "xbench_deepsearch": DatasetSpec("xbench_deepsearch", "xbench-deepsearch/dev.json"),
    "glaive": DatasetSpec("glaive", "Glaive/test.json", mode="research"),
}


def load_records(path: str) -> list[dict]:
    """Load a JSON (list of dicts) or canary-encrypted CSV dataset file."""
    if path.endswith(".csv"):
        out = []
        with open(path, encoding="utf-8-sig") as f:
            for row in csv.DictReader(f):
                canary = row.get("canary", "")
                if canary:
                    for fkey in ("prompt", "answer"):
                        if row.get(fkey):
                            row[fkey] = decrypt_canary_field(row[fkey], canary)
                row.setdefault("problem", row.get("prompt", ""))
                row.setdefault("Question", row.get("prompt", ""))
                out.append(row)
        return out
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = data.get("data", [data])
    return data


def load_dataset(
    name_or_path: str, data_root: str | None = None, limit: int | None = None
) -> list[dict]:
    """Load a benchmark by registry name or raw file path.

    Every returned record is normalized to have ``Question`` populated; other
    fields pass through untouched so the output trace keeps them (the
    reference copies the input record into its result rows,
    scripts/deep_search.py:2651).
    """
    spec = DATASET_REGISTRY.get(name_or_path.lower().replace("-", "_"))
    if spec is not None:
        root = data_root or os.environ.get("DSTTS_DATA_ROOT", "./data")
        path = os.path.join(root, spec.default_file)
    else:
        spec, path = None, name_or_path
    records = load_records(path)
    out = []
    for rec in records:
        if spec and spec.postprocess:
            rec = spec.postprocess(rec)
        q = extract_question(rec)
        if q and "Question" not in rec:
            rec = {**rec, "Question": q}
        out.append(rec)
        if limit and len(out) >= limit:
            break
    return out
