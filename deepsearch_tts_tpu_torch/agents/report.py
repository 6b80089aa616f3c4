"""Report-generation agent (WebThinker report mode).

The port's own copy of ``agents/report.py`` (same behaviour; imports resolve in this package).

The reference's report path (prompts in scripts/prompts/prompts_report.py,
driven by the WebThinker loop; evaluated by evaluate_report.py) produces a
long-form research report: plan sections → per-section evidence search →
write → check → edit → title + final polish. This module is that pipeline
as an explicit async state machine over the same client/search seams as the
QA agent.
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

from ..prompts import reports as RP


@dataclass
class ReportResult:
    title: str
    report: str
    plan: dict
    sections: list[dict] = field(default_factory=list)


def _parse_plan(text: str, question: str) -> dict:
    m = re.search(r"\{.*\}", text, re.DOTALL)
    if m:
        try:
            plan = json.loads(m.group(0))
            if isinstance(plan.get("sections"), list) and plan["sections"]:
                return plan
        except json.JSONDecodeError:
            pass
    return {"title": question[:80], "sections": [
        {"name": "Background", "goal": f"context for: {question}"},
        {"name": "Analysis", "goal": f"evidence answering: {question}"},
        {"name": "Conclusion", "goal": "answer the question directly"},
    ]}


async def generate_report(
    question: str,
    client,
    search_tool,
    *,
    max_sections: int = 8,
    searches_per_section: int = 1,
    check_and_edit: bool = True,
    gen_opts: dict | None = None,
) -> ReportResult:
    gen_opts = dict(gen_opts or {})
    plan_resp = await client.complete(RP.get_report_plan_instruction(question),
                                      **gen_opts)
    plan = _parse_plan(plan_resp.text, question)
    sections = plan["sections"][:max_sections]

    written: list[dict] = []
    report_so_far = ""
    for sec in sections:
        name = str(sec.get("name", "Section"))
        goal = str(sec.get("goal", question))
        evidence_blocks = []
        for _ in range(searches_per_section):
            result = await search_tool.search_with_intent(
                f"{question} {name}", goal)
            evidence_blocks.append(result["extracted_info"])
        evidence = "\n\n".join(evidence_blocks)

        draft = await client.complete(RP.get_section_write_instruction(
            question, json.dumps(plan), name, goal, evidence,
            report_so_far[-6000:]), **gen_opts)
        text = draft.text.strip()

        if check_and_edit:
            review = await client.complete(RP.get_section_check_instruction(
                name, text, evidence), **gen_opts)
            feedback = review.text.strip()
            if feedback and feedback.upper() != "OK":
                edited = await client.complete(RP.get_section_edit_instruction(
                    name, text, feedback), **gen_opts)
                if edited.text.strip():
                    text = edited.text.strip()

        written.append({"name": name, "goal": goal, "text": text,
                        "evidence": evidence})
        report_so_far += "\n\n" + text

    final = await client.complete(RP.get_final_report_instruction(
        question, report_so_far), **gen_opts)
    report = final.text.strip() or report_so_far.strip()
    title_resp = await client.complete(RP.get_report_title_instruction(
        question, report), **gen_opts)
    title = title_resp.text.strip().splitlines()[0] if title_resp.text.strip() else plan.get("title", "")
    return ReportResult(title=title, report=report, plan=plan, sections=written)
