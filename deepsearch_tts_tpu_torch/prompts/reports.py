"""Report-generation prompt set (WebThinker report mode).

The port's own copy of ``prompts/reports.py`` (same behaviour; imports resolve in this package).

Covers the same surface as the reference's prompts_report.py
(scripts/prompts/prompts_report.py:2-311): plan → per-section write / check /
edit → title → final polish, plus RAG-baseline report prompts. Fresh prose;
the artifact contracts (markdown sections, JSON plan) are kept.
"""
from __future__ import annotations

from .qa import (
    BEGIN_SEARCH_QUERY,
    BEGIN_SEARCH_RESULT,
    END_SEARCH_QUERY,
    END_SEARCH_RESULT,
)

# report-mode in-band control tokens (reference: prompts_report.py:2-66; the
# WebThinker loop splices system output back at these markers)
BEGIN_WRITE_SECTION = "<|begin_write_section|>"
END_WRITE_SECTION = "<|end_write_section|>"
BEGIN_CHECK_ARTICLE = "<|begin_check_article|>"
END_CHECK_ARTICLE = "<|end_check_article|>"
BEGIN_EDIT_ARTICLE = "<|begin_edit_article|>"
END_EDIT_ARTICLE = "<|end_edit_article|>"

REPORT_DONE_PHRASE = "I have finished my work."


def get_report_webthinker_instruction(question: str, plan: str) -> str:
    """Main report-mode agent prompt: research with in-band searches, then
    drive section writing / article checking / editing through the four
    token families (reference: prompts_report.py:2-66). Contracts: all six
    token pairs, and the literal stop phrase ``I have finished my work.``"""
    return f"""You are a research assistant who writes a scientific research article with the help of web searches. You have special tools:

- To perform a search: write {BEGIN_SEARCH_QUERY} your query here {END_SEARCH_QUERY}.
The system searches, analyzes the relevant web pages, and hands the useful content back between {BEGIN_SEARCH_RESULT} and {END_SEARCH_RESULT}.

- To write a section of the article: write {BEGIN_WRITE_SECTION}section name
contents to write{END_WRITE_SECTION}. The system writes that section in full from your request and the information gathered so far.

- To check the current article: write {BEGIN_CHECK_ARTICLE}system returns outline of all current written contents{END_CHECK_ARTICLE}.

- To edit the article: write {BEGIN_EDIT_ARTICLE}your detailed edit goal and instruction{END_EDIT_ARTICLE}. The system applies the edit using your instruction and the gathered information.

Your task is to research and write a scientific article about:
{question}

Here is a research plan to guide your investigation:
{plan}

Follow the plan step by step:
1. Search the web for detailed information on each point.
2. After each search, decide what is still missing.
3. When a section's material is sufficient, request that section be written.
4. Repeat until the whole article exists.
5. Check the article and edit sections where clarity or completeness is lacking.

Example:
{BEGIN_SEARCH_QUERY}first search query{END_SEARCH_QUERY}

{BEGIN_SEARCH_RESULT}Summary of information from searched web pages{END_SEARCH_RESULT}

From these results I understand X but still need Y...

{BEGIN_SEARCH_QUERY}follow-up query focusing on Y{END_SEARCH_QUERY}

{BEGIN_SEARCH_RESULT}Summary of information from searched web pages{END_SEARCH_RESULT}

Now I can write the first section...

{BEGIN_WRITE_SECTION}Introduction
This section should introduce ... {END_WRITE_SECTION}

With the introduction written, I gather material for the next section ...

{BEGIN_CHECK_ARTICLE}System returns outline of current written article{END_CHECK_ARTICLE}

I notice a gap to fix ...

{BEGIN_EDIT_ARTICLE}your edit instruction{END_EDIT_ARTICLE}

...and so on until the article is complete.

Remember:
- Use {BEGIN_SEARCH_QUERY}query{END_SEARCH_QUERY} to get information from web searches.
- Use {BEGIN_WRITE_SECTION}section name
contents to write{END_WRITE_SECTION} to have the system write a section.
- Use {BEGIN_CHECK_ARTICLE}outline of current article{END_CHECK_ARTICLE} to check the current article.
- Use {BEGIN_EDIT_ARTICLE}edit instruction{END_EDIT_ARTICLE} to have the system edit and improve the article.
- Strictly follow the above format when calling the functions.
- Do not propose methods or design experiments; your task is comprehensive web research.
- Do not omit any key points from the article.
- When the article is complete, output "{REPORT_DONE_PHRASE}" and stop.

Now begin your research and write the article about:
{question}
"""


def get_search_plan_instruction(query: str) -> str:
    """Numbered research plan, the report loop's seed (reference:
    prompts_report.py:72-89). Contract: numbered ``(1) ...`` steps, at most
    8, no extra words."""
    return f"""Help me lay out a detailed plan for researching the following question over the web:
{query}

The aim is to gather all the information needed to thoroughly address the question.
Note:
- No need to mention citations or references.
- Do not propose methods or design experiments; the task is web research only.
- Be comprehensive — leave out nothing relevant.
- No more than 8 steps.

Output the plan as numbered steps like:
(1) ...
(2) ...
etc.

Directly output the plan, do not include any other words."""


def get_section_summary_instruction(section: str) -> str:
    """Per-paragraph compression used when assembling the article outline
    (reference: prompts_report.py:196-199)."""
    return f"""Provide an extremely concise summary of each paragraph or subsection in the following section:
{section}
"""


def get_edit_article_instruction(edit_instruction: str, article: str) -> str:
    """Whole-article edit (reference: prompts_report.py:202-224). Contract:
    the COMPLETE modified article inside a ```markdown block."""
    return f"""You are a professional article editor. Apply the edit instruction below to the article.

Edit instruction:
{edit_instruction}

Current article:
{article}

Output the complete modified article with every requested change applied.

Note:
- Keep all original content that needs no modification (output the entire article, not just the changed parts).
- Make every edit the instruction asks for.
- Output format:
```markdown
...
```

Provide the complete modified article in markdown format."""


def get_report_plan_instruction(question: str) -> str:
    return f"""Draft an outline for a research report that answers the question below. Return a JSON object of the form {{"title": ..., "sections": [{{"name": ..., "goal": ...}}, ...]}} with 4-8 sections, ordered logically from background to conclusion.

Question: {question}
"""


def get_section_write_instruction(question: str, plan: str, section_name: str,
                                  section_goal: str, evidence: str,
                                  written_so_far: str) -> str:
    return f"""You are writing one section of a research report.

Report question: {question}
Report plan: {plan}
Section to write now: {section_name}
Section goal: {section_goal}

Evidence collected from the web:
{evidence}

Report so far:
{written_so_far}

Write the complete markdown for this section only (start with '## {section_name}'). Ground every claim in the evidence; do not invent citations."""


def get_section_check_instruction(section_name: str, section_text: str,
                                  evidence: str) -> str:
    return f"""Review the report section below against the evidence. List any factual claims not supported by the evidence, missing key facts, or incoherent passages. If the section is fine, reply "OK".

Section ({section_name}):
{section_text}

Evidence:
{evidence}
"""


def get_section_edit_instruction(section_name: str, section_text: str,
                                 feedback: str) -> str:
    return f"""Rewrite the report section below to address the reviewer feedback, preserving correct content. Return only the revised markdown.

Section ({section_name}):
{section_text}

Feedback:
{feedback}
"""


def get_report_title_instruction(question: str, report: str) -> str:
    return f"""Give this report a concise, informative title (one line, no quotes).

Question: {question}

Report:
{report[:4000]}
"""


def get_final_report_instruction(question: str, draft: str) -> str:
    return f"""Polish the draft report below into its final form: fix transitions between sections, remove redundancy, ensure the introduction previews and the conclusion answers the question. Keep all factual content. Return the full markdown report.

Question: {question}

Draft:
{draft}
"""


def get_rag_report_instruction(question: str, documents: str) -> str:
    return f"""Write a well-structured research report (markdown, with sections) answering the question below, using only the retrieved documents provided.

Question: {question}

Documents:
{documents}
"""


def get_direct_report_instruction(question: str) -> str:
    return f"""Write a well-structured research report (markdown, with sections) answering:

{question}
"""


# ---- reference-name surface --------------------------------------------------
# Every ``get_*`` in the reference's prompts_report.py resolves under its
# exact name (reference: scripts/prompts/prompts_report.py:163-311), so code
# written against the reference imports drop-in. The four QA-side names that
# the reference keeps in prompts_report.py (deep_web_explorer,
# click_web_page_reader, search_intent, click_intent) live in prompts/qa.py
# under identical names and are re-validated by tests/test_prompts.py.


def get_write_section_instruction(question: str, previous_thoughts: str,
                                  relevant_documents: str, section_name: str,
                                  task: str, current_article: str) -> str:
    """Reference-signature section writer (prompts_report.py:163-193):
    (question, previous_thoughts, relevant_documents, section_name, task,
    current_article) — maps onto :func:`get_section_write_instruction`."""
    return get_section_write_instruction(
        question=question, plan=previous_thoughts,
        section_name=section_name, section_goal=task,
        evidence=relevant_documents, written_so_far=current_article)


def get_edit_section_instruction(edit_instruction: str, article: str) -> str:
    """Targeted section edit (reference: prompts_report.py:225-247).

    Contract differs from :func:`get_edit_article_instruction`: the model
    outputs TWO ```markdown blocks — the untouched original section (so the
    report loop can locate it by string match) followed by the modified
    section — instead of the whole article."""
    return f"""You are a professional article editor. Apply the edit instruction below to the article.

Edit instruction:
{edit_instruction}

Current article:
{article}

First output the entire section/subsection that needs modification exactly as it appears, then output that entire section/subsection with the edit applied — both in markdown format.

Output Format:

Entire section/subsection to modify:
```markdown
...
```

Entire modified section/subsection:
```markdown
...
```
"""


def get_title_instruction(question: str, article: str) -> str:
    """Reference name for :func:`get_report_title_instruction`
    (prompts_report.py:250-259)."""
    return get_report_title_instruction(question, article)


def get_standard_rag_report_instruction(question: str, documents: str) -> str:
    """Reference name for :func:`get_rag_report_instruction`
    (prompts_report.py:284-297)."""
    return get_rag_report_instruction(question, documents)


def get_direct_gen_report_instruction(question: str) -> str:
    """Reference name for :func:`get_direct_report_instruction`
    (prompts_report.py:300-311)."""
    return get_direct_report_instruction(question)


# ---- pairwise report judging (evaluate_report equivalent) -------------------

REPORT_JUDGE_DIMENSIONS = ("comprehensiveness", "thoroughness", "factuality", "coherence")


def get_report_evaluation_instruction(question: str, reports: dict[str, str]) -> str:
    """Multi-system comparative scoring, 0-10 per dimension per system
    (reference: scripts/evaluate/evaluate_report.py:57-173)."""
    blocks = "\n\n".join(
        f"[System {name} Report Start]\n{text}\n[System {name} Report End]"
        for name, text in reports.items()
    )
    dims = ", ".join(REPORT_JUDGE_DIMENSIONS)
    return f"""You are comparing research reports produced by different systems for the same question. Score each system on: {dims} — each 0-10 (10 best). Judge strictly from the report contents.

Question: {question}

{blocks}

Return a JSON object: {{"<system name>": {{"comprehensiveness": n, "thoroughness": n, "factuality": n, "coherence": n}}, ...}} with no other text."""
