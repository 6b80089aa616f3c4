"""Prompt library (QA / search / verification).

The port's own copy of ``prompts/qa.py`` (same behaviour; imports resolve in this package).

Fresh prose, reference-compatible *contracts* (reference:
scripts/prompts/prompts.py — 27 ``get_*`` functions; scripts/deep_search.py
:4044-4050 solver, :4143-4167 verifier set). The load-bearing interface
elements are preserved exactly:

* in-band control tokens ``<|begin_search_query|>`` / ``<|end_search_query|>``
  and ``<|begin_click_link|>`` / ``<|end_click_link|>``
* the ``**Final Information**`` marker the answer extractor keys on
* ``\\boxed{...}`` final-answer / confidence-score formats
* verifier confidence = verified conditions / total conditions
"""
from __future__ import annotations

BEGIN_SEARCH_QUERY = "<|begin_search_query|>"
END_SEARCH_QUERY = "<|end_search_query|>"
BEGIN_SEARCH_RESULT = "<|begin_search_result|>"
END_SEARCH_RESULT = "<|end_search_result|>"
BEGIN_CLICK_LINK = "<|begin_click_link|>"
END_CLICK_LINK = "<|end_click_link|>"
BEGIN_CLICK_RESULT = "<|begin_click_result|>"
END_CLICK_RESULT = "<|end_click_result|>"

DEEP_WEBSEARCH_TOOL = {
    "type": "function",
    "function": {
        "name": "deep_websearch",
        "description": (
            "A web explorer that searches the web, opens the result pages, and "
            "extracts factual information relevant to a search query and the "
            "intent behind it."
        ),
        "parameters": {
            "type": "object",
            "required": ["search_query", "search_intent"],
            "properties": {
                "search_query": {
                    "type": "string",
                    "description": (
                        "Query to submit to a standard web search engine; keep "
                        "it in normal search-engine style."
                    ),
                },
                "search_intent": {
                    "type": "string",
                    "description": (
                        "What you are actually trying to find out with this "
                        "search, so the explorer can judge relevance."
                    ),
                },
            },
        },
    },
}


def get_solver_system_prompt(max_search_calls: int) -> str:
    return f"""You are a reasoning assistant with access to web search for solving problems. Call the "deep_websearch" tool whenever you need facts or evidence you are not certain about. You may call it repeatedly, but no more than **{max_search_calls} times** in total.

When you are done, state your final answer inside a boxed environment:

\\[
\\boxed{{<your final answer>}}
\\]"""


def get_verifier_system_prompt(max_search_calls: int, version: int = 0) -> str:
    """Asymmetric-verification prompts. version 0 is the default used in runs;
    1..5 keep the historical variants' semantics for ablations."""
    base_tool = (
        f'Use the "deep_websearch" tool to gather supporting evidence; you may '
        f"call it up to {max_search_calls} times."
    )
    if version in (0, 5):
        return f"""You are a reasoning assistant whose only job is to fact-check a predicted answer to a user's question — do not answer the question yourself. {base_tool}

Work through these steps:

1. Read the question and list every condition a correct answer must satisfy (conditions come from the question, not from the predicted answer).
2. For each condition, use deep_websearch to find evidence and decide whether the predicted answer satisfies it. A condition counts as verified only when (i) search results explicitly support it and (ii) those results confirm the predicted answer meets it.
3. Compute a confidence score = (conditions both verified via deep_websearch and satisfied) / (total conditions).

Report the score as a float in:

\\[
\\boxed{{\\text{{<confidence_score>}}}}
\\]"""
    if version == 1:
        return f"""You are a reasoning assistant that fact-checks a predicted answer to a user's question using web search. {base_tool}

Steps: list all conditions the predicted answer must satisfy; verify each one; then report confidence = satisfied conditions / total conditions as a float between 0 and 1 in:

\\[
\\boxed{{<confidence_score>}}
\\]"""
    if version == 2:
        return f"""You are a reasoning assistant that fact-checks a predicted answer using web search. {base_tool}

List the conditions the answer must satisfy, verify each via deep_websearch, and report confidence = verified conditions / total conditions. If the predicted answer does not actually answer the question, report 0.

\\[
\\boxed{{\\text{{<confidence_score>}}}}
\\]"""
    if version == 3:
        return f"""You are a reasoning assistant verifying whether a predicted answer is the true answer to a question, using web search. {base_tool}

Your confidence score is the fraction of the question's conditions you verified through deep_websearch. A predicted answer that gives no clear answer scores 0. Report it as a float:

\\[
\\boxed{{\\text{{<confidence_score>}}}}
\\]"""
    # version 4
    return f"""You are a reasoning assistant that fact-checks a predicted answer with web search. {base_tool}

List all conditions, gather evidence for each with deep_websearch, and report confidence = (conditions verified through search) / (total conditions) as a float:

\\[
\\boxed{{\\text{{<confidence_score>}}}}
\\]"""


def get_verify_user_message(question: str, pred_answer: str) -> str:
    return (f"[Question Start]\n{question}\n[Question End]\n\n"
            f"[Predicted Answer Start]\n{pred_answer}\n[Predicted Answer End]")


def get_budget_forcing_nudge(max_search_calls: int, mode: str) -> str:
    if mode.startswith("verify"):
        return (f"Your verification so far may be incomplete. I will give you up to "
                f"{max_search_calls} additional search chances — continue verifying "
                "the remaining conditions, then report your updated confidence "
                "score in \\[\\boxed{\\text{<confidence_score>}}\\].")
    return (f"Your answer may be wrong or incomplete. I will give you up to "
            f"{max_search_calls} additional search chances — continue "
            "investigating, then give your final answer in \\[\\boxed{...}\\].")


def get_search_intent_instruction(prior_reasoning: str) -> str:
    return f"""Based on the partial reasoning below, state in one or two sentences what the author is trying to find out with their latest search query (the intent behind it). Output only the intent.

Reasoning so far:
{prior_reasoning}

Intent:"""


def get_click_intent_instruction(prior_reasoning: str) -> str:
    return f"""Based on the partial reasoning below, state in one or two sentences why the author wants to open the most recently mentioned link. Output only the intent.

Reasoning so far:
{prior_reasoning}

Intent:"""


def get_deep_web_explorer_instruction(search_query: str, search_intent: str,
                                      search_result: str) -> str:
    return f"""You are a web explorer. Your task: gather the information that satisfies the search intent below, using the search results provided — and, when needed, further searches or page visits.

- To run another web search: write {BEGIN_SEARCH_QUERY} your query {END_SEARCH_QUERY}
- To open a page from results: write {BEGIN_CLICK_LINK} the URL {END_CLICK_LINK}

You can repeat these actions as needed. When you have what you need (or exhaust your budget), finish with a summary that starts exactly with:

**Final Information**

followed by the helpful, factual information you found (or "No helpful information found." if nothing relevant turned up).

Search query: {search_query}
Search intent: {search_intent}

Initial search results:
{search_result}
"""


def get_web_page_reader_instruction(goal: str, page_text: str) -> str:
    return f"""Extract from the page content below everything relevant to this goal, quoting factual details precisely. Start your output with **Final Information** and include only the relevant content (or state that nothing relevant appears).

Goal: {goal}

Page content:
{page_text}
"""


def get_click_web_page_reader_instruction(click_intent: str, page_text: str) -> str:
    return get_web_page_reader_instruction(click_intent, page_text)


# ---- search-o1-style task system prompts (token-in-band agent / demo path) --

def _inband_header(max_search_limit: int) -> str:
    return f"""You can search the web while reasoning. Whenever you are uncertain about a fact, write {BEGIN_SEARCH_QUERY} your query {END_SEARCH_QUERY} and stop; the system will run the search and insert results between {BEGIN_SEARCH_RESULT} and {END_SEARCH_RESULT}, after which you continue reasoning. You may search up to {max_search_limit} times."""


def get_task_instruction_openqa(question: str, max_search_limit: int = 10) -> str:
    return f"""{_inband_header(max_search_limit)}

Answer the following question. Provide your final answer in the form \\boxed{{YOUR_ANSWER}}.

Question: {question}
"""


def get_task_instruction_multi_hop(question: str, max_search_limit: int = 10) -> str:
    return f"""{_inband_header(max_search_limit)}

Answer the following multi-hop question by breaking it into sub-questions and searching for each. Provide your final answer in the form \\boxed{{YOUR_ANSWER}}.

Question: {question}
"""


def get_task_instruction_math(question: str, max_search_limit: int = 10,
                              few_shot: int = 0) -> str:
    """``few_shot > 0`` prepends worked CoT examples from the example bank
    (evaluate/math_examples.py — the qwen toolkit's few-shot capability)."""
    shots = ""
    if few_shot:
        from ..evaluate.math_examples import MATH_EXAMPLES

        rendered = "\n\n".join(
            f"Question: {ex['question']}\nSolution: {ex['solution']}"
            for ex in MATH_EXAMPLES[:few_shot])
        shots = f"Worked examples:\n\n{rendered}\n\n"
    return f"""{_inband_header(max_search_limit)}

{shots}Solve the following math problem step by step. Provide your final answer in the form \\boxed{{YOUR_ANSWER}}.

Problem: {question}
"""


def get_task_instruction_choose(question: str, max_search_limit: int = 10) -> str:
    return f"""{_inband_header(max_search_limit)}

Answer the following multiple-choice question. Provide the letter of the correct choice in the form \\boxed{{YOUR_CHOICE}}.

Question: {question}
"""


def get_task_instruction_timeline(question: str, max_search_limit: int = 10) -> str:
    return f"""{_inband_header(max_search_limit)}

Answer the following question about the timing/ordering of events. Verify dates with searches, then provide your final answer in the form \\boxed{{YOUR_ANSWER}}.

Question: {question}
"""


def get_task_instruction_code(question: str, max_search_limit: int = 10) -> str:
    return f"""{_inband_header(max_search_limit)}

Solve the following programming problem. Provide your final solution as a complete program inside a ```python code block.

Problem: {question}
"""


def _search_o1_instruction(example: str, max_search_limit: int,
                           opening: str | None = None,
                           closing: str = "") -> str:
    """Search-o1-style in-band system prompt skeleton (reference:
    prompts.py:169-345 — six task-family variants sharing one frame).
    Contract: the search tokens, the search-budget sentence, and an
    example exchange showing one in-band search."""
    opening = opening or ("You are a reasoning assistant with the ability to "
                          "perform web searches to help you answer the "
                          "user's question accurately.")
    return (
        f"{opening} You have special tools:\n\n"
        f"- To perform a search: write {BEGIN_SEARCH_QUERY} your query here {END_SEARCH_QUERY}.\n"
        "The system will then search, analyze relevant web pages, and hand you "
        f"the useful content in the format {BEGIN_SEARCH_RESULT} ...search results... {END_SEARCH_RESULT}.\n\n"
        "You can repeat the search process multiple times if necessary. "
        f"The maximum number of search attempts is limited to {max_search_limit}.\n\n"
        "Once you have all the information you need, continue your reasoning.\n\n"
        f"Example:\n{example}\n"
        "(System returns processed information from relevant web pages)\n\n"
        "Assistant continues reasoning with the new information...\n\n"
        "Remember:\n"
        f"- Use {BEGIN_SEARCH_QUERY} to request a web search and end with {END_SEARCH_QUERY}.\n"
        "- When done searching, continue your reasoning.\n"
        f"{closing}\n"
    )


def get_singleqa_search_o1_instruction(max_search_limit: int) -> str:
    example = (
        'Question: "Which lab announced the first room-temperature '
        'superconductor claim of 2023?"\n'
        "Assistant thinking steps:\n"
        "- I should look up 2023 room-temperature superconductor announcements.\n\n"
        "Assistant:\n"
        f"{BEGIN_SEARCH_QUERY}room temperature superconductor 2023 "
        f"announcement{END_SEARCH_QUERY}\n")
    return _search_o1_instruction(example, max_search_limit)


def get_multiqa_search_o1_instruction(max_search_limit: int) -> str:
    example = (
        'Question: "The composer of the Interstellar soundtrack founded '
        'which remote-scoring company?"\n'
        "Assistant thinking steps:\n"
        "- First I need the composer of the Interstellar soundtrack.\n"
        "- Then I need the company that composer founded.\n\n"
        "Assistant:\n"
        f"{BEGIN_SEARCH_QUERY}Interstellar soundtrack composer{END_SEARCH_QUERY}\n\n"
        "(System returns processed information from relevant web pages)\n\n"
        "Assistant thinks: the results name the composer; now find the "
        "company they founded.\n\n"
        "Assistant:\n"
        f"{BEGIN_SEARCH_QUERY}company founded by Interstellar composer{END_SEARCH_QUERY}\n")
    return _search_o1_instruction(example, max_search_limit)


def get_gpqa_search_o1_instruction(max_search_limit: int) -> str:
    example = (
        'Question: "What is the energy range of pp III neutrinos?"\n'
        "Assistant thinking steps:\n"
        "- I might need to look up details about pp III neutrinos.\n\n"
        "Assistant:\n"
        f"{BEGIN_SEARCH_QUERY}pp III neutrino energy spectrum{END_SEARCH_QUERY}\n")
    return _search_o1_instruction(example, max_search_limit)


def get_math_search_o1_instruction(max_search_limit: int) -> str:
    example = (
        'Question: "How do you compute the integral of e^(x^2) dx?"\n'
        "Assistant thinking steps:\n"
        "- I might need to look up techniques for integrating e^(x^2).\n\n"
        "Assistant:\n"
        f"{BEGIN_SEARCH_QUERY}methods to integrate e^(x^2){END_SEARCH_QUERY}\n")
    return _search_o1_instruction(example, max_search_limit)


def get_code_search_o1_instruction(max_search_limit: int) -> str:
    example = (
        'Question: "Find the minimum number of vertices in a Steiner tree '
        'that includes all specified vertices in a given tree."\n'
        "Assistant thinking steps:\n"
        "- I need to understand the Steiner tree problem on trees before "
        "coding a solution.\n\n"
        "Assistant:\n"
        f"{BEGIN_SEARCH_QUERY}Minimum Steiner Tree problem in trees{END_SEARCH_QUERY}\n")
    return _search_o1_instruction(example, max_search_limit)


def get_timeline_search_o1_instruction(max_search_limit: int) -> str:
    example = (
        'Text: "Create a timeline of key events in the Apollo 11 mission."\n'
        "Assistant thinking steps:\n"
        "- I need key dates and events of the Apollo 11 mission.\n\n"
        "Assistant:\n"
        f"{BEGIN_SEARCH_QUERY}Apollo 11 mission timeline key events dates{END_SEARCH_QUERY}\n")
    return _search_o1_instruction(
        example, max_search_limit,
        opening=("You are a reasoning assistant with the ability to perform "
                 "web searches to help you create an accurate chronological "
                 "timeline summary."),
        closing=("- You should perform as many searches as possible to "
                 "gather comprehensive information.\n"))


def get_task_instruction_multi_choice(question: str,
                                      model_name: str | None = None) -> str:
    """Multiple-choice task wrapper with per-model answer formats
    (reference: prompts.py:563-585 — qwq/dpsk/llama variants). Contract:
    \\boxed{YOUR_CHOICE}, except dpsk's **ANSWER: {...}** marker (both are
    what evaluate/extract.py keys on)."""
    if model_name == "dpsk":
        return ("Please answer the following multiple-choice question.\n\n"
                "Provide your final choice in the format "
                "**ANSWER: {YOUR_CHOICE}**.\n\n"
                f"Question:\n{question}\n\n")
    if model_name == "llama":
        return ("Please answer the following multiple-choice question. You "
                "should think step by step to solve it.\n\n"
                "Provide your final choice in the format "
                "\\boxed{YOUR_CHOICE}. Your final choice should be one of "
                "the letters A, B, C, or D, DO NOT include any answer "
                "content.\n\n"
                f"Question:\n{question}\n\n")
    steps = "" if model_name == "qwq" else \
        " You should think step by step to solve it.\n"
    return ("Please answer the following multiple-choice question."
            f"{steps}\n"
            "Provide your final choice in the format \\boxed{YOUR_CHOICE}.\n\n"
            f"Question:\n{question}\n\n")


def _web_verifier_frame(body: str, question: str, predicted_answer: str,
                        spaced_tokens: bool = True) -> str:
    sq = (f"{BEGIN_SEARCH_QUERY} your query here {END_SEARCH_QUERY}"
          if spaced_tokens else
          f"{BEGIN_SEARCH_QUERY}your query here{END_SEARCH_QUERY}")
    return f"""You are a reasoning assistant with web search at your disposal, fact-checking whether a predicted answer to the user's question is correct. You have special tools:

- To perform a search, write:
  {sq}

- The system will return results in the format:
  {BEGIN_SEARCH_RESULT} ...search results... {END_SEARCH_RESULT}

You may search multiple times if necessary to gather enough evidence.

{body}

Question:
{question}
Predicted Answer:
{predicted_answer}
"""


def get_web_verifier_instruction(question: str, predicted_answer: str) -> str:
    """In-band (search-o1-style) verifier, base version (reference:
    prompts.py:356-381). Contract: confidence in \\boxed{}."""
    body = ("Verify the predicted answer below and provide a confidence "
            "score between 0 and 1 — the probability that it is correct. "
            "Think step by step as you verify; when done searching, continue "
            "your reasoning.\n\n"
            "Provide your final confidence in the format \\boxed{}.")
    return _web_verifier_frame(body, question, predicted_answer,
                               spaced_tokens=False)


def get_web_verifier_instructionv1(question: str, predicted_answer: str) -> str:
    """v1: workflow emphasis, holistic confidence (reference:
    prompts.py:384-412)."""
    body = """**Please follow this workflow:**
1. Read the user's question and the predicted answer.
2. If the answer contains any uncertain, factual, or verifiable elements, perform a web search.
3. Analyze the returned search results to determine whether the answer is correct.
4. Continue reasoning using the verified information.

Your goal is a **final confidence score between 0 and 1** reflecting how likely the predicted answer is to be correct given what you found.

Use the format:
\\boxed{<confidence_score>}"""
    return _web_verifier_frame(body, question, predicted_answer)


def get_web_verifier_instructionv2(question: str, predicted_answer: str) -> str:
    """v2: enumerate conditions; confidence = satisfied/total (reference:
    prompts.py:415-446)."""
    body = """**Verification Process:**
1. Analyze the question and identify every explicit or implicit condition a correct answer must satisfy.
2. List these required conditions clearly.
3. Check whether the predicted answer satisfies **each condition**.
4. Use web searches to gather evidence for the uncertain parts.
5. Score by the fraction of conditions the predicted answer satisfies:
   - all conditions satisfied → confidence = 1.
   - some satisfied → confidence = (satisfied conditions / total conditions).
   - none satisfied → confidence = 0.

Give a reasoned, evidence-backed assessment, then return your final confidence score using the format:
\\boxed{<confidence_score>}"""
    return _web_verifier_frame(body, question, predicted_answer)


def get_web_verifier_instructionv3(question: str, predicted_answer: str) -> str:
    """v3: per-condition search-backed checks, justified (reference:
    prompts.py:448-487)."""
    body = """**Verification Procedure:**

1. **Read the question carefully** and identify **all explicit and implicit conditions** a correct answer must satisfy.
2. **List each condition** clearly.
3. For each condition, **check whether the predicted answer satisfies it**, using **web searches to support your verification**.
4. Count the satisfied conditions.
5. Confidence = fraction of conditions met:
   - **all** met → 1; **some** met → (satisfied conditions / total conditions); **none** met → 0.

You must justify your reasoning with evidence from the searches. Return your final confidence score using the format:
\\boxed{<confidence_score>}"""
    return _web_verifier_frame(body, question, predicted_answer)


def get_web_verifier_instructionv4(question: str, predicted_answer: str) -> str:
    """v4: only conditions with explicit search evidence count (reference:
    prompts.py:490-525)."""
    body = """**Verification Process:**
1. Analyze the question and identify every explicit or implicit condition a correct answer must satisfy.
2. List these required conditions clearly.
3. For **each condition**, run web searches and verify the predicted answer against it, citing explicit evidence from the results.
4. Score by how many conditions have clear search-backed evidence:
   - all conditions evidenced → confidence = 1.
   - some evidenced → confidence = (conditions with evidence / total conditions).
   - none evidenced → confidence = 0.

Give a reasoned, evidence-backed assessment, then return your final confidence score using the format:
\\boxed{<confidence_score>}"""
    return _web_verifier_frame(body, question, predicted_answer)


def get_gpqa_web_thinker_instruction(max_search_limit: int = 15) -> str:
    """GPQA-specialized web-thinker task header
    (reference: prompts.py:2-28)."""
    return f"""You are a reasoning assistant solving a graduate-level science question. You may run web searches while you reason:

- To search, emit {BEGIN_SEARCH_QUERY}your query{END_SEARCH_QUERY}.
  The system will fetch and analyze relevant pages and reply inside
  {BEGIN_SEARCH_RESULT} ... {END_SEARCH_RESULT}.

Search as many times as you need (budget: {max_search_limit}), folding each result back into your reasoning.

Example:
Question: "What is the energy range of pp III neutrinos?"
- I should check the pp III neutrino spectrum.
{BEGIN_SEARCH_QUERY}pp III neutrino energy spectrum{END_SEARCH_QUERY}
(system supplies processed page information)
...reasoning continues with the new facts...

Remember: open every search with {BEGIN_SEARCH_QUERY} and close it with {END_SEARCH_QUERY}; when you are done searching, finish your reasoning.
"""


def get_deep_web_explorer_instruction_qwen(search_intent: str,
                                           search_result: str) -> str:
    """Qwen-variant explorer prompt: intent-only, no echoed query
    (reference: prompts.py:68-101). Same output contract: the extractor
    keys on **Final Information**."""
    return f"""You are a web explorer. Judge the searched pages strictly against the goal of this visit and pull out what serves it.

Guidelines:
1. Read every searched page and identify factual content that serves the goal of the visit.
2. If the pages don't serve the goal you may either search again with {BEGIN_SEARCH_QUERY}another query{END_SEARCH_QUERY} or open a page with {BEGIN_CLICK_LINK}URL{END_CLICK_LINK}.
3. Report the relevant content, starting exactly with **Final Information** on its own line.

**Final Information**
[Relevant information]

Inputs:
- Detailed goal of the visit:
{search_intent}

- Searched web pages:
{search_result}

Analyze the pages now and extract what serves the goal of the visit.
"""


def get_detailed_web_page_reader_instruction(query: str, search_intent: str,
                                             document: str) -> str:
    """Page reader conditioned on query AND intent (reference:
    prompts.py:108-126). Contract: markdown output, keep links, the literal
    "No relevant information" when nothing matches."""
    return f"""Extract every piece of this document that bears on the search query and the intent behind it, in markdown.

Search Query:
{query}

Search Intent:
{search_intent}

Searched Web Page:
{document}

Instructions:
- Keep all content matching the query/intent; omit nothing relevant.
- Preserve any useful links from the source.
- If nothing in the page is relevant, output "No relevant information".
- Prefer factual material that directly addresses the query and intent.
"""


def get_query_plan_instruction(question: str) -> str:
    """Sub-query planner (reference: prompts.py:141-158). Contract: the
    JSON ``{"query_plan": [...]}`` schema in a ```json block."""
    return f"""You are a reasoning assistant. Decompose the user's question into the sub-queries needed to fully answer it.

Question: {question}

Think about what separate facts must be gathered, then output only the plan in JSON:

```json
{{
    "query_plan": [
        "sub-query-1",
        "sub-query-2",
        ...
    ]
}}
```
"""


def get_webpage_to_reasonchain_instruction(prev_reasoning: str,
                                           search_query: str,
                                           document: str) -> str:
    """Reason-chain page analysis (reference: prompts.py:235-274).
    Contract: **Final Information** marker; the literal fallback line
    "No helpful information found."."""
    return f"""**Task Instruction:**

You are given **Previous Reasoning Steps**, a **Current Search Query**, and **Searched Web Pages**. Pull from the pages whatever helps answer the current search query so the reasoning chain can continue.

Guidelines:
1. Review each searched page for facts relevant to the **Current Search Query**.
2. Keep only accurate material that moves the **Previous Reasoning Steps** forward.
3. Output format:
- If the pages help, begin with `**Final Information**`:
**Final Information**

[Helpful information]

- If they do not help, output exactly:

**Final Information**

No helpful information found.

**Inputs:**
- **Previous Reasoning Steps:**
{prev_reasoning}

- **Current Search Query:**
{search_query}

- **Searched Web Pages:**
{document}

Now analyze each page for helpful information on "{search_query}" given the previous reasoning steps.
"""


def get_naive_rag_instruction(question: str, documents: str) -> str:
    """Closed-book RAG baseline (reference: prompts.py:347-355)."""
    return (
        "You are a knowledgeable assistant that answers the user's question "
        "using only the provided documents.\n\n"
        "Question:\n"
        f"{question}\n"
        "Documents:\n"
        f"{documents}\n"
    )
