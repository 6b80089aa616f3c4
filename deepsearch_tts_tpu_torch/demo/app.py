"""Streamlit demo UI (reference: demo/run_demo.py — the WebThinker page;
port of ``demo/app.py``).

Streams the token-in-band agent's reasoning, searches, and results through
whichever backend the sidebar selects — ``fake`` (hermetic replay),
``engine`` (the port's in-process serving engine on the card), or ``http``
(an OpenAI-compatible endpoint). The session wiring is shared with the
terminal demo (`cli/demo.build_demo_session`), so the UI drives exactly
what the CLI drives. The engine flags of ``cli/deep_search.py`` given after
``--`` (``--device``, ``--seed``, ``--engine_*``) reach the engines. Gated on
streamlit being installed:

    streamlit run deepsearch_tts_tpu_torch/demo/app.py -- --engine_pages 1024 \
        --engine_max_slots 16
"""
from __future__ import annotations

import argparse
import asyncio
import sys


def main():
    try:
        import streamlit as st
    except ImportError:
        print("streamlit not installed; use the terminal demo: "
              "python -m deepsearch_tts_tpu_torch.cli.demo --question '...'",
              file=sys.stderr)
        return

    from ..cli.demo import build_demo_session
    from ..cli.deep_search import add_engine_flags, engine_argv
    from ..demo.inband import run_inband_agent

    extra = engine_argv(add_engine_flags(argparse.ArgumentParser()).parse_known_args()[0])
    st.set_page_config(page_title="DeepSearch-TTS (PyTorch, CUDA)", layout="wide")
    st.title("DeepSearch test-time scaling — the PyTorch port's engine on a CUDA card")

    backend = st.sidebar.selectbox("backend", ["fake", "engine", "http"])
    model = st.sidebar.text_input("model", "qwen3-8b")
    aux_model = st.sidebar.text_input("aux model", "qwen3-4b")
    search_backend = st.sidebar.selectbox("search", ["replay", "serper", "bing"])
    max_calls = st.sidebar.slider("max searches", 1, 20, 10)
    question = st.text_input("Question")
    if not st.button("Run") or not question:
        return

    # engine sessions are expensive to build (weights + compile): cache per
    # backend/model selection across reruns, like the reference's
    # st.session_state-held vLLM handles (demo/run_demo.py)
    key = (backend, model, aux_model, search_backend, max_calls, tuple(extra))
    if st.session_state.get("session_key") != key:
        with st.spinner(f"starting {backend} backend…"):
            st.session_state.session = build_demo_session(
                backend, model, aux_model, search_backend, max_calls,
                question=question, extra_args=extra)
            st.session_state.session_key = key
    env, client, aux, tool = st.session_state.session

    thought = st.empty()
    log = st.container()
    buf: list[str] = []

    async def go():
        async for ev in run_inband_agent(question, env, client, aux, tool):
            if ev.kind == "text":
                buf.append(ev.payload)
                thought.markdown("".join(buf))
            elif ev.kind == "search":
                log.info(f"searching: {ev.payload}")
            elif ev.kind == "result":
                log.success(ev.payload[:500])
            else:
                st.markdown(f"### Final answer\n**{ev.payload}**")

    asyncio.run(go())


if __name__ == "__main__":
    main()
