"""The port's own copies of the JAX package's JAX-free host modules, held to
the originals on the same inputs (tokenizer, detokenizer, tool-call parser,
stop scanner, span timer, the C++ radix index), and the rule that nothing
under ``deepsearch_tts_tpu_torch/``, nor ``chip_smoke.py``, imports
``deepsearch_tts_tpu`` or ``jax``.
"""
import ast
import json
import os

import numpy as np
import pytest

from deepsearch_tts_tpu.engine import prefix_cache as jprefix
from deepsearch_tts_tpu.engine import stopping as jstop
from deepsearch_tts_tpu.engine import tokenizer as jtok
from deepsearch_tts_tpu.engine.kvcache import PageAllocator as JPageAllocator
from deepsearch_tts_tpu.engine.profiling import SpanTimer as JSpanTimer
from deepsearch_tts_tpu.native import NativeRadixIndex as JNativeRadixIndex
from deepsearch_tts_tpu_torch import native as tnative
from deepsearch_tts_tpu_torch.engine import prefix_cache as tprefix
from deepsearch_tts_tpu_torch.engine import stopping as tstop
from deepsearch_tts_tpu_torch.engine import tokenizer as ttok
from deepsearch_tts_tpu_torch.engine.kvcache import PageAllocator
from deepsearch_tts_tpu_torch.engine.profiling import SpanTimer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["hello world", "unicode: héllo → 日本語 end", "<|im_end|>special",
         "mix <tool_call>{}</tool_call> done", "a<|im_end|>b", "", "🙂🙂 x"]


def _strip_ids(calls):
    return [{k: v for k, v in c.items() if k != "id"} for c in calls]


@pytest.mark.parametrize("text", TEXTS)
def test_byte_tokenizer_and_detokenizer_match_jax(text):
    jt, tt = jtok.ByteTokenizer(), ttok.ByteTokenizer()
    ids = tt.encode(text)
    assert ids == jt.encode(text)
    assert tt.decode(ids) == jt.decode(ids) == text
    assert (tt.vocab_size, tt.eos_id, tt.pad_id) == (jt.vocab_size, jt.eos_id, jt.pad_id)
    # the stream, piece by piece: multi-byte characters are held back until
    # complete, specials pass through
    jd, td = jtok.IncrementalDetokenizer(jt), ttok.IncrementalDetokenizer(tt)
    pieces = [(td.push(i), jd.push(i)) for i in ids]
    assert [p for p, _ in pieces] == [q for _, q in pieces]
    assert td.text == jd.text == text


def test_detokenizer_on_invalid_bytes_matches_jax():
    rng = np.random.default_rng(0)
    ids = [int(i) for i in rng.integers(0, 269, 200)] + [0xE6, 0x97, 0xA5]
    jd = jtok.IncrementalDetokenizer(jtok.ByteTokenizer())
    td = ttok.IncrementalDetokenizer(ttok.ByteTokenizer())
    assert [td.push(i) for i in ids] == [jd.push(i) for i in ids]


@pytest.mark.parametrize("text", [
    ('I will search.\n<tool_call>\n{"name": "deep_websearch", '
     '"arguments": {"search_query": "q", "search_intent": "i"}}\n</tool_call>'),
    "<tool_call>not json</tool_call> rest",
    'a <tool_call>{"name": "f"}</tool_call> b <tool_call>{"name": "g", '
    '"arguments": {"x": [1, 2]}}</tool_call>',
    "no calls at all",
])
def test_parse_tool_calls_matches_jax(text):
    content, calls = ttok.parse_tool_calls(text)
    jcontent, jcalls = jtok.parse_tool_calls(text)
    assert content == jcontent and _strip_ids(calls) == _strip_ids(jcalls)
    assert all(c["id"].startswith("call_") for c in calls)


def test_chat_template_matches_jax():
    msgs = [
        {"role": "system", "content": "sys"},
        {"role": "user", "content": "q"},
        {"role": "assistant", "content": "", "tool_calls": [
            {"function": {"name": "f", "arguments": json.dumps({"x": 1})}}]},
        {"role": "tool", "content": "result!"},
    ]
    tools = [{"type": "function", "function": {"name": "deep_websearch"}}]
    for t in (None, tools):
        for gen in (True, False):
            assert (ttok.ChatTemplate().render(msgs, t, gen)
                    == jtok.ChatTemplate().render(msgs, t, gen))
    assert (ttok.ByteTokenizer().apply_chat_template(msgs, tools)
            == jtok.ByteTokenizer().apply_chat_template(msgs, tools))


@pytest.mark.parametrize("kw,feed", [
    (dict(stop_sequences=("STOP",), max_tokens=100), ["hello S", "TO", "P world"]),
    (dict(stop_sequences=("</x>",), max_tokens=100, include_stop_str=True),
     ["abc</x>def"]),
    (dict(eos_ids=(99,), max_tokens=100), ["a", "b", "<eos>", "c"]),
    (dict(stop_sequences=("ab", "xyz"), max_tokens=4), ["x", "y", "a", "q", "z"]),
])
def test_stop_state_scans_match_jax(kw, feed):
    ts, js = tstop.StopState(**kw), jstop.StopState(**kw)
    for i, piece in enumerate(feed):
        tok = 99 if piece == "<eos>" else i
        assert ts.feed(tok, piece) == js.feed(tok, piece)
        assert (ts.text, ts.n_tokens, ts.finished, ts.finish_reason) == (
            js.text, js.n_tokens, js.finished, js.finish_reason)


def test_span_timer_matches_jax():
    tt, jt = SpanTimer(), JSpanTimer()
    for t in (tt, jt):
        t.add("decode", 0.25)
        t.add("decode", 0.5)
        t.add("prefill", 0.125)
        with t.span("host"):
            pass
    ts, js = tt.summary(), jt.summary()
    assert set(ts) == set(js) == {"decode", "host", "prefill"}
    for name in ("decode", "prefill"):
        assert ts[name] == js[name]
    tt.reset()
    assert tt.summary() == {}


def _native_log(ix):
    """One match / insert / evict sequence over a radix index."""
    log = []
    log.append(ix.insert(list(range(12)), [10, 11, 12]))
    log.append(ix.insert(list(range(4)) + [99, 98, 97, 96], [10, 20]))
    log.append(ix.insert([1, 2, 3, 4, 5, 6, 7, 8], [30, 31]))
    for toks in (list(range(12)), list(range(8)), [9, 9, 9, 9],
                 list(range(4)) + [99, 98, 97, 96, 1, 2], [1, 2, 3, 4, 5, 6, 7, 8]):
        log.append(ix.match(toks))
    log.append(len(ix))
    log.append([ix.evict_lru() for _ in range(8)])
    log.append(len(ix))
    return log


def test_native_radix_index_matches_jax():
    assert tnative.load_native() is not None, "g++ is in this image"
    assert _native_log(tnative.NativeRadixIndex(4)) == _native_log(JNativeRadixIndex(4))
    # the library is built under build/native/, never into the package
    built = [f for f in os.listdir(tnative.BUILD_DIR) if f.endswith(".so")]
    assert built and tnative.BUILD_DIR == os.path.join(REPO, "build", "native")
    pkg = os.path.dirname(tnative.__file__)
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]


def test_native_prefix_cache_matches_jax():
    ps = 4
    seqs = [list(range(16)), list(range(8)) + [50] * 8, [7] * 16]

    def run(cache_cls, alloc_cls):
        alloc = alloc_cls(64, ps)
        cache = cache_cls(alloc)
        log = []
        for s in seqs:
            pages = alloc.alloc(len(s) // ps)
            cache.insert(s, pages)
            log.append(pages)
        for s in seqs + [seqs[0][:9]]:
            log.append(cache.match(s))
        log.append(cache.evict_lru(63))
        log.append((alloc.num_free, cache.stats()["hits"], cache.stats()["misses"]))
        return log

    want = run(jprefix.NativePrefixCache, JPageAllocator)
    assert run(tprefix.NativePrefixCache, PageAllocator) == want
    assert run(tprefix.PrefixCache, PageAllocator) == want
    assert isinstance(tprefix.make_prefix_cache(PageAllocator(8, 4)),
                      tprefix.NativePrefixCache)


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_nothing_of_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "deepsearch_tts_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = []
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("deepsearch_tts_tpu", "jax", "jaxlib"):
                bad.append((os.path.relpath(path, REPO), mod))
    assert len(files) > 20 and not bad, bad
