"""The port's ``web/`` copies against the JAX originals.

The same inputs through both packages: replay search (exact, fuzzy, strict
miss) and its store's files, pages fetched through ``replay_fetcher`` and
``PageFetcher`` (HTML, PDF, error pages, the cache, the fallback parser),
``format_search_results`` and the result normalizers, snippet context
matching, and the rate limiter's admissions and waits on a fake clock. The
results must be equal.
"""
import asyncio
import base64
import json
import types

import pytest

from deepsearch_tts_tpu.web import fetch as jfetch
from deepsearch_tts_tpu.web import ratelimit as jrl
from deepsearch_tts_tpu.web import replay as jrep
from deepsearch_tts_tpu.web import search as jsearch
from deepsearch_tts_tpu.web import snippets as jsnip
from deepsearch_tts_tpu_torch.web import fetch as tfetch
from deepsearch_tts_tpu_torch.web import ratelimit as trl
from deepsearch_tts_tpu_torch.web import replay as trep
from deepsearch_tts_tpu_torch.web import search as tsearch
from deepsearch_tts_tpu_torch.web import snippets as tsnip

FACTS = {
    "capital of france": "Paris is the capital of France.",
    "paris population": "About 2.1 million people live in Paris proper.",
    "tallest mountain": "Mount Everest is the tallest mountain above sea level.",
}
QUERIES = ["capital of france", "what is the capital of france?", "Paris population",
           "mountain", "no overlap at all", ""]
PAGE = ("Intro text. " * 5 + "The capital of France is Paris, a major European city. "
        + "Outro text. " * 5)
HTML = ("<html><head><title>t</title><style>p{}</style></head><body><script>x=1</script>"
        "<p>Hello <b>world</b></p><a href='http://x.test/page'>anchor text</a>"
        "<ul><li>one</li><li>two</li></ul><br>tail &amp; more</body></html>")
PDF = b"%PDF-1.4 stream\nBT (Hello) Tj (World) Tj ET\nendstream"


def _run(coro):
    return asyncio.run(coro)


def test_synthetic_store_and_files_equal(tmp_path):
    js, ts = jrep.synthetic_store(FACTS), trep.synthetic_store(FACTS)
    assert (js.searches, js.pages) == (ts.searches, ts.pages)
    js.save(str(tmp_path / "j.json"))
    ts.save(str(tmp_path / "t.json"))
    assert (tmp_path / "j.json").read_text() == (tmp_path / "t.json").read_text()
    jl, tl = jrep.ReplayStore.load(str(tmp_path / "t.json")), \
        trep.ReplayStore.load(str(tmp_path / "j.json"))
    assert (jl.searches, jl.pages) == (tl.searches, tl.pages)
    for s in (jl, tl):
        s.record_search("new", [{"id": 1}])
        s.record_page("http://n.test", "page")
        s.save()
    assert (tmp_path / "j.json").read_text() == (tmp_path / "t.json").read_text()


@pytest.mark.parametrize("query", QUERIES)
def test_replay_search_equal(query):
    jb = jrep.ReplaySearchBackend(jrep.synthetic_store(FACTS))
    tb = trep.ReplaySearchBackend(trep.synthetic_store(FACTS))
    for top_k in (10, 1, 0):
        assert _run(jb.search(query, top_k)) == _run(tb.search(query, top_k))
    assert jb.calls == tb.calls == 3
    out = []
    for mod in (jrep, trep):
        strict = mod.ReplaySearchBackend(mod.synthetic_store(FACTS), strict=True)
        try:
            out.append(_run(strict.search(query)))
        except KeyError as e:
            out.append(("KeyError", str(e)))
    assert out[0] == out[1]


def test_replay_fetch_through_page_fetcher_equal():
    store = jrep.synthetic_store(FACTS)
    store.record_page("http://h.test/page", HTML)
    urls = list(store.pages) + ["http://missing.test/x"]
    for strict in (False, True):
        res = []
        for rep, fetch in ((jrep, jfetch), (trep, tfetch)):
            raw = rep.replay_fetcher(store, strict=strict)
            direct = []
            for u in urls:
                try:
                    direct.append(raw(u))
                except KeyError as e:
                    direct.append(("KeyError", str(e)))
            fetcher = fetch.PageFetcher(raw_fetch=raw)
            pages = _run(fetcher.fetch_pages(urls))
            res.append((direct, pages, dict(fetcher.cache),
                        _run(fetcher.fetch_page(urls[0]))))
        assert res[0] == res[1], strict
        assert "Paris is the capital" in res[0][1][urls[0]]


def test_fetcher_paths_equal():
    """HTML with and without links, a PDF, an error page, a raising fetch,
    the per-URL cache, and the fallback parser rescuing failed URLs."""
    calls = {"j": [], "t": []}

    def raw_for(tag):
        def raw(url):
            calls[tag].append(url)
            if "bad" in url or "ok" in url:
                raise OSError("connection refused")
            if url.endswith(".pdf"):
                return PDF, "application/pdf"
            if "denied" in url:
                return b"Access Denied - you don't have permission", "text/html"
            if "latin" in url:
                return "caf\xe9 page body with enough words here".encode("latin-1"), \
                    "text/html; charset=latin-1"
            return HTML.encode(), "text/html"
        return raw

    def transport(endpoint, payload):
        return {"results": [{"url": u, "success": u.endswith("ok"),
                             "content": f"parsed {u}"} for u in payload["urls"]]}

    urls = ["http://a.test/good", "http://a.test/doc.pdf", "http://a.test/denied",
            "http://a.test/bad", "http://a.test/ok", "http://a.test/latin",
            "http://a.test/good"]
    outs = []
    for tag, mod in (("j", jfetch), ("t", tfetch)):
        got = []
        for keep_links in (False, True):
            parser = mod.WebParserClient("http://parse.test", transport=transport)
            f = mod.PageFetcher(raw_fetch=raw_for(tag), keep_links=keep_links,
                                fallback_parser=parser)
            got.append(_run(f.fetch_pages(urls)))
            got.append(_run(f.fetch_page("http://a.test/good")))
        outs.append(got)
    assert outs[0] == outs[1]
    assert calls["j"] == calls["t"]
    assert outs[0][0]["http://a.test/ok"] == "parsed http://a.test/ok"


@pytest.mark.parametrize("keep_links", [False, True])
def test_text_extraction_equal(keep_links):
    for html in (HTML, "", "<p>unclosed <b>bold", "plain text only",
                 "<div>a</div><div>b</div>\n\n\n<p>c</p>"):
        assert jfetch.html_to_text(html, keep_links=keep_links) == \
            tfetch.html_to_text(html, keep_links=keep_links)
    for data in (PDF, b"", b"%PDF-1.4 no text objects", b"BT (A) Tj ET BT (B) Tj ET"):
        assert jfetch.extract_pdf_text(data) == tfetch.extract_pdf_text(data)
    for text in ("Access Denied - you don't have permission", "  ", "",
                 "A real article about science. " * 10, "404 Not Found"):
        assert jfetch.looks_like_error_page(text) == tfetch.looks_like_error_page(text)
    md = "Title\n---\nsee [http://x.test/a] and (https://y.test/b) end\n==="
    assert jfetch.clean_jina_markdown(md) == tfetch.clean_jina_markdown(md)
    for data, ctype in ((b"abc", "text/html"), ("\xe9".encode("latin-1"), "charset=latin-1"),
                        ("\xe9".encode("utf-8"), ""), (b"\xff\xfe", "charset=bogus")):
        assert jfetch._decode_bytes(data, ctype) == tfetch._decode_bytes(data, ctype)
    assert (jfetch.PAGE_TEXT_CAP, jfetch.MAX_PAGE_BYTES) == \
        (tfetch.PAGE_TEXT_CAP, tfetch.MAX_PAGE_BYTES)


SNIPPETS = ["capital of France is Paris", "quantum entanglement dynamics", "",
            "Intro text…", "outro text...", "Paris"]


@pytest.mark.parametrize("snippet", SNIPPETS)
def test_snippet_context_equal(snippet):
    for page in (PAGE, "Completely unrelated content here.", "", "No.。Yes！ok? Fine."):
        for chars in (30, 2500, 0):
            assert jsnip.extract_snippet_with_context(page, snippet, context_chars=chars) == \
                tsnip.extract_snippet_with_context(page, snippet, context_chars=chars)
        assert jsnip.split_sentences(page) == tsnip.split_sentences(page)
        assert jsnip.word_set_f1(snippet, page) == tsnip.word_set_f1(snippet, page)
    assert jsnip.extract_snippet_with_context(None, snippet) == \
        tsnip.extract_snippet_with_context(None, snippet)


def test_search_formatting_and_normalizers_equal():
    serper = {"organic": [{"title": "T", "link": "http://u", "snippet": "S", "date": "d"},
                          {"title": "T2", "link": "http://v"}],
              "knowledgeGraph": {"title": "KG", "description": "D"}}
    bing = {"webPages": {"value": [{"name": "n", "url": "http://b.test/q",
                                    "snippet": "sn", "datePublished": "2023-05-06T00:00"}]}}
    tencent = {"code": "200", "tencentSearchResults": {"Response": {"Pages": [
        json.dumps({"title": "tt", "url": "http://t.test/a/b", "passage": "pp",
                    "date": "2024-01-02 10:00"}), "not json"]}}}
    pro = {"code": "200", "bingSearchProResults": {"webPages": {"value": [{
        "name": "n", "url": "http://b.test/q", "displayUrl": "b.test/q",
        "datePublished": "2023-05-06T00:00:00", "snippet": "sn",
        "about": [{"aggregateRating": {"ratingValue": 4.5, "reviewCount": 7,
                                       "bestRating": 5}}]}]}}}
    for top_k in (10, 1):
        assert jsearch.normalize_serper(serper, top_k) == tsearch.normalize_serper(serper, top_k)
        assert jsearch.normalize_bing(bing, top_k) == tsearch.normalize_bing(bing, top_k)
        for data in (serper, tencent, pro, {"code": "403", "error": "denied"}, {}):
            assert jsearch.normalize_pro(data, top_k) == tsearch.normalize_pro(data, top_k)
    rows = jsearch.normalize_serper(serper) + jrep.synthetic_store(FACTS).searches[
        "capital of france"] + [{"id": 9, "context": "c" * 5000}, {}]
    assert jsearch.format_search_results(rows) == tsearch.format_search_results(rows)
    assert jsearch.format_search_results([]) == tsearch.format_search_results([])


def test_bing_pro_backend_equal(monkeypatch):
    """Token rotation and retry through a transport: the same tokens drawn
    (the module-level ``random`` seeded alike), the same payloads."""
    import random

    monkeypatch.setattr(asyncio, "sleep", _no_sleep)
    outs = []
    for mod in (jsearch, tsearch):
        seen = []
        calls = {"n": 0}

        def transport(url, payload, headers):
            seen.append((url, payload, headers["Authorization"]))
            calls["n"] += 1
            if calls["n"] == 1:
                raise OSError("gateway 500")
            return {"code": "200", "bingSearchProResults": {"webPages": {"value": [
                {"name": "hit", "url": "http://x.test", "snippet": "s"}]}}}

        random.seed(5)
        b = mod.BingProBackend("tok1, tok2,tok3", transport=transport)
        outs.append((_run(b.search("q", top_k=3)), seen))
    assert outs[0] == outs[1] and outs[0][0][0]["title"] == "hit"


async def _no_sleep(_s):
    return None


def test_rate_limiter_equal(monkeypatch):
    """The same admissions and waits on a fake clock: a burst, then paced
    acquisitions at the configured rate."""
    clock = {"t": 100.0}
    waits: list = []

    async def fake_sleep(s):
        # a sleep overshoots a little, as a real one does (an exact one can
        # refill the bucket to just under a token in float arithmetic)
        waits.append(round(s, 9))
        clock["t"] += s * 1.001

    # the modules' own clock and sleep (the event loop keeps the real ones)
    for mod in (jrl, trl):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=lambda: clock["t"]))
        monkeypatch.setattr(mod, "asyncio", types.SimpleNamespace(Lock=asyncio.Lock,
                                                                  sleep=fake_sleep))
    outs = []
    for mod in (jrl, trl):
        for rate, burst in ((600, 5), (60, None), (7, 2)):
            clock["t"] = 100.0
            waits.clear()

            async def go():
                rl = mod.RateLimiter(rate, burst=burst)
                stamps = []
                for _ in range(8):
                    await rl.acquire()
                    stamps.append(round(clock["t"], 9))
                return rl.capacity, rl.rate, stamps

            outs.append((_run(go()), list(waits)))
    assert outs[:3] == outs[3:]
    assert outs[0][1], "the burst of 5 must be followed by waits"


def test_connection_pool_equal_on_localhost():
    """Both pools against one local threaded server: the same bodies, the
    same redirect following, one idle connection kept for the host."""
    import http.server
    import threading

    class Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_GET(self):
            if self.path == "/redir":
                self.send_response(302)
                self.send_header("Location", "/target")
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            body = base64.b64encode(self.path.encode())
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        key = ("http", "127.0.0.1", srv.server_address[1])
        outs = []
        for mod in (jfetch, tfetch):
            pool = mod.ConnectionPool()
            got = [pool.fetch(base + p) for p in ("/a", "/b", "/redir")]
            outs.append((got, len(pool._idle.get(key, []))))
        assert outs[0] == outs[1] and outs[0][1] == 1
    finally:
        srv.shutdown()
