"""Concurrent page fetching and text extraction.

The port's own copy of ``web/fetch.py`` (same behaviour; imports resolve in this package).

Re-implements the reference's fetch pipeline semantics (reference:
scripts/search/bing_search.py:1246-1494 "turbo" fetcher): high-concurrency
async fetch over pooled keep-alive connections, size caps, encoding
detection, HTML→text extraction, PDF text extraction, error-indicator
heuristics on the extracted text, per-URL caching, the Jina reader mode
(bing_search.py:185-198), and a WebParserClient-compatible fallback parser
seam (bing_search.py:79-108, 218-231). Differences by design:

* stdlib ``html.parser``/``http.client`` instead of aiohttp/bs4/chardet
  (those are not all guaranteed present); the blocking socket work runs in
  a thread pool, keeping the asyncio interface. Connection pooling +
  keep-alive replaces aiohttp's TCPConnector reuse.
* a pluggable ``fetcher`` callable so tests inject the offline replay store.
"""
from __future__ import annotations

import asyncio
import re
import threading
from dataclasses import dataclass, field
from html.parser import HTMLParser
from typing import Callable

MAX_PAGE_BYTES = 5 * 1024 * 1024
PAGE_TEXT_CAP = 50000
PDF_TEXT_CAP = 10000

# phrases that mark a fetched page as an error/paywall shell
# (same role as reference bing_search.py:64-77)
ERROR_INDICATORS = (
    "access denied", "403 forbidden", "404 not found", "page not found",
    "captcha", "verify you are human", "are you a robot",
    "enable javascript", "browser not supported", "cloudflare",
    "rate limit", "too many requests", "service unavailable",
)


class _TextExtractor(HTMLParser):
    SKIP = {"script", "style", "noscript", "svg", "head", "iframe"}

    def __init__(self, keep_links: bool = False):
        super().__init__(convert_charrefs=True)
        self.parts: list[str] = []
        self.links: list[tuple[str, str]] = []
        self._skip_depth = 0
        self._href: str | None = None
        self.keep_links = keep_links

    def handle_starttag(self, tag, attrs):
        if tag in self.SKIP:
            self._skip_depth += 1
        elif tag == "a" and self.keep_links:
            self._href = dict(attrs).get("href")
        elif tag in ("p", "br", "div", "li", "tr", "h1", "h2", "h3", "h4"):
            self.parts.append("\n")

    def handle_endtag(self, tag):
        if tag in self.SKIP and self._skip_depth:
            self._skip_depth -= 1
        elif tag == "a":
            self._href = None

    def handle_data(self, data):
        if self._skip_depth == 0 and data.strip():
            self.parts.append(data)
            if self._href:
                self.links.append((data.strip(), self._href))


def html_to_text(html: str, keep_links: bool = False) -> str:
    p = _TextExtractor(keep_links)
    try:
        p.feed(html)
    except Exception:
        pass
    text = "".join(p.parts)
    text = re.sub(r"[ \t]+", " ", text)
    text = re.sub(r"\n\s*\n+", "\n", text)
    if keep_links and p.links:
        text += "\n\nLinks:\n" + "\n".join(f"[{t}]({h})" for t, h in p.links[:100])
    return text.strip()


def extract_pdf_text(data: bytes) -> str:
    """Best-effort PDF text without external deps: pull text runs from
    uncompressed content streams; compressed streams are inflated via zlib."""
    import zlib

    chunks: list[str] = []
    for m in re.finditer(rb"stream\r?\n(.*?)endstream", data, re.DOTALL):
        raw = m.group(1)
        try:
            raw = zlib.decompress(raw)
        except Exception:
            pass
        for tm in re.finditer(rb"\(((?:[^()\\]|\\.)*)\)\s*T[jJ]", raw):
            try:
                chunks.append(tm.group(1).decode("latin-1"))
            except Exception:
                continue
    text = " ".join(chunks)
    return re.sub(r"\s+", " ", text)[:PDF_TEXT_CAP]


def looks_like_error_page(text: str) -> bool:
    head = text[:1000].lower()
    return len(text.strip()) < 64 or any(ind in head for ind in ERROR_INDICATORS)


def _decode_bytes(data: bytes, content_type: str) -> str:
    m = re.search(r"charset=([\w-]+)", content_type or "")
    encodings = [m.group(1)] if m else []
    encodings += ["utf-8", "latin-1"]
    for enc in encodings:
        try:
            return data.decode(enc)
        except (LookupError, UnicodeDecodeError):
            continue
    return data.decode("utf-8", errors="replace")


def _urllib_fetch(url: str, timeout: float = 20.0) -> tuple[bytes, str]:
    import urllib.request

    req = urllib.request.Request(url, headers={
        "User-Agent": "Mozilla/5.0 (X11; Linux x86_64) deepsearch-tts-tpu/0.1",
        "Accept": "text/html,application/xhtml+xml,application/pdf,*/*",
    })
    with urllib.request.urlopen(req, timeout=timeout) as r:
        ctype = r.headers.get("Content-Type", "")
        data = r.read(MAX_PAGE_BYTES)
    return data, ctype


_FETCH_HEADERS = {
    "User-Agent": "Mozilla/5.0 (X11; Linux x86_64) deepsearch-tts-tpu/0.1",
    "Accept": "text/html,application/xhtml+xml,application/pdf,*/*",
    "Connection": "keep-alive",
}
_READ_CHUNK = 256 * 1024


class ConnectionPool:
    """Keep-alive HTTP connection pool (the stdlib analog of the turbo
    fetcher's pooled aiohttp TCPConnector, bing_search.py:1283-1291).

    One stack of idle ``http.client`` connections per (scheme, host, port);
    a connection is checked out per request and returned on success. Stale
    keep-alive sockets surface as send/recv errors and are retried once on
    a fresh connection. Bodies are read in chunks with a hard byte cap, so
    a huge page can't stall the pool."""

    def __init__(self, max_idle_per_host: int = 16, timeout: float = 20.0):
        self.max_idle = max_idle_per_host
        self.timeout = timeout
        self._idle: dict[tuple, list] = {}
        self._lock = threading.Lock()

    def _checkout(self, key):
        with self._lock:
            conns = self._idle.get(key)
            if conns:
                return conns.pop()
        import http.client

        scheme, host, port = key
        cls = http.client.HTTPSConnection if scheme == "https" \
            else http.client.HTTPConnection
        return cls(host, port, timeout=self.timeout)

    def _checkin(self, key, conn) -> None:
        with self._lock:
            conns = self._idle.setdefault(key, [])
            if len(conns) < self.max_idle:
                conns.append(conn)
                return
        conn.close()

    def fetch(self, url: str, max_redirects: int = 3) -> tuple[bytes, str]:
        from urllib.parse import urlsplit, urljoin

        for _ in range(max_redirects + 1):
            parts = urlsplit(url)
            if parts.scheme not in ("http", "https"):
                raise ValueError(f"unsupported scheme in {url!r}")
            key = (parts.scheme, parts.hostname,
                   parts.port or (443 if parts.scheme == "https" else 80))
            path = parts.path or "/"
            if parts.query:
                path += "?" + parts.query
            last_exc = None
            for attempt in range(2):  # retry once on a stale pooled socket
                conn = self._checkout(key)
                try:
                    conn.request("GET", path, headers=_FETCH_HEADERS)
                    resp = conn.getresponse()
                    if resp.status in (301, 302, 303, 307, 308):
                        location = resp.getheader("Location")
                        resp.read()
                        self._checkin(key, conn)
                        if not location:
                            raise OSError(f"redirect without Location from {url}")
                        url = urljoin(url, location)
                        break
                    chunks, total = [], 0
                    while total < MAX_PAGE_BYTES:
                        chunk = resp.read(min(_READ_CHUNK, MAX_PAGE_BYTES - total))
                        if not chunk:
                            break
                        chunks.append(chunk)
                        total += len(chunk)
                    ctype = resp.getheader("Content-Type", "")
                    if resp.status >= 400:
                        self._checkin(key, conn)
                        raise OSError(f"HTTP {resp.status} for {url}")
                    self._checkin(key, conn)
                    return b"".join(chunks), ctype
                except OSError as e:
                    conn.close()
                    last_exc = e
                    if attempt == 1 or "HTTP " in str(e):
                        raise
            else:
                raise last_exc  # both attempts failed
            continue  # redirect: follow
        raise OSError(f"too many redirects for {url}")


class WebParserClient:
    """Client for a WebParserClient-protocol parse server — the reference's
    last-resort fallback when direct extraction fails
    (reference: scripts/search/bing_search.py:79-108). POSTs
    ``{"urls": [...]}`` to ``<base>/parse_urls`` and returns the
    ``results`` list of ``{url, success, content|error}`` dicts.

    ``transport(endpoint, payload) -> dict`` is pluggable for tests."""

    def __init__(self, base_url: str, timeout: float = 120.0, transport=None):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.transport = transport

    def parse_urls(self, urls: list[str]) -> list[dict]:
        payload = {"urls": list(urls)}
        endpoint = self.base_url + "/parse_urls"
        if self.transport is not None:
            body = self.transport(endpoint, payload)
        else:
            import json
            import urllib.request

            req = urllib.request.Request(
                endpoint, data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                body = json.loads(r.read().decode())
        return body.get("results", [])


def clean_jina_markdown(text: str) -> str:
    """Post-process r.jina.ai markdown the way the reference does
    (bing_search.py:192-196): drop bare URL parens/brackets, flatten rules."""
    text = re.sub(r"\(https?:.*?\)|\[https?:.*?\]", "", text)
    return (text.replace("---", "-").replace("===", "=")
            .replace("   ", " ").replace("   ", " "))


@dataclass
class PageFetcher:
    """High-concurrency fetch + extract with caching.

    ``raw_fetch(url) -> (bytes, content_type)`` is pluggable; the default
    fetches over a keep-alive :class:`ConnectionPool` in a thread (the
    turbo-fetcher configuration, bing_search.py:1246-1316, defaults:
    200-way concurrency ≈ the reference's ``min(300, 2·urls)`` scaling).
    Results are cached per URL (the reference shares a url_cache across
    the explorer, deep_search.py:676).

    Resilience tiers, mirroring the reference ladder:
    1. direct fetch + native extraction;
    2. ``use_jina``: route through the r.jina.ai reader (markdown), with
       the reference's link-stripping cleanup (bing_search.py:185-198);
    3. ``fallback_parser`` (a :class:`WebParserClient`): failed URLs are
       batched to the parse server after the direct pass
       (bing_search.py:218-231).
    """

    max_concurrent: int = 200
    keep_links: bool = False
    timeout: float = 20.0
    raw_fetch: Callable[[str], tuple[bytes, str]] | None = None
    cache: dict = field(default_factory=dict)
    pooled: bool = True
    use_jina: bool = False
    jina_api_key: str | None = None
    fallback_parser: WebParserClient | None = None

    def __post_init__(self):
        self._sem: asyncio.Semaphore | None = None
        self._pool: ConnectionPool | None = None

    def _semaphore(self) -> asyncio.Semaphore:
        if self._sem is None:
            self._sem = asyncio.Semaphore(self.max_concurrent)
        return self._sem

    def _default_fetch(self, url: str) -> tuple[bytes, str]:
        if self.pooled:
            if self._pool is None:
                self._pool = ConnectionPool(timeout=self.timeout)
            return self._pool.fetch(url)
        return _urllib_fetch(url, self.timeout)

    def _jina_fetch(self, url: str) -> str:
        import urllib.request

        headers = {"X-Return-Format": "markdown"}
        if self.jina_api_key:
            headers["Authorization"] = f"Bearer {self.jina_api_key}"
        req = urllib.request.Request(f"https://r.jina.ai/{url}", headers=headers)
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return clean_jina_markdown(r.read(MAX_PAGE_BYTES).decode(
                "utf-8", errors="replace"))

    async def fetch_page(self, url: str) -> str:
        if url in self.cache:
            return self.cache[url]
        async with self._semaphore():
            loop = asyncio.get_running_loop()
            try:
                if self.use_jina and self.raw_fetch is None:
                    text = await loop.run_in_executor(None, self._jina_fetch, url)
                else:
                    fetch = self.raw_fetch or self._default_fetch
                    data, ctype = await loop.run_in_executor(None, fetch, url)
                    if url.lower().endswith(".pdf") or "pdf" in (ctype or ""):
                        text = extract_pdf_text(data)
                    else:
                        text = html_to_text(_decode_bytes(data, ctype),
                                            self.keep_links)
                text = text[:PAGE_TEXT_CAP]
                if looks_like_error_page(text):
                    text = f"Error fetching {url}: page returned an error or empty content."
            except Exception as e:
                text = f"Error fetching {url}: {e}"
        self.cache[url] = text
        return text

    async def fetch_pages(self, urls: list[str]) -> dict[str, str]:
        texts = await asyncio.gather(*(self.fetch_page(u) for u in urls))
        out = dict(zip(urls, texts))
        failed = [u for u, t in out.items() if t.startswith("Error fetching")]
        if failed and self.fallback_parser is not None:
            try:
                results = await asyncio.get_running_loop().run_in_executor(
                    None, self.fallback_parser.parse_urls, failed)
            except Exception:
                results = []
            for r in results:
                u = r.get("url")
                if u in out and r.get("success") and r.get("content"):
                    out[u] = str(r["content"])[:PAGE_TEXT_CAP]
                    self.cache[u] = out[u]
        return out
