"""The port's HTTP front-end (asyncio streams, no aiohttp) on the CPU,
route by route against the JAX package's aiohttp ``make_http_app`` over
the JAX Engine on the same weights (``tests/test_torch_server.py``'s
engine: E=128, 2 layers, q4_0 packed, numpy seed 0), with the same request
bodies: status codes and JSON keys equal, error messages equal,
embeddings at cosine >= 0.999 (the JAX engine's default CPU path computes
in f32 with exact-erf GELU), int8 / binary outputs equal to the JAX
package's ``quantize_embeddings`` of the port's own floats, rerank scores
within 1e-4 of the JAX engine's. Then what the JAX server gets from
aiohttp and the port's server does itself: keep-alive with pipelined
requests, header case, ``Connection: close``, 404 / 405 / 413 / 411, a
malformed head, a short or abandoned body, ``Expect: 100-continue``, and
/stats while a batch runs."""

from __future__ import annotations

import asyncio
import base64
import json
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from embeddings_tpu_torch.runtime import server as S
from embeddings_tpu_torch.runtime.client import HttpClient
from embeddings_tpu_torch.runtime.engine import Engine
from embeddings_tpu_torch.utils.embedding_quant import PRECISIONS

from tests.test_torch_server import TEXTS, engine, jax_twin  # noqa: F401


class _Loop:
    """An event loop in a thread, serving while the tests make requests
    from the main thread."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro, timeout: float = 60):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


@pytest.fixture(scope="module")
def loop():
    lp = _Loop()
    yield lp
    lp.close()


@pytest.fixture(scope="module")
def reranker(engine):  # noqa: F811
    """The engine's weights with a BERT-style classification head."""
    rng = np.random.default_rng(0)
    E = engine.config.hidden_size

    def t(a):
        return torch.from_numpy(a.astype(np.float32))

    params = dict(engine.params)
    params["cls_head"] = {
        "pooler": {"w": t(rng.standard_normal((E, E)) * 0.05),
                   "b": t(np.zeros(E))},
        "out": {"w": t(rng.standard_normal((E, 1)) * 0.05),
                "b": t(np.zeros(1))}}
    return Engine(params, engine.config, engine.tokenizer,
                  engine.engine_config, device="cpu")


def _url(server) -> str:
    return f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}"


@pytest.fixture(scope="module")
def port(loop, engine, reranker):  # noqa: F811
    """The port's front-ends, composed as serve_forever composes them,
    and an HTTP server over the reranker."""
    svc, servers = loop.run(S.start_serving(
        engine, host="127.0.0.1", tcp_port=0, http_port=0))
    rsrv, rsvc = loop.run(S.serve_http(reranker, "127.0.0.1", 0))
    yield {"url": _url(servers[1]), "rerank": _url(rsrv), "service": svc}
    for s in (*servers, rsrv):
        s.close()
    loop.run(svc.stop())
    loop.run(rsvc.stop())


@pytest.fixture(scope="module")
def jax(loop, engine, reranker, small_vocab):  # noqa: F811
    """The JAX package's aiohttp server over the JAX Engine on the same
    weights (and its reranker)."""
    pytest.importorskip("aiohttp")
    from embeddings_tpu.runtime.server import serve_http
    runners = []
    for eng in (engine, reranker):
        runner, svc = loop.run(serve_http(jax_twin(eng, small_vocab),
                                          "127.0.0.1", 0))
        runners.append((runner, svc))
    yield {"url": f"http://127.0.0.1:{runners[0][0].addresses[0][1]}",
           "rerank": f"http://127.0.0.1:{runners[1][0].addresses[0][1]}"}
    for runner, svc in runners:
        loop.run(runner.cleanup())
        loop.run(svc.stop())


def call(base: str, path: str, body=None, *, raw: bytes | None = None,
         method: str | None = None, timeout: float = 30):
    """(status, parsed JSON body or None) of one request."""
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, text = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        status, text = e.code, e.read()
    try:
        return status, json.loads(text)
    except ValueError:
        return status, None  # aiohttp's text bodies (404, 405, 413)


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1))).min())


# ---------------------------------------------------------------------------
# each route against the JAX package's server
# ---------------------------------------------------------------------------

EMBED_BODIES = {
    "texts": {"texts": TEXTS}, "text": {"text": "hello world"},
    "empty": {"texts": []},
    "not_json": b"not json", "not_object": b"[1]", "not_utf8": b"\xff\xfe",
    "texts_not_list": {"texts": "hello"}, "texts_ints": {"texts": [1, 2]},
    "no_texts": {"nope": 1}, "bad_precision": {"texts": ["a"],
                                               "precision": "fp8"}}


@pytest.mark.parametrize("case", list(EMBED_BODIES))
def test_embed_matches_jax(port, jax, engine, case):  # noqa: F811
    body = EMBED_BODIES[case]
    kw = {"raw": body} if isinstance(body, bytes) else {"body": body}
    (st, got), (jst, want) = (call(port["url"], "/embed", **kw),
                              call(jax["url"], "/embed", **kw))
    assert st == jst and sorted(got) == sorted(want), (got, want)
    if st != 200:
        assert st == 400 and got == want  # the same message
        return
    assert got["n_embd"] == want["n_embd"] == engine.n_embd
    assert len(got["embeddings"]) == len(want["embeddings"])
    if got["embeddings"]:
        assert _cos(got["embeddings"], want["embeddings"]) >= 0.999
        texts = body.get("texts") or [body["text"]]
        assert _cos(got["embeddings"], engine.encode(texts)) >= 0.999


@pytest.mark.parametrize("precision", [p for p in PRECISIONS
                                       if p != "float32"])
def test_embed_precision_is_jax_quantization(port, jax, precision):
    """int8 / uint8 / binary / ubinary: the JAX package's
    quantize_embeddings of the port's own float answer, exactly."""
    from embeddings_tpu.utils.embedding_quant import quantize_embeddings
    body = {"texts": TEXTS, "precision": precision}
    _, floats = call(port["url"], "/embed", {"texts": TEXTS})
    (st, got), (jst, want) = (call(port["url"], "/embed", body),
                              call(jax["url"], "/embed", body))
    assert st == jst == 200 and sorted(got) == sorted(want)
    assert got["precision"] == want["precision"] == precision
    ref = quantize_embeddings(np.asarray(floats["embeddings"], np.float32),
                              precision)
    np.testing.assert_array_equal(np.asarray(got["embeddings"]), ref)
    assert np.asarray(got["embeddings"]).shape == \
        np.asarray(want["embeddings"]).shape


OPENAI_BODIES = {
    "str": {"input": "hello world"},
    "list": {"input": TEXTS, "model": "my-model"},
    "base64_dims": {"input": TEXTS[:2], "encoding_format": "base64",
                    "dimensions": 16},
    "bad_input": {"input": [1]}, "bad_format": {"input": "x",
                                                "encoding_format": "hex"},
    "dims_zero": {"input": "x", "dimensions": 0},
    "dims_big": {"input": "x", "dimensions": 999},
    "dims_str": {"input": "x", "dimensions": "many"},
    "no_input": {}, "not_json": b"{"}


@pytest.mark.parametrize("case", list(OPENAI_BODIES))
def test_openai_embeddings_matches_jax(port, jax, engine, case):  # noqa: F811
    body = OPENAI_BODIES[case]
    kw = {"raw": body} if isinstance(body, bytes) else {"body": body}
    (st, got), (jst, want) = (call(port["url"], "/v1/embeddings", **kw),
                              call(jax["url"], "/v1/embeddings", **kw))
    assert st == jst and sorted(got) == sorted(want), (got, want)
    if st != 200:
        assert st == 400 and got == want
        assert got["error"]["type"] == "invalid_request_error"
        return
    assert got["object"] == "list" and got["model"] == want["model"]
    assert got["usage"] == want["usage"]  # the same tokenization
    assert [d["index"] for d in got["data"]] == \
        [d["index"] for d in want["data"]]
    assert sorted(got["data"][0]) == sorted(want["data"][0])

    def vecs(resp):
        if body.get("encoding_format") == "base64":
            return np.stack([np.frombuffer(base64.b64decode(d["embedding"]),
                                           "<f4") for d in resp["data"]])
        return np.asarray([d["embedding"] for d in resp["data"]])

    g, w = vecs(got), vecs(want)
    assert g.shape == w.shape and _cos(g, w) >= 0.999
    if "dimensions" in body:
        assert g.shape[-1] == body["dimensions"]
        np.testing.assert_allclose(np.linalg.norm(g, axis=-1), 1.0,
                                   atol=1e-5)


RERANK_BODIES = {
    "docs": {"query": "hello world", "return_documents": True,
             "documents": ["hello world", "water fire", "hello", "a b"]},
    "top_n": {"query": "hello", "documents": ["a", "b", "c"], "top_n": 2},
    "no_docs": {"query": "x"}, "docs_not_list": {"query": "x",
                                                 "documents": "y"},
    "bad_top_n": {"query": "x", "documents": ["y"], "top_n": "two"}}


@pytest.mark.parametrize("case", list(RERANK_BODIES))
def test_rerank_matches_jax(port, jax, reranker, case):
    body = RERANK_BODIES[case]
    (st, got), (jst, want) = (call(port["rerank"], "/rerank", body),
                              call(jax["rerank"], "/rerank", body))
    assert st == jst and sorted(got) == sorted(want), (got, want)
    if st != 200:
        assert st == 400 and got == want
        return
    assert len(got["results"]) == len(want["results"])
    assert [sorted(r) for r in got["results"]] == \
        [sorted(r) for r in want["results"]]
    scores = reranker.rerank(body["query"], body["documents"])
    assert [r["index"] for r in got["results"]] == \
        sorted(range(len(scores)), key=lambda i: -scores[i])[
            :len(got["results"])]
    jax_scores = {r["index"]: r["relevance_score"] for r in want["results"]}
    for r in got["results"]:
        assert abs(r["relevance_score"] - jax_scores[r["index"]]) < 1e-4


def test_rerank_without_head_matches_jax(port, jax):
    body = {"query": "x", "documents": ["y"]}
    (st, got), (jst, want) = (call(port["url"], "/rerank", body),
                              call(jax["url"], "/rerank", body))
    assert st == jst == 400 and got == want
    assert "classification head" in got["error"]


def test_healthz_and_stats_match_jax(port, jax):
    (st, got), (jst, want) = (call(port["url"], "/healthz"),
                              call(jax["url"], "/healthz"))
    assert st == jst == 200 and got == want
    (st, got), (jst, want) = (call(port["url"], "/stats"),
                              call(jax["url"], "/stats"))
    assert st == jst == 200 and sorted(got) == sorted(want)
    assert got["requests"] >= 0 and got["errors"] == 0


@pytest.mark.parametrize("path,method,raw", [
    ("/nope", "GET", None), ("/embed", "GET", None),
    ("/healthz", "POST", b"{}"),
    ("/embed", "POST", b"x" * (S.HTTP_MAX_BODY + 1))])
def test_refusals_match_jax_status(port, jax, path, method, raw):
    """404, 405 and 413: aiohttp's statuses; the port's bodies are JSON
    (aiohttp's are text)."""
    (st, got), (jst, _) = (call(port["url"], path, raw=raw, method=method),
                           call(jax["url"], path, raw=raw, method=method))
    assert st == jst and st in (404, 405, 413)
    assert "error" in got


def test_clients_cross(port, jax, engine):  # noqa: F811
    """Each package's HttpClient against the other's server."""
    from embeddings_tpu.runtime.client import HttpClient as JaxHttp
    got = JaxHttp(port["url"]).embed(["hello world", "a big apple"])
    want = HttpClient(jax["url"]).embed(["hello world", "a big apple"])
    assert got.shape == want.shape == (2, engine.n_embd)
    assert _cos(got, want) >= 0.999
    assert HttpClient(jax["url"]).healthz() == HttpClient(
        port["url"]).healthz()


# ---------------------------------------------------------------------------
# the port's server alone
# ---------------------------------------------------------------------------

def test_single_requests_equal_encode(port, engine):  # noqa: F811
    """A request of one text runs as a batch of one: Engine.encode's
    arithmetic (1e-5)."""
    c = HttpClient(port["url"])
    for t in TEXTS:
        np.testing.assert_allclose(c.embed(t), engine.encode(t), atol=1e-5)
    st, body = call(port["url"], "/v1/embeddings", {"input": TEXTS[0]})
    np.testing.assert_allclose(body["data"][0]["embedding"],
                               engine.encode(TEXTS[0]), atol=1e-5)


def test_http_without_aiohttp(loop, engine, monkeypatch):  # noqa: F811
    """The port never imports aiohttp: with the module made unimportable
    its server still serves /healthz and /embed."""
    monkeypatch.setitem(sys.modules, "aiohttp", None)
    with pytest.raises(ImportError):
        import aiohttp  # noqa: F401
    srv, svc = loop.run(S.serve_http(engine, "127.0.0.1", 0))
    try:
        c = HttpClient(_url(srv))
        assert c.healthz() == {"status": "ok", "n_embd": engine.n_embd}
        np.testing.assert_allclose(c.embed("hello world"),
                                   engine.encode("hello world"), atol=1e-5)
    finally:
        srv.close()
        loop.run(svc.stop())


def _raw(url: str, data: bytes, *, half_close: bool = False,
         timeout: float = 10) -> bytes:
    """Send bytes on a fresh connection; everything until the server
    closes (or the timeout)."""
    host, p = url.rsplit(":", 1)
    with socket.create_connection((host[len("http://"):], int(p)),
                                  timeout=timeout) as s:
        s.sendall(data)
        if half_close:
            s.shutdown(socket.SHUT_WR)
        out = b""
        try:
            while chunk := s.recv(65536):
                out += chunk
        except socket.timeout:
            pass
        return out


def test_keep_alive_pipelined_and_header_case(port):
    body = json.dumps({"texts": ["hello world"]}).encode()
    reqs = (b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n"
            b"POST /embed HTTP/1.1\r\nhOsT: x\r\nCONTENT-LENGTH: "
            + str(len(body)).encode() + b"\r\n\r\n" + body
            + b"GET /stats?verbose=1 HTTP/1.1\r\nConnection: close\r\n\r\n")
    out = _raw(port["url"], reqs)
    assert out.count(b"HTTP/1.1 200 OK") == 3
    assert out.count(b"Connection: keep-alive") == 2
    assert out.count(b"Connection: close") == 1  # then the server closed


def test_malformed_head_answers_400_and_closes(port):
    for bad in (b"GARBAGE\r\n\r\n", b"GET /healthz HTTP/9.9\r\n\r\n",
                b"GET /healthz HTTP/1.1\r\nno colon here\r\n\r\n",
                b"POST /embed HTTP/1.1\r\nContent-Length: x\r\n\r\n"):
        out = _raw(port["url"], bad)
        assert out.startswith(b"HTTP/1.1 400 ") and b"Connection: close" \
            in out, out
    out = _raw(port["url"], b"POST /embed HTTP/1.1\r\n"
               b"Transfer-Encoding: chunked\r\n\r\n0\r\n\r\n")
    assert out.startswith(b"HTTP/1.1 411 ")
    assert call(port["url"], "/healthz")[0] == 200  # nothing wedged


def test_short_or_abandoned_body(port, monkeypatch):
    """A body shorter than its Content-Length is never served: the
    connection closes when the client does, or when the read times out;
    a client that leaves mid-body leaves no request behind."""
    before = port["service"].stats.requests
    head = b"POST /embed HTTP/1.1\r\nContent-Length: 100\r\n\r\n"
    assert _raw(port["url"], head + b'{"texts"', half_close=True) == b""
    monkeypatch.setattr(S, "HTTP_READ_TIMEOUT_S", 0.2)
    t0 = time.perf_counter()
    assert _raw(port["url"], head + b'{"texts"') == b""
    assert time.perf_counter() - t0 < 5
    assert port["service"].stats.requests == before
    assert call(port["url"], "/embed", {"texts": ["ok"]})[0] == 200


def test_expect_100_continue(port):
    body = json.dumps({"texts": ["hello"]}).encode()
    out = _raw(port["url"], b"POST /embed HTTP/1.1\r\nExpect: 100-continue"
               b"\r\nConnection: close\r\nContent-Length: "
               + str(len(body)).encode() + b"\r\n\r\n" + body)
    assert out.startswith(b"HTTP/1.1 100 Continue\r\n\r\nHTTP/1.1 200 OK")


@pytest.fixture
def stalled(loop, engine):  # noqa: F811
    """A server whose batches take 1 s (and a 0.3 s request timeout
    when asked for)."""
    made = []

    def make(timeout=None, fail=False):
        svc = S.BatchingService(engine, request_timeout_s=timeout)
        run = svc._encode_batch_counted

        def slow(texts):
            if fail:
                raise RuntimeError("device exploded")
            time.sleep(1.0)
            return run(texts)

        svc._encode_batch_counted = slow
        srv, _ = loop.run(S.serve_http(svc, "127.0.0.1", 0))
        made.append((srv, svc))
        return _url(srv)

    yield make
    for srv, svc in made:
        srv.close()
        loop.run(svc.stop())


def test_stats_answers_while_a_batch_runs(stalled):
    url = stalled()
    t = threading.Thread(target=call, args=(url, "/embed",
                                            {"texts": ["slow"]}))
    t.start()
    time.sleep(0.2)
    t0 = time.perf_counter()
    st, body = call(url, "/stats")
    assert st == 200 and time.perf_counter() - t0 < 0.5
    t.join()
    assert call(url, "/stats")[1]["requests"] == 1


def test_timeout_and_failure_keep_the_json_contract(stalled):
    url = stalled(timeout=0.3)
    st, body = call(url, "/embed", {"texts": ["slow"]})
    assert st == 504 and "timed out" in body["error"]
    st, body = call(url, "/v1/embeddings", {"input": "slow"})
    assert st == 504 and body["error"]["type"] == "timeout"
    url = stalled(fail=True)
    st, body = call(url, "/embed", {"texts": ["boom"]})
    assert st == 500 and "device exploded" in body["error"]
    st, body = call(url, "/v1/embeddings", {"input": "boom"})
    assert st == 500 and body["error"]["type"] == "server_error"
