"""Embedding service of the PyTorch port: cross-connection micro-batching
and its TCP and HTTP front-ends — the port of
``embeddings_tpu/runtime/server.py``. Only asyncio and the standard
library are needed (no aiohttp).

- ``BatchingService``: requests from any number of connections land in one
  queue; a scheduler drains up to ``max_batch`` requests (waiting at most
  ``max_wait_ms`` for stragglers), runs them as one bucket-padded device
  batch in a worker thread (``packed=True``: token-packed rows once a
  batch holds 8 or more texts), and resolves their futures.
- ``serve_tcp``: the reference's wire protocol (its server.cpp:100-118):
  the server greets with int32 n_embd, then answers each received text
  (one recv == one message, up to 32 KiB) with n_embd float32s; a client
  that opens with ``ETF2`` gets length-prefixed (v2) framing instead.
- ``serve_http``: JSON over HTTP/1.1 (keep-alive, ``Content-Length``
  bodies up to 1 MiB) on asyncio streams: ``POST /embed``, ``POST
  /v1/embeddings`` (OpenAI-compatible), ``POST /rerank``, ``GET
  /healthz``, ``GET /stats``, with the JAX package's status codes and JSON
  bodies. It returns ``(asyncio.Server, service)`` where the JAX package
  returns an aiohttp ``AppRunner``.
- ``serve_forever``: both front-ends over one service.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import struct
from collections import deque
from dataclasses import dataclass, field
from http import HTTPStatus

import numpy as np

from ..utils.embedding_quant import PRECISIONS, quantize_embeddings
from .engine import Engine

log = logging.getLogger("embeddings_tpu_torch.server")

RECV_MAX = 32 * 1024  # reference server.cpp:27 buffer size


@dataclass
class ServiceStats:
    requests: int = 0
    batches: int = 0
    tokens: int = 0
    errors: int = 0
    timeouts: int = 0
    # ring buffer of recent end-to-end request latencies (seconds)
    latencies: deque = field(default_factory=lambda: deque(maxlen=2048))

    def observe_latency(self, seconds: float) -> None:
        self.latencies.append(seconds)

    def latency_ms(self) -> dict:
        if not self.latencies:
            return {}
        xs = np.sort(np.asarray(self.latencies))

        def pct(p):  # nearest rank: ceil(p/100 * n) - 1
            return float(xs[min(len(xs) - 1,
                                max(0, int(np.ceil(p / 100 * len(xs))) - 1))])

        return {"mean": float(xs.mean() * 1e3),
                "p50": pct(50) * 1e3, "p90": pct(90) * 1e3,
                "p99": pct(99) * 1e3, "max": float(xs[-1] * 1e3)}

    def as_dict(self) -> dict:
        d = dict(requests=self.requests, batches=self.batches,
                 tokens=self.tokens, errors=self.errors,
                 timeouts=self.timeouts)
        d["avg_batch"] = self.requests / self.batches if self.batches else 0.0
        d["latency_ms"] = self.latency_ms()
        return d


class BatchingService:
    """Cross-connection micro-batching around an Engine."""

    def __init__(self, engine: Engine, *, max_batch: int | None = None,
                 max_wait_ms: float = 2.0,
                 request_timeout_s: float | None = None,
                 packed: bool = False):
        self.engine = engine
        self.max_batch = max_batch or engine.engine_config.batch_size
        self.max_wait_ms = max_wait_ms
        self.request_timeout_s = request_timeout_s
        # token-level packing for the device batches (short-text speedup)
        if packed and engine.config.pooling not in ("mean", "cls"):
            raise ValueError(
                f"packed=True requires mean/cls pooling, engine has "
                f"{engine.config.pooling!r}")
        self.packed = packed
        self.stats = ServiceStats()
        self._queue: asyncio.Queue = asyncio.Queue()
        self._task: asyncio.Task | None = None
        self._runs: set[asyncio.Task] = set()  # in-flight device batches

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._scheduler())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        # let in-flight device batches finish (their futures resolve)
        if self._runs:
            await asyncio.gather(*self._runs, return_exceptions=True)
            self._runs.clear()
        # fail queued requests so waiting clients get an error instead of
        # hanging on a future that will never resolve
        while not self._queue.empty():
            _, fut = self._queue.get_nowait()
            if not fut.done():
                fut.set_exception(ConnectionAbortedError("service stopped"))

    async def embed(self, text: str) -> np.ndarray:
        """Enqueue one text; resolves when its batch has run. Raises
        TimeoutError if request_timeout_s elapses first."""
        emb, _ = await self.embed_with_count(text)
        return emb

    async def embed_with_count(self, text: str) -> tuple[np.ndarray, int]:
        """embed() plus the text's token count, from the same
        tokenization the batch used."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        t0 = loop.time()
        await self._queue.put((text, fut))
        try:
            if self.request_timeout_s is not None:
                out = await asyncio.wait_for(asyncio.shield(fut),
                                             self.request_timeout_s)
            else:
                out = await fut
        except asyncio.TimeoutError:
            self.stats.timeouts += 1
            raise TimeoutError(
                f"embed request timed out after {self.request_timeout_s}s")
        self.stats.observe_latency(loop.time() - t0)
        return out

    async def embed_many(self, texts: list[str]) -> np.ndarray:
        embs, _ = await self.embed_many_with_usage(texts)
        return embs

    async def embed_many_with_usage(self, texts: list[str]
                                    ) -> tuple[np.ndarray, int]:
        """(embeddings, total token count): the counts ride along with
        the batch results instead of re-tokenizing."""
        if not texts:
            return np.empty((0, self.engine.n_embd), np.float32), 0
        outs = await asyncio.gather(*(self.embed_with_count(t)
                                      for t in texts))
        return np.stack([e for e, _ in outs]), sum(n for _, n in outs)

    async def _scheduler(self) -> None:
        runs = self._runs
        batch: list = []
        try:
            while True:
                batch = [await self._queue.get()]
                # straggler window: drain until max_batch or timeout
                loop = asyncio.get_running_loop()
                deadline = loop.time() + self.max_wait_ms / 1e3
                while len(batch) < self.max_batch:
                    timeout = deadline - loop.time()
                    if timeout <= 0:
                        break
                    try:
                        batch.append(await asyncio.wait_for(
                            self._queue.get(), timeout))
                    except asyncio.TimeoutError:
                        break
                # one batch runs on the device while the next is drained
                while len(runs) >= 2:
                    done, _ = await asyncio.wait(
                        runs, return_when=asyncio.FIRST_COMPLETED)
                    runs.difference_update(done)
                task = asyncio.create_task(self._run_batch(batch))
                runs.add(task)
                task.add_done_callback(runs.discard)
                batch = []
        except asyncio.CancelledError:
            # fail the batch being formed; in-flight batches keep running
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(
                        ConnectionAbortedError("service stopped"))
            raise

    def _encode_batch_counted(self, texts: list[str]
                              ) -> tuple[np.ndarray, list[int]]:
        """Tokenize once (worker thread), encode, and return (embeddings,
        per-text token counts)."""
        toks = [self.engine.tokenize(t) for t in texts]
        counts = [len(t) for t in toks]
        # packing pays off once a batch fills a useful part of the packed
        # row grid; micro-batches (light load) stay bucketed
        if self.packed and len(texts) >= 8:
            return self.engine.encode_toks_packed(toks), counts
        return self.engine.encode_toks(toks, len(texts)), counts

    async def _run_batch(self, batch: list) -> None:
        texts = [t for t, _ in batch]
        try:
            # the device step runs in a worker thread so the event loop
            # keeps accepting requests while the GPU is busy
            embs, counts = await asyncio.to_thread(
                self._encode_batch_counted, texts)
            self.stats.requests += len(batch)
            self.stats.batches += 1
            self.stats.tokens += sum(counts)
            for (_, fut), e, n in zip(batch, embs, counts):
                if not fut.done():
                    fut.set_result((e, n))
        except Exception as exc:  # resolve futures so clients see the error
            log.exception("batch of %d failed", len(batch))
            self.stats.errors += len(batch)
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(exc)


# ---------------------------------------------------------------------------
# TCP front-end (the reference's protocol, v1, and length-prefixed v2)
# ---------------------------------------------------------------------------

def _utf8_incomplete_tail(data: bytes) -> bool:
    """True if data ends mid-way through a multi-byte UTF-8 sequence."""
    for i in range(1, min(4, len(data)) + 1):
        b = data[-i]
        if b < 0x80:
            return False        # ASCII tail: complete
        if b >= 0xC0:           # lead byte: complete iff sequence fits
            need = 2 if b < 0xE0 else 3 if b < 0xF0 else 4
            return i < need
    return False


V2_MAGIC = b"ETF2"  # length-prefixed framing opt-in (first client bytes)


async def _handle_tcp(service: BatchingService, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
    """The reference wire protocol (server.cpp:100-118), plus an opt-in
    length-prefixed v2 mode behind the same greeting.

    v1 (reference clients, e.g. sample_client.py): one recv == one
    message. A multi-byte UTF-8 sequence split at a read boundary is
    reassembled before decoding (bounded by a short timeout, so a
    truncated tail cannot wedge the connection).

    v2: a client whose first bytes after the greeting are ``ETF2``
    switches the connection to robust framing — each request is
    ``<u32 LE byte-length><utf-8 payload>``, each response the usual
    n_embd float32s, up to 16 MiB a message. Classification: a sane
    length prefix within the 1 s handshake window (or the bare magic
    followed by silence — older v2 clients idle after connect) commits to
    v2; an insane prefix is a v1 text that merely starts with "ETF2". The
    exact 4-byte v1 text ``ETF2`` is reserved (it classifies as a v2
    handshake)."""
    peer = writer.get_extra_info("peername")
    log.info("client connected: %s", peer)
    try:
        writer.write(struct.pack("<i", service.engine.n_embd))
        await writer.drain()
        first = await reader.read(RECV_MAX)
        # the magic may arrive fragmented: while what we have is a strict
        # prefix of it, keep reading (briefly: a v1 client whose whole
        # message is "E", "ET" or "ETF" must still get its v1 reply)
        while first and len(first) < len(V2_MAGIC) and \
                V2_MAGIC.startswith(first):
            try:
                more = await asyncio.wait_for(
                    reader.read(RECV_MAX - len(first)), timeout=0.25)
            except asyncio.TimeoutError:
                break
            if not more:
                break
            first += more
        if first.startswith(V2_MAGIC):
            # wait up to the handshake window for the first length prefix
            rest = bytearray(first[len(V2_MAGIC):])
            while len(rest) < 4:
                try:
                    more = await asyncio.wait_for(reader.read(RECV_MAX),
                                                  timeout=1.0)
                except asyncio.TimeoutError:
                    break
                if not more:
                    break
                rest.extend(more)
            if not rest or (len(rest) >= 4 and struct.unpack(
                    "<I", bytes(rest[:4]))[0] <= _V2_MAX):
                await _serve_v2(service, reader, writer, bytes(rest))
                return
            first = V2_MAGIC + bytes(rest)  # a v1 text that starts ETF2
        data = first
        while data:
            while _utf8_incomplete_tail(data) and len(data) < RECV_MAX:
                try:
                    more = await asyncio.wait_for(
                        reader.read(RECV_MAX - len(data)), timeout=0.25)
                except asyncio.TimeoutError:
                    break
                if not more:
                    break
                data += more
            text = data.decode("utf-8", errors="replace")
            emb = await service.embed(text)
            writer.write(np.asarray(emb, np.float32).tobytes())
            await writer.drain()
            data = await reader.read(RECV_MAX)
    except (ConnectionResetError, asyncio.IncompleteReadError):
        pass
    finally:
        writer.close()
        log.info("client disconnected: %s", peer)


_V2_MAX = 16 * 1024 * 1024  # sanity cap per framed message


async def _serve_v2(service: BatchingService, reader: asyncio.StreamReader,
                    writer: asyncio.StreamWriter, leftover: bytes) -> None:
    """Length-prefixed request loop. ``leftover`` is any bytes that arrived
    with the magic (the start of the first frame)."""
    buf = bytearray(leftover)

    async def need(n: int) -> bool:
        while len(buf) < n:
            chunk = await reader.read(RECV_MAX)
            if not chunk:
                return False
            buf.extend(chunk)
        return True

    while await need(4):
        (length,) = struct.unpack("<I", buf[:4])
        if length > _V2_MAX:
            log.warning("v2 frame too large (%d bytes); closing", length)
            return
        if not await need(4 + length):
            return
        text = bytes(buf[4:4 + length]).decode("utf-8", errors="replace")
        del buf[:4 + length]
        emb = await service.embed(text)
        writer.write(np.asarray(emb, np.float32).tobytes())
        await writer.drain()


async def serve_tcp(engine_or_service, host: str = "0.0.0.0",
                    port: int = 8080, *, packed: bool = False):
    """Start the reference-protocol TCP server; returns (server, service).
    port=0 binds an ephemeral port (read it from server.sockets). Given an
    Engine, the server makes its own BatchingService (``packed`` as
    there); given a service, it serves that one."""
    service = (engine_or_service
               if isinstance(engine_or_service, BatchingService)
               else BatchingService(engine_or_service, packed=packed))
    await service.start()
    server = await asyncio.start_server(
        lambda r, w: _handle_tcp(service, r, w), host, port)
    log.info("TCP server on %s:%d (n_embd=%d)", host, port,
             service.engine.n_embd)
    return server, service


# ---------------------------------------------------------------------------
# HTTP front-end (HTTP/1.1 on asyncio streams)
# ---------------------------------------------------------------------------

HTTP_MAX_BODY = 1024 * 1024   # aiohttp's default client_max_size
HTTP_IDLE_S = 75.0            # keep-alive: wait this long for a request
HTTP_READ_TIMEOUT_S = 30.0    # the rest of a request once it has begun
_HTTP_MAX_HEADERS = 100
_HTTP_DISCARD_MAX = 64 * HTTP_MAX_BODY  # read away a refused body up to this


def _json_body(body: bytes):
    """The request's JSON object (raises ValueError otherwise, as
    aiohttp's ``request.json()`` plus the handlers' check do)."""
    obj = json.loads(body.decode("utf-8"))
    if not isinstance(obj, dict):
        raise ValueError("body must be a JSON object")
    return obj


def make_http_app(service: BatchingService) -> dict:
    """The routes: {path: {method: handler}}, each handler
    ``async (body: bytes) -> (status, JSON-able dict)``. POST /embed
    {"texts": [...]} -> {"embeddings": [...]}, POST /v1/embeddings,
    POST /rerank, GET /healthz, GET /stats."""

    async def embed(body: bytes):
        try:
            req = _json_body(body)
            texts = req["texts"] if "texts" in req else [req["text"]]
            if not isinstance(texts, list) or not all(
                    isinstance(t, str) for t in texts):
                raise ValueError("texts must be a list of strings")
            precision = req.get("precision", "float32")
            if precision not in PRECISIONS:
                raise ValueError(f"precision must be one of {PRECISIONS}")
        except (KeyError, ValueError, TypeError) as e:
            return 400, {"error": str(e) or "bad request"}
        try:
            embs = await service.embed_many(texts)
        except TimeoutError as e:
            return 504, {"error": str(e)}
        except Exception as e:  # the JSON error contract for engine faults
            log.exception("embed failed")
            return 500, {"error": f"{type(e).__name__}: {e}"}
        if precision != "float32" and len(embs):
            # vector-DB storage precisions; int8 ranges are calibrated per
            # batch (utils/embedding_quant)
            embs = quantize_embeddings(embs, precision)
        return 200, {
            "embeddings": [e.tolist() for e in embs],
            "n_embd": service.engine.n_embd,
            **({"precision": precision} if precision != "float32" else {}),
        }

    async def healthz(body: bytes):
        return 200, {"status": "ok", "n_embd": service.engine.n_embd}

    async def stats(body: bytes):
        return 200, service.stats.as_dict()

    async def openai_embeddings(body: bytes):
        """OpenAI-compatible POST /v1/embeddings: {"input": str|[str]} ->
        {"object": "list", "data": [{"embedding", "index"}], "usage"}.
        "encoding_format": "base64" (the OpenAI SDK's default: base64 of
        little-endian f32) and "dimensions" (truncate, then renormalize)."""
        def bad(msg: str):
            return 400, {"error": {"message": msg,
                                   "type": "invalid_request_error"}}
        try:
            req = _json_body(body)
            inp = req["input"]
            texts = [inp] if isinstance(inp, str) else list(inp)
            if not all(isinstance(t, str) for t in texts):
                raise ValueError("input must be a string or list of strings")
            enc_fmt = req.get("encoding_format", "float")
            if enc_fmt not in ("float", "base64"):
                raise ValueError("encoding_format must be 'float' or "
                                 "'base64'")
            dims = req.get("dimensions")
            if dims is not None:
                dims = int(dims)
                if not 0 < dims <= service.engine.n_embd:
                    raise ValueError(f"dimensions must be in [1, "
                                     f"{service.engine.n_embd}]")
        except (KeyError, ValueError, TypeError) as e:
            return bad(str(e) or "bad request")
        try:
            embs, n_tokens = await service.embed_many_with_usage(texts)
        except TimeoutError as e:
            return 504, {"error": {"message": str(e), "type": "timeout"}}
        except Exception as e:
            log.exception("v1/embeddings failed")
            return 500, {"error": {"message": f"{type(e).__name__}: {e}",
                                   "type": "server_error"}}
        if dims is not None and dims < embs.shape[-1]:
            embs = embs[:, :dims]
            norms = np.linalg.norm(embs, axis=-1, keepdims=True)
            embs = embs / np.maximum(norms, 1e-12)
        if enc_fmt == "base64":
            payload = [base64.b64encode(np.asarray(e, "<f4").tobytes())
                       .decode("ascii") for e in embs]
        else:
            payload = [e.tolist() for e in embs]
        return 200, {
            "object": "list",
            "data": [{"object": "embedding", "embedding": e, "index": i}
                     for i, e in enumerate(payload)],
            "model": str(req.get("model", "embeddings-tpu")),
            "usage": {"prompt_tokens": n_tokens, "total_tokens": n_tokens},
        }

    async def rerank(body: bytes):
        """Cross-encoder reranking, Jina/Cohere-style: {"query": str,
        "documents": [str], "top_n"?: int, "return_documents"?: bool} ->
        {"results": [{"index", "relevance_score"(, "document")}]} by score,
        descending. Needs a reranker checkpoint (a classification head)."""
        try:
            req = _json_body(body)
            query, docs = req["query"], req["documents"]
            if not isinstance(query, str) or not isinstance(docs, list) \
                    or not all(isinstance(d, str) for d in docs):
                raise ValueError("query must be a string and documents "
                                 "a list of strings")
            top_n = req.get("top_n")
            top_n = len(docs) if top_n is None else int(top_n)
            return_docs = bool(req.get("return_documents", False))
        except (KeyError, ValueError, TypeError) as e:
            return 400, {"error": str(e) or "bad request"}
        if "cls_head" not in service.engine.params:
            return 400, {"error": "this model has no classification head — "
                                  "load a cross-encoder/reranker checkpoint"}
        try:
            scores = await asyncio.to_thread(service.engine.rerank, query,
                                             docs)
        except Exception as e:
            log.exception("rerank failed")
            return 500, {"error": f"{type(e).__name__}: {e}"}
        order = sorted(range(len(docs)), key=lambda i: -scores[i])[:top_n]
        return 200, {"results": [
            {"index": i, "relevance_score": float(scores[i]),
             **({"document": docs[i]} if return_docs else {})}
            for i in order]}

    return {"/embed": {"POST": embed},
            "/v1/embeddings": {"POST": openai_embeddings},
            "/rerank": {"POST": rerank},
            "/healthz": {"GET": healthz},
            "/stats": {"GET": stats}}


async def _http_respond(writer: asyncio.StreamWriter, status: int,
                        payload, *, keep_alive: bool,
                        headers: dict | None = None) -> None:
    body = json.dumps(payload).encode()
    head = [f"HTTP/1.1 {status} {HTTPStatus(status).phrase}",
            "Content-Type: application/json; charset=utf-8",
            f"Content-Length: {len(body)}",
            f"Connection: {'keep-alive' if keep_alive else 'close'}"]
    head += [f"{k}: {v}" for k, v in (headers or {}).items()]
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body)
    await writer.drain()


class _BadRequest(Exception):
    pass


async def _read_head(reader: asyncio.StreamReader
                     ) -> tuple[str, str, str, dict] | None:
    """(method, path, version, lower-cased headers) of the next request,
    or None when the client closed (or idled out) between requests.
    Raises _BadRequest on a malformed head."""
    try:
        line = await asyncio.wait_for(reader.readline(), HTTP_IDLE_S)
    except asyncio.TimeoutError:
        return None
    except ValueError:  # a line over the stream's limit
        raise _BadRequest("request line too long") from None
    if not line:
        return None
    parts = line.decode("latin-1").rstrip("\r\n").split(" ")
    if len(parts) != 3 or not parts[0].isalpha() \
            or not parts[1].startswith("/") \
            or parts[2] not in ("HTTP/1.0", "HTTP/1.1"):
        raise _BadRequest(f"malformed request line {line[:80]!r}")
    headers: dict[str, str] = {}
    for _ in range(_HTTP_MAX_HEADERS + 1):
        try:
            raw = await asyncio.wait_for(reader.readline(),
                                         HTTP_READ_TIMEOUT_S)
        except ValueError:
            raise _BadRequest("header line too long") from None
        if not raw.endswith(b"\n"):
            return None  # closed (or timed out) mid-head
        if raw in (b"\r\n", b"\n"):
            return parts[0], parts[1].split("?", 1)[0], parts[2], headers
        name, sep, value = raw.decode("latin-1").partition(":")
        if not sep or not name or name != name.strip() or " " in name:
            raise _BadRequest(f"malformed header {raw[:80]!r}")
        headers[name.lower()] = value.strip()
    raise _BadRequest("too many headers")


async def _handle_http(routes: dict, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
    """Serve requests on one connection until the client closes, asks
    to close, idles out or sends a request that cannot be framed."""
    try:
        while True:
            try:
                head = await _read_head(reader)
            except _BadRequest as e:
                await _http_respond(writer, 400, {"error": str(e)},
                                    keep_alive=False)
                return
            if head is None:
                return
            method, path, version, headers = head
            conn = headers.get("connection", "").lower()
            keep_alive = ("close" not in conn if version == "HTTP/1.1"
                          else "keep-alive" in conn)
            if "transfer-encoding" in headers:
                await _http_respond(
                    writer, 411, {"error": "send the body with "
                                           "Content-Length"},
                    keep_alive=False)
                return
            try:
                length = int(headers.get("content-length", "0"))
                if length < 0:
                    raise ValueError
            except ValueError:
                await _http_respond(writer, 400,
                                    {"error": "bad Content-Length"},
                                    keep_alive=False)
                return
            expect = headers.get("expect", "").lower() == "100-continue"
            if length > HTTP_MAX_BODY:
                left = length if not expect and \
                    length <= _HTTP_DISCARD_MAX else 0
                while left > 0:
                    # read the body away, so the client gets to read the
                    # answer instead of a reset
                    chunk = await asyncio.wait_for(
                        reader.read(min(left, RECV_MAX)),
                        HTTP_READ_TIMEOUT_S)
                    if not chunk:
                        return
                    left -= len(chunk)
                await _http_respond(
                    writer, 413, {"error": f"Maximum request body size "
                                           f"{HTTP_MAX_BODY} exceeded, actual "
                                           f"body size {length}"},
                    keep_alive=False)
                return
            if expect:
                writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            # a body shorter than its Content-Length times out (or ends
            # with the connection): the request is dropped unserved
            body = await asyncio.wait_for(reader.readexactly(length),
                                          HTTP_READ_TIMEOUT_S)
            handlers = routes.get(path)
            extra = None
            if handlers is None:
                status, payload = 404, {"error": f"not found: {path}"}
            elif method not in handlers:
                status = 405
                payload = {"error": f"method {method} not allowed on {path}"}
                extra = {"Allow": ", ".join(handlers)}
            else:
                try:
                    status, payload = await handlers[method](body)
                except Exception as e:
                    log.exception("%s %s failed", method, path)
                    status = 500
                    payload = {"error": f"{type(e).__name__}: {e}"}
            await _http_respond(writer, status, payload,
                                keep_alive=keep_alive, headers=extra)
            if not keep_alive:
                return
    except (ConnectionError, asyncio.IncompleteReadError,
            asyncio.TimeoutError):
        pass
    finally:
        writer.close()


async def serve_http(engine_or_service, host: str = "0.0.0.0",
                     port: int = 8081):
    """Start the HTTP front-end; returns (server, service), server an
    ``asyncio.Server`` (port=0: an ephemeral port, in server.sockets)."""
    service = (engine_or_service
               if isinstance(engine_or_service, BatchingService)
               else BatchingService(engine_or_service))
    await service.start()
    routes = make_http_app(service)
    server = await asyncio.start_server(
        lambda r, w: _handle_http(routes, r, w), host, port)
    log.info("HTTP server on %s:%d", host, port)
    return server, service


async def start_serving(engine: Engine, *, host: str = "0.0.0.0",
                        tcp_port: int | None = 8080,
                        http_port: int | None = 8081,
                        max_batch: int | None = None,
                        max_wait_ms: float = 2.0,
                        request_timeout_s: float | None = None,
                        packed: bool = False
                        ) -> tuple[BatchingService, list[asyncio.Server]]:
    """Start the TCP and/or HTTP front-ends over one shared batching
    service; returns (service, servers)."""
    service = BatchingService(engine, max_batch=max_batch,
                              max_wait_ms=max_wait_ms,
                              request_timeout_s=request_timeout_s,
                              packed=packed)
    await service.start()
    servers = []
    if tcp_port is not None:
        servers.append((await serve_tcp(service, host, tcp_port))[0])
    if http_port is not None:
        servers.append((await serve_http(service, host, http_port))[0])
    return service, servers


async def serve_forever(engine: Engine, **kw) -> None:
    """Run ``start_serving``'s front-ends until cancelled (keywords as
    there), then close them and stop the service."""
    service, servers = await start_serving(engine, **kw)
    try:
        await asyncio.Event().wait()
    finally:
        for server in servers:
            server.close()
        await service.stop()
