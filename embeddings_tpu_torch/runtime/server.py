"""Embedding service of the PyTorch port: cross-connection micro-batching
and the reference-compatible (v1) TCP front-end — the port of
``embeddings_tpu/runtime/server.py`` (``ServiceStats``,
``BatchingService``, ``serve_tcp``). Only asyncio is needed.

- ``BatchingService``: requests from any number of connections land in one
  queue; a scheduler drains up to ``max_batch`` requests (waiting at most
  ``max_wait_ms`` for stragglers), runs them as one bucket-padded device
  batch in a worker thread (``packed=True``: token-packed rows once a
  batch holds 8 or more texts), and resolves their futures.
- ``serve_tcp``: the reference's wire protocol (its server.cpp:100-118):
  the server greets with int32 n_embd, then answers each received text
  (one recv == one message, up to 32 KiB) with n_embd float32s.

The v2 length-prefixed framing and HTTP (with its ``/rerank`` route)
are not ported yet; ``Engine.rerank`` is.
"""

from __future__ import annotations

import asyncio
import logging
import struct
from collections import deque
from dataclasses import dataclass, field

import numpy as np

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
        if not texts:
            return np.empty((0, self.engine.n_embd), np.float32)
        outs = await asyncio.gather(*(self.embed_with_count(t)
                                      for t in texts))
        return np.stack([e for e, _ in outs])

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
# TCP front-end (reference-compatible protocol, v1)
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


async def _handle_tcp(service: BatchingService, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
    """The reference wire protocol: greet with int32 n_embd, then one
    recv == one message. A multi-byte UTF-8 sequence split at a read
    boundary is reassembled before decoding (bounded by a short timeout,
    so a truncated tail cannot wedge the connection)."""
    peer = writer.get_extra_info("peername")
    log.info("client connected: %s", peer)
    try:
        writer.write(struct.pack("<i", service.engine.n_embd))
        await writer.drain()
        data = await reader.read(RECV_MAX)
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
