"""The port's serving layer on the CPU: cross-request batching and the v1
and v2 TCP framings, against the port's own Engine.encode and, for wire
compatibility, the JAX package's clients and engine. Answers for the same
text from a batch of one run the same arithmetic as Engine.encode, so
they agree to f32 noise (1e-5); answers batched with other texts may pad
to another length bucket, and the JAX engine's default path computes in
f32 with exact-erf GELU, so those compare by cosine (0.999)."""

import asyncio
import struct

import numpy as np
import pytest

from embeddings_tpu_torch.config import BertConfig, EngineConfig
from embeddings_tpu_torch.models import params as P
from embeddings_tpu_torch.runtime.client import TcpClient
from embeddings_tpu_torch.runtime.engine import Engine
from embeddings_tpu_torch.runtime.server import (BatchingService,
                                                 _utf8_incomplete_tail,
                                                 serve_tcp)
from embeddings_tpu_torch.tokenizer import WordPieceTokenizer, \
    WordPieceVocab

TEXTS = ["hello world", "the quick brown fox jumps over the lazy dog",
         "你好世界", "a big apple"]


@pytest.fixture(scope="module")
def engine(small_vocab):
    tok = WordPieceTokenizer(WordPieceVocab.from_tokens(small_vocab))
    cfg = BertConfig(vocab_size=len(small_vocab), hidden_size=128,
                     num_hidden_layers=2, num_attention_heads=2,
                     intermediate_size=256, max_position_embeddings=64)
    params = P.fuse_qkv(P.pack_q4_params(P.quantize_params(
        P.init_params(cfg, 0), "q4_0")))
    ec = EngineConfig(seq_buckets=(16, 32), max_seq_len=32, batch_size=8,
                      batch_buckets=(1, 2, 4, 8))
    return Engine(params, cfg, tok, ec, device="cpu")


async def _serve(engine, client_fn):
    server, svc = await serve_tcp(engine, host="127.0.0.1", port=0)
    port = server.sockets[0].getsockname()[1]
    try:
        return await asyncio.wait_for(
            asyncio.to_thread(client_fn, port), timeout=60)
    finally:
        server.close()
        await server.wait_closed()
        await svc.stop()


def test_tcp_round_trip_equals_encode(engine):
    def client(port):
        with TcpClient("127.0.0.1", port) as c:
            return c.n_embd, [c.embed(t) for t in TEXTS]

    n_embd, answers = asyncio.run(_serve(engine, client))
    assert n_embd == engine.n_embd == 128
    for text, got in zip(TEXTS, answers):
        np.testing.assert_allclose(got, engine.encode(text), atol=1e-5)


def test_tcp_wire_compatible_with_jax_client(engine):
    """The JAX package's v1 TcpClient speaks to the port's server."""
    from embeddings_tpu.runtime.client import TcpClient as JaxClient

    def client(port):
        with JaxClient("127.0.0.1", port) as c:
            return c.embed("hello world")

    got = asyncio.run(_serve(engine, client))
    np.testing.assert_allclose(got, engine.encode("hello world"), atol=1e-5)


def test_tcp_utf8_split_across_reads(engine):
    """A multi-byte character split over two sends is reassembled."""
    import socket

    def client(port):
        with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
            n = struct.unpack("<i", s.recv(4))[0]
            data = "你好世界".encode()
            s.sendall(data[:4])
            s.sendall(data[4:])
            buf = b""
            while len(buf) < 4 * n:
                buf += s.recv(4 * n - len(buf))
            return np.frombuffer(buf, np.float32)

    got = asyncio.run(_serve(engine, client))
    np.testing.assert_allclose(got, engine.encode("你好世界"), atol=1e-5)
    assert _utf8_incomplete_tail("你".encode()[:2])
    assert not _utf8_incomplete_tail(b"abc")


def test_service_batches_concurrent_requests(engine):
    async def go():
        svc = BatchingService(engine, max_batch=8, max_wait_ms=50)
        await svc.start()
        try:
            outs = await svc.embed_many(TEXTS * 4)
        finally:
            await svc.stop()
        return outs, svc.stats.as_dict()

    outs, stats = asyncio.run(go())
    assert outs.shape == (16, engine.n_embd)
    assert stats["requests"] == 16 and stats["batches"] <= 4, stats
    assert stats["latency_ms"]["p99"] >= stats["latency_ms"]["p50"] > 0
    ref = engine.encode_batch(TEXTS * 4)
    assert (outs * ref).sum(-1).min() >= 0.999


def test_service_error_propagates_and_recovers(engine):
    async def go():
        svc = BatchingService(engine)
        await svc.start()
        try:
            with pytest.raises(Exception):
                await svc.embed(12345)  # tokenize raises in the worker
            return await svc.embed("hello")
        finally:
            await svc.stop()

    emb = asyncio.run(go())
    assert emb.shape == (engine.n_embd,)


def test_service_request_timeout(engine):
    async def go():
        # scheduler never started: the request can only time out
        svc = BatchingService(engine, request_timeout_s=0.05)
        with pytest.raises(TimeoutError):
            await svc.embed("hello")
        return svc.stats.timeouts

    assert asyncio.run(go()) == 1


def to_jax_tree(t):
    """A port parameter tree as the JAX package's (numpy leaves, its
    QuantizedTensor)."""
    if isinstance(t, dict):
        return {k: to_jax_tree(v) for k, v in t.items()}
    if hasattr(t, "codes"):
        from embeddings_tpu.ops.quant import QuantizedTensor
        return QuantizedTensor(
            t.codes.numpy(), t.scales.numpy(),
            None if t.mins is None else t.mins.numpy(), t.kind,
            t.block_axis, t.packed)
    return t.numpy()


def jax_twin(engine, small_vocab):
    """The JAX Engine (default CPU path) on the port engine's weights,
    config, vocabulary and buckets."""
    from embeddings_tpu.config import BertConfig as JC, EngineConfig as JEC
    from embeddings_tpu.runtime.engine import Engine as JaxEngine
    from embeddings_tpu.tokenizer import WordPieceTokenizer as JT, \
        WordPieceVocab as JV
    ec = engine.engine_config
    return JaxEngine(to_jax_tree(engine.params),
                     JC(**engine.config.to_dict()),
                     JT(JV.from_tokens(small_vocab)),
                     JEC(seq_buckets=ec.seq_buckets,
                         max_seq_len=ec.max_seq_len,
                         batch_size=ec.batch_size,
                         batch_buckets=ec.batch_buckets))


def test_port_server_answers_match_jax_engine(engine, small_vocab):
    """Same weights through the JAX Engine (default CPU path)."""
    ref = jax_twin(engine, small_vocab).encode_batch(TEXTS)

    def client(port):
        with TcpClient("127.0.0.1", port) as c:
            return np.stack([c.embed(t) for t in TEXTS])

    got = asyncio.run(_serve(engine, client))
    assert (got * ref).sum(-1).min() >= 0.999


# ---------------------------------------------------------------------------
# v2 (length-prefixed) framing
# ---------------------------------------------------------------------------

def _recv_emb(sock, n_embd: int) -> np.ndarray:
    buf = b""
    while len(buf) < 4 * n_embd:
        chunk = sock.recv(4 * n_embd - len(buf))
        if not chunk:
            break
        buf += chunk
    return np.frombuffer(buf, np.float32).copy()


def test_tcp_v2_round_trip(engine):
    """v2 frames: a text above one v1 read (32 KiB), and two frames in
    one send give two answers; the port's and the JAX package's v2
    clients both speak to the port's server."""
    from embeddings_tpu.runtime.client import TcpClient as JaxClient
    big = "hello world " * 4000

    def client(port):
        out = {}
        with TcpClient("127.0.0.1", port, framing="v2") as c:
            out["one"] = c.embed("hello world")
            out["big"] = c.embed(big)
            a, b = "hello world".encode(), "a big apple".encode()
            c.sock.sendall(struct.pack("<I", len(a)) + a
                           + struct.pack("<I", len(b)) + b)
            out["r1"] = _recv_emb(c.sock, c.n_embd)
            out["r2"] = _recv_emb(c.sock, c.n_embd)
        with JaxClient("127.0.0.1", port, framing="v2") as c:
            out["jax"] = c.embed("你好世界")
        return out

    r = asyncio.run(_serve(engine, client))
    for key, text in (("one", "hello world"), ("big", big),
                      ("r1", "hello world"), ("r2", "a big apple"),
                      ("jax", "你好世界")):
        np.testing.assert_allclose(r[key], engine.encode(text), atol=1e-5)
    with pytest.raises(ValueError):
        TcpClient("127.0.0.1", 1, framing="v3")


def test_tcp_v2_classification(engine):
    """A magic split across reads still selects v2; a bare ETF2 that idles
    past the 1 s handshake window commits to v2; a v1 text that starts
    with ETF2 (an insane length prefix) stays v1; a v1 text that is a
    proper prefix of the magic gets its v1 answer after 0.25 s."""
    import socket
    import time

    def client(port):
        out = {}

        def conn():
            s = socket.create_connection(("127.0.0.1", port), timeout=15)
            return s, struct.unpack("<i", s.recv(4))[0]

        payload = "hello world".encode()
        s, n = conn()
        s.sendall(b"ET")
        time.sleep(0.05)
        s.sendall(b"F2" + struct.pack("<I", len(payload)) + payload)
        out["fragmented"] = _recv_emb(s, n)
        s.close()
        s, n = conn()
        s.sendall(b"ETF2")
        time.sleep(1.3)
        s.sendall(struct.pack("<I", len(payload)) + payload)
        out["idle"] = _recv_emb(s, n)
        s.close()
        s, n = conn()
        s.sendall(b"ETF2000 report hello world")
        out["v1_magic"] = _recv_emb(s, n)
        s.close()
        s, n = conn()
        s.sendall(b"ET")
        out["v1_prefix"] = _recv_emb(s, n)
        s.close()
        return out

    r = asyncio.run(_serve(engine, client))
    want = engine.encode("hello world")
    np.testing.assert_allclose(r["fragmented"], want, atol=1e-5)
    np.testing.assert_allclose(r["idle"], want, atol=1e-5)
    np.testing.assert_allclose(r["v1_magic"],
                               engine.encode("ETF2000 report hello world"),
                               atol=1e-5)
    np.testing.assert_allclose(r["v1_prefix"], engine.encode("ET"),
                               atol=1e-5)


def test_embed_many_with_usage(engine):
    """Token counts ride along with the batch: they equal the engine's
    tokenization, without a second pass."""
    async def go():
        svc = BatchingService(engine, max_batch=8, max_wait_ms=20)
        await svc.start()
        try:
            return (await svc.embed_many_with_usage(TEXTS),
                    await svc.embed_many_with_usage([]))
        finally:
            await svc.stop()

    (embs, n), (none, zero) = asyncio.run(go())
    assert n == sum(len(engine.tokenize(t)) for t in TEXTS)
    assert embs.shape == (len(TEXTS), engine.n_embd)
    assert none.shape == (0, engine.n_embd) and zero == 0
