"""The port's token-packed path (kernels K4 and K5) against the JAX package.

(a) ``fused_attention_segmented_ref`` (K4's plain version) and
    ``fused_attention_segmented_blockskip_ref`` (K5's) against the JAX
    kernels in Pallas interpret mode, on packed rows whose segments
    straddle key blocks, fill a whole row, or leave it mostly pad; K5 at
    the exact window, the full width, and a window too small (blocks past
    the cap are dropped on both sides). f32: the same expression, f32
    summation-order noise (1e-5). bf16: the same roundings, so one bf16
    ulp; a probability on a rounding boundary may flip (2^-6 relative +
    2e-3 absolute, as K2's test).
(b) the host-side planner: ``plan_packing``, ``materialize``,
    ``max_block_span``, ``_bucket_window`` and ``block_ranges`` equal the
    JAX package's.
(c) ``encode_packed`` (bf16 and int8; row_len 16 -> K4, 640 -> K5)
    through the plain versions against JAX through its Pallas kernels in
    interpret mode, and the plain path against JAX's einsum path.
    Cosines per segment: f32 >= 0.9999, bf16 and int8 >= 0.999 (bf16
    roundings and int8 levels flip on summation-order noise).
(d) ``Engine.encode_batch_packed`` and ``BatchingService(packed=True)`` on
    the CPU against the JAX Engine, and against the bucketed path.
"""

import asyncio
import dataclasses
import functools
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from embeddings_tpu.ops import attention as jattn
from embeddings_tpu.runtime import packing as jpacking

from embeddings_tpu_torch.config import BertConfig, EngineConfig
from embeddings_tpu_torch.models import bert as tbert
from embeddings_tpu_torch.models import params as P
from embeddings_tpu_torch.ops import attention as tattn
from embeddings_tpu_torch.runtime import packing as tpacking
from embeddings_tpu_torch.runtime.engine import Engine, _bucket_window

from tests.test_torch_model import SMALL, small_q4  # noqa: F401  (fixture)

jlin = importlib.import_module("embeddings_tpu.ops.linear")
jbert = importlib.import_module("embeddings_tpu.models.bert")


def _straddling(B=3, L=256, H=2, D=64, seed=0):
    """Packed rows: segments straddling key blocks, one full-row segment,
    a short row that is mostly pad."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B * L, 3 * H * D), dtype=np.float32)
    seg = np.full((B, L), -1, np.int32)
    for b, edges in [(0, [0, 90, 130, 200, 256]), (1, [0, 256]),
                     (2, [0, 60])]:
        for s, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
            seg[b, lo:hi] = s
    return qkv, seg


def _tile_edges(L, seed):
    """Packed rows at a row length L around the Hopper kernel's tiles (64
    query rows, 128 keys): a row of segments one of which crosses key 128
    (where L > 128), a row of short segments ending in pad, and an all-pad
    row."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((3 * L, 3 * 2 * 64), dtype=np.float32)
    seg = np.full((3, L), -1, np.int32)
    cuts = [c for c in (0, 60, 100, 170, 300, 520, 600) if c < L] + [L]
    for s, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
        seg[0, lo:hi] = s
    for s, lo in enumerate(range(0, L - 20, 24)):
        seg[1, lo:lo + 24] = s
    return qkv, seg


# the 256-key rows that straddle key blocks, and rows of 64, 192 and 640
# (one query warpgroup; one key tile and a part; five key tiles)
SEGMENT_ROWS = [256, 64, 192, 640]


@pytest.mark.parametrize("L", SEGMENT_ROWS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_segmented_ref_matches_jax_interpret(dtype, L):
    B, H, D = 3, 2, 64
    qkv, seg = _straddling(B, L, H, D) if L == 256 else _tile_edges(L, L)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    ref = np.asarray(jattn.fused_attention_segmented(
        jnp.asarray(qkv, jdt), jnp.asarray(seg), B=B, L=L, H=H, D=D,
        interpret=True).astype(jnp.float32))
    got = tattn.fused_attention_segmented(
        torch.from_numpy(qkv).to(tdt), torch.from_numpy(seg), B=B, L=L, H=H,
        D=D)
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got, ref, rtol=2 ** -6, atol=2e-3)
    # pad query rows (seg -1) are exactly zero and finite
    pad = (seg < 0).reshape(B * L)
    assert np.all(got[pad] == 0) and np.isfinite(got).all()


def _padded_blocks(B=3, L=512, H=2, D=64, seed=2):
    """Packed rows of 4 query blocks whose segments span up to 3 key
    blocks, a row whose last two query blocks are all pad, and an all-pad
    row: a window of 1 drops blocks, and the all-pad blocks have the
    empty range (nK, -1)."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B * L, 3 * H * D), dtype=np.float32)
    seg = np.full((B, L), -1, np.int32)
    for b, edges in [(0, [0, 200, 330, 512]), (1, [0, 40, 256])]:
        for s, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
            seg[b, lo:hi] = s
    return qkv, seg


@pytest.mark.parametrize("window", ["exact", "full", "capped",
                                    "capped_pad"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_blockskip_ref_matches_jax_interpret(dtype, window):
    B, L, H, D = 3, 256, 2, 64
    if window == "capped_pad":
        L = 512
        qkv, seg = _padded_blocks(B, L, H, D)
        kbs, kbe = tattn.block_ranges(torch.from_numpy(seg), L)
        assert (kbe < kbs).sum() == 6  # row 1's last two blocks, row 2's
    else:
        qkv, seg = _straddling(B, L, H, D, seed=1)
    w = {"exact": jpacking.max_block_span(seg), "full": 0, "capped": 1,
         "capped_pad": 1}[window]
    if window == "capped_pad":
        assert jpacking.max_block_span(seg) > w  # the window drops blocks
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    ref = np.asarray(jattn.fused_attention_segmented_blockskip(
        jnp.asarray(qkv, jdt), jnp.asarray(seg), B=B, L=L, H=H, D=D,
        window=w, interpret=True).astype(jnp.float32))
    got = tattn.fused_attention_segmented_blockskip(
        torch.from_numpy(qkv).to(tdt), torch.from_numpy(seg), B=B, L=L, H=H,
        D=D, window=w).float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got, ref, rtol=2 ** -6, atol=2e-3)
    assert np.isfinite(got).all()
    if window in ("exact", "full"):
        # an exact or full window computes what the full kernel computes
        full = tattn.fused_attention_segmented_ref(
            torch.from_numpy(qkv).to(tdt), torch.from_numpy(seg), B=B, L=L,
            H=H, D=D).float().numpy()
        np.testing.assert_allclose(got, full, rtol=2 ** -6, atol=2e-3)


def _lengths_mix(seed=2, n=300):
    rng = np.random.default_rng(seed)
    return [int(n) for n in rng.integers(1, 120, n)]


def _query_law(seed=5, n=8192):
    """The query log's law: log-normal, median 10, sigma 0.45, 4-64."""
    rng = np.random.default_rng(seed)
    raw = 10 * np.exp(0.45 * rng.standard_normal(n))
    return [int(k) for k in np.clip(np.rint(raw), 4, 64)]


def _fitting(lengths, row_len):
    return [n for n in lengths if n <= row_len]


PLANNER_CASES = {
    # (lengths, row_len, rows a batch, segments a row)
    "mix-128": (_fitting(_lengths_mix(), 128), 128, 8, 16),
    "mix-640": (_lengths_mix(), 640, 4, 80),
    "mix-16-segs2": (_fitting(_lengths_mix(), 16), 16, 64, 2),
    "mix-640-segs1": (_lengths_mix(), 640, 4, 1),
    "query-law": (_query_law(), 128, 256, 16),
    "row-len-each": ([128] * 40 + [5, 128, 64, 128], 128, 8, 16),
    "ties": ([7] * 300 + [9] * 200 + [3] * 500 + [7] * 50, 128, 16, 16),
    "single": ([11], 128, 4, 16),
    "segs1": (_lengths_mix(6, 200), 128, 16, 1),
    "segs2": (_lengths_mix(7, 200), 128, 16, 2),
    # longer than the row: the planner cuts the segment, materialize the
    # sentence's tokens
    "cut-to-row": (_lengths_mix(8, 200), 64, 16, 8),
}


@pytest.mark.parametrize("case", list(PLANNER_CASES))
def test_planner_matches_jax(case):
    """The plan segment for segment, each pooling's arrays bit for bit
    and the mapping entry for entry, against the JAX package's loops."""
    ls, row_len, rows, segs = PLANNER_CASES[case]
    rng = np.random.default_rng(len(ls))
    st = [list(rng.integers(5, 250, n)) for n in ls]
    tb = tpacking.plan_packing(ls, row_len, rows, max_segs=segs)
    jb = jpacking.plan_packing(ls, row_len, rows, max_segs=segs)
    assert len(tb) == len(jb) > 0
    for t, j in zip(tb, jb):
        assert (t.batch, t.seq, t.n_seg) == (j.batch, j.seq, j.n_seg)
        assert [[dataclasses.astuple(s) for s in r] for r in t.rows] == \
            [[dataclasses.astuple(s) for s in r] for r in j.rows]
        for pooling in ("mean", "cls", "lasttoken"):
            a = tpacking.materialize(t, st, 0, pooling)
            b = jpacking.materialize(j, st, 0, pooling)
            for x, y in zip(a[:4], b[:4]):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            assert a[4].tolist() == [list(m) for m in b[4]]
        seg = a[1]
        assert tpacking.max_block_span(seg) == jpacking.max_block_span(seg)
        if row_len % tattn.BQ == 0:
            kbs, kbe = jattn.block_ranges(jnp.asarray(seg), row_len)
            tkbs, tkbe = tattn.block_ranges(torch.from_numpy(seg), row_len)
            np.testing.assert_array_equal(tkbs.numpy(), np.asarray(kbs))
            np.testing.assert_array_equal(tkbe.numpy(), np.asarray(kbe))


def test_bucket_window_matches_jax():
    from embeddings_tpu.runtime.engine import _bucket_window as jbw
    for row_len in (128, 256, 640, 1024, 4096):
        for w in range(0, row_len // 128 + 2):
            assert _bucket_window(w, row_len) == jbw(w, row_len), (w, row_len)


def test_attention_route_matches_jax():
    for L, seg, w in [(128, True, 0), (128, True, 1), (256, True, 0),
                      (640, True, 3), (640, True, 4), (1024, True, 3),
                      (1024, True, 15), (256, False, 0), (520, True, 2)]:
        want = jbert.attention_route_name(L, 2, 64, 128, seg, w, False,
                                          False, False, False)
        got = tbert.attention_route_name(L, 128, segmented=seg,
                                         attn_window=w)
        assert want == got, (L, seg, w)


# ---------------------------------------------------------------------------
# encode_packed against the JAX package
# ---------------------------------------------------------------------------

def _packed_batch(row_len, seed=3, n=24, max_len=60):
    rng = np.random.default_rng(seed)
    toks = [list(rng.integers(5, 256, int(k)))
            for k in rng.integers(4, max_len + 1, n)]
    toks = [t for t in toks if len(t) <= row_len]
    b = jpacking.plan_packing([len(t) for t in toks], row_len, 8,
                              max_segs=max(2, row_len // 8))[0]
    ids, seg, pos, pool, mapping = jpacking.materialize(b, toks, 0, "cls")
    w = jpacking.max_block_span(seg) if row_len > 128 else 0
    from embeddings_tpu.runtime.engine import _bucket_window as jbw
    return ids, seg, pos, pool, mapping, jbw(w, row_len)


def _jax_packed(jp, jcfg, arrays, window, *, kernels, int8=False, **kw):
    ids, seg, pos, pool = (jnp.asarray(a) for a in arrays)
    patched = {}
    if kernels:
        for name in ("fused_attention_segmented",
                     "fused_attention_segmented_blockskip"):
            patched[name] = getattr(jattn, name)
            setattr(jattn, name, functools.partial(patched[name],
                                                   interpret=True))
    try:
        with jlin.pallas_mode("always" if kernels else "never"), \
                jlin.interpret_mode(kernels), jlin.int8_mode(int8):
            return np.asarray(jbert.encode_packed(
                jp, jcfg, ids, seg, pos, pool, attn_window=window, **kw))
    finally:
        for name, fn in patched.items():
            setattr(jattn, name, fn)


def _port_packed(tp, cfg, arrays, window, **kw):
    return tbert.encode_packed(
        tp, cfg, *(torch.from_numpy(a) for a in arrays), attn_window=window,
        **kw).numpy()


def _seg_cos(got, ref, mapping):
    return min(float((got[r, s] * ref[r, s]).sum()) for r, s, _ in mapping)


@pytest.mark.parametrize("row_len,mode", [(16, "bf16"), (16, "int8"),
                                          (640, "bf16"), (640, "int8")])
def test_encode_packed_matches_jax_kernels(small_q4, monkeypatch, row_len,
                                          mode):
    jcfg, jp, cfg, tp = small_q4
    ids, seg, pos, pool, mapping, w = _packed_batch(
        row_len, max_len=16 if row_len == 16 else 60)
    route = ("fused_attention_segmented" if row_len == 16
             else "fused_attention_segmented_blockskip")
    int8 = mode == "int8"
    ref = _jax_packed(jp, jcfg, (ids, seg, pos, pool), w, kernels=True,
                      int8=int8, compute_dtype="bfloat16")
    calls = []
    orig = getattr(tattn, route)
    monkeypatch.setattr(tattn, route,
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    got = _port_packed(tp, cfg, (ids, seg, pos, pool), w, int8=int8,
                       compute_dtype=torch.bfloat16)
    assert len(calls) == cfg.num_hidden_layers  # the route of every layer
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert _seg_cos(got, ref, mapping) >= 0.999
    # empty segment slots stay zero
    used = np.zeros(got.shape[:2], bool)
    for r, s, _ in mapping:
        used[r, s] = True
    assert np.all(got[~used] == 0)


@pytest.mark.parametrize("row_len", [16, 640])
def test_encode_packed_f32_and_plain_match_jax(small_q4, row_len):
    """f32 through the plain versions against JAX's kernels (interpret),
    and the port's plain einsum path against JAX's einsum path."""
    jcfg, jp, cfg, tp = small_q4
    ids, seg, pos, pool, mapping, w = _packed_batch(
        row_len, seed=4, max_len=16 if row_len == 16 else 60)
    arrays = (ids, seg, pos, pool)
    ref = _jax_packed(jp, jcfg, arrays, w, kernels=True)
    got = _port_packed(tp, cfg, arrays, w)
    assert _seg_cos(got, ref, mapping) >= 0.9999
    ref = _jax_packed(jp, jcfg, arrays, w, kernels=False)
    got = _port_packed(tp, cfg, arrays, w, use_kernels=False)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


# ---------------------------------------------------------------------------
# the Engine and the service
# ---------------------------------------------------------------------------

TEXTS = ["hello world", "the quick brown fox", "a", "hello world",
         "jumps over the lazy dog " * 3, "a big apple", "water and fire",
         "test sentence for the embedding model", "walk", "talk",
         "the lazy dog"]


@pytest.fixture(scope="module")
def engines(small_q4, small_vocab):
    from embeddings_tpu.config import EngineConfig as JaxEC
    from embeddings_tpu.runtime.engine import Engine as JaxEngine
    from embeddings_tpu.tokenizer import WordPieceTokenizer as JT, \
        WordPieceVocab as JV
    from embeddings_tpu_torch.tokenizer import WordPieceTokenizer, \
        WordPieceVocab
    jcfg, jp, cfg, tp = small_q4
    ec = dict(batch_size=4, max_seq_len=64)
    jeng = JaxEngine(jp, jcfg, JT(JV.from_tokens(small_vocab)), JaxEC(**ec))
    tok = WordPieceTokenizer(WordPieceVocab.from_tokens(small_vocab))
    return jeng, Engine(tp, cfg, tok, EngineConfig(**ec), device="cpu")


def test_engine_packed_matches_jax_engine(engines):
    jeng, eng = engines
    # row_len 16: the long text takes the bucketed path
    ref = jeng.encode_batch_packed(TEXTS, row_len=16, batch_rows=4)
    got = eng.encode_batch_packed(TEXTS, row_len=16, batch_rows=4)
    assert got.shape == ref.shape == (len(TEXTS), 128)
    assert (got * ref).sum(-1).min() >= 0.999
    np.testing.assert_array_equal(got[0], got[3])  # identical sentences
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1, atol=1e-5)
    bucketed = eng.encode_batch(TEXTS)
    assert (got * bucketed).sum(-1).min() >= 0.9999
    assert eng.warmup_packed(row_len=16, batch_rows=4,
                             segs_per_row=(2,)) >= 1


@pytest.mark.parametrize("row_len,batch_rows", [(16, 2), (32, 4)])
def test_engine_packed_rows_land_at_their_index(engines, row_len,
                                                batch_rows):
    """A call mixing sentences longer than the row (the bucketed path)
    with short ones and with duplicates of both, over several packed
    batches: every output row is its own input's embedding, as the JAX
    Engine and the port's bucketed path give it."""
    jeng, eng = engines
    rng = np.random.default_rng(row_len)
    toks = [[2] + [int(t) for t in rng.integers(5, 256, int(n))] + [3]
            for n in rng.integers(1, row_len + 24, 40)]
    toks += [toks[3], toks[7], toks[3]]
    toks = [toks[i] for i in rng.permutation(len(toks))]
    lengths = np.array([len(t) for t in toks])
    assert (lengths > row_len).sum() >= 4 and (lengths <= row_len).sum() >= 8
    got = eng.encode_toks_packed(toks, row_len, batch_rows)
    ref = jeng.encode_toks_packed(toks, row_len, batch_rows)
    assert got.shape == ref.shape == (len(toks), 128)
    assert (got * ref).sum(-1).min() >= 0.999
    bucketed = eng.encode_toks(toks)
    assert (got * bucketed).sum(-1).min() >= 0.9999
    # each row is nearest its own input's, among distinct inputs
    sim = got @ bucketed.T
    for i, t in enumerate(toks):
        same = [k for k, u in enumerate(toks) if u == t]
        assert int(np.argmax(sim[i])) in same, i
        for k in same:
            np.testing.assert_allclose(got[k], got[i], atol=1e-5)


def test_service_packed_matches_engine(engines):
    from embeddings_tpu_torch.runtime.client import TcpClient
    from embeddings_tpu_torch.runtime.server import BatchingService, \
        serve_tcp
    jeng, eng = engines

    async def go():
        svc = BatchingService(eng, max_batch=16, max_wait_ms=50,
                              packed=True)
        await svc.start()
        try:
            outs = await svc.embed_many(TEXTS)  # >= 8 texts: packed
        finally:
            await svc.stop()
        server, svc2 = await serve_tcp(eng, "127.0.0.1", 0, packed=True)
        port = server.sockets[0].getsockname()[1]

        def client():
            with TcpClient("127.0.0.1", port) as c:
                return np.stack([c.embed(t) for t in TEXTS[:3]])
        try:
            tcp = await asyncio.wait_for(asyncio.to_thread(client), 60)
        finally:
            server.close()
            await server.wait_closed()
            await svc2.stop()
        return outs, svc.stats.as_dict(), svc2.packed, tcp

    outs, stats, packed, tcp = asyncio.run(go())
    assert packed and stats["requests"] == len(TEXTS)
    ref = jeng.encode_batch_packed(TEXTS)
    assert (outs * ref).sum(-1).min() >= 0.999
    assert (outs * eng.encode_batch_packed(TEXTS)).sum(-1).min() >= 0.9999
    for t, e in zip(TEXTS[:3], tcp):
        np.testing.assert_allclose(e, eng.encode(t), atol=1e-5)


def test_service_packed_needs_mean_or_cls(small_vocab):
    from embeddings_tpu_torch.runtime.server import BatchingService
    from embeddings_tpu_torch.tokenizer import WordPieceTokenizer, \
        WordPieceVocab
    cfg = BertConfig(**{**SMALL, "pooling": "max"})
    tok = WordPieceTokenizer(WordPieceVocab.from_tokens(small_vocab))
    eng = Engine(P.init_params(cfg, 0), cfg, tok, device="cpu")
    with pytest.raises(ValueError, match="mean/cls"):
        BatchingService(eng, packed=True)
    with pytest.raises(ValueError, match="pooling"):
        eng.encode_batch_packed(["a"])
