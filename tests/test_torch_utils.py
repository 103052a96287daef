"""The port's utilities and its native tokenizer on the CPU, against the
JAX package: ``utils.embedding_quant`` bit for bit for every precision;
``utils.benchmarking`` on CPU tensors (host clock); ``Engine.profile``'s
trace; and the port's own build of the C++ tokenizers, whose ids must
equal the port's Python tokenizers' and the JAX package's for WordPiece,
byte-level BPE (both scanner patterns) and Unigram."""

from __future__ import annotations

import json
import subprocess
import sys
import unicodedata
from pathlib import Path

import numpy as np
import pytest
import torch

from embeddings_tpu_torch.tokenizer import native as N
from embeddings_tpu_torch.utils import benchmarking as B
from embeddings_tpu_torch.utils import embedding_quant as Q

ROOT = Path(__file__).resolve().parent.parent

TEXTS = ["hello world", "the quick brown fox jumps over the lazy dog",
         "你好世界 mixed テキスト", "café naïve Ünïcödé ÀÉÎÕÜ", "ΛΟΓΟΣ σ",
         "tab\there\nnewline\r\n next", "emoji 🤖 test", "\xa0nbsp\x85nel",
         "don't 'LL 123 abc", "under_score-dash.dot", "a" * 300, "",
         "Ⅻ ⅻ ①②③", "\x00control\x1fchars"]


# ---------------------------------------------------------------------------
# embedding_quant: a copy of the JAX package's, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", Q.PRECISIONS)
def test_embedding_quant_equals_jax(precision):
    from embeddings_tpu.utils import embedding_quant as JQ
    rng = np.random.default_rng(0)
    e = rng.standard_normal((33, 100)).astype(np.float32)
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    got, want = Q.quantize_embeddings(e, precision), \
        JQ.quantize_embeddings(e, precision)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    ranges = JQ.calibration_ranges(e[:8])
    np.testing.assert_array_equal(
        Q.quantize_embeddings(e, precision, ranges),
        JQ.quantize_embeddings(e, precision, ranges))
    if precision.endswith("binary"):
        np.testing.assert_array_equal(Q.hamming_distance(got[:5], got),
                                      JQ.hamming_distance(want[:5], want))
    assert Q.PRECISIONS == JQ.PRECISIONS


# ---------------------------------------------------------------------------
# benchmarking on CPU tensors: the host clock
# ---------------------------------------------------------------------------

def test_timing_on_cpu_tensors():
    w = torch.randn(64, 64)
    calls = []

    def body(x, w):
        calls.append(1)
        return x @ w

    x = torch.randn(16, 64)
    us = B.device_time_us(body, (x, w), lo=2, hi=6, reps=2)
    assert us > 0 and len(calls) == 2 * (2 + 6)
    ids = torch.zeros(4, 8, dtype=torch.int32)  # integer input: fed back
    assert B.device_time_us(lambda i: i.float() * 2, (ids,), lo=1, hi=3,
                            reps=1) > 0
    assert B.profiled_device_time_us(body, (x, w), reps=3) > 0
    s, rate = B.wallclock_throughput(lambda: body(x, w), 16, warmup=1,
                                     reps=2)
    assert s > 0 and rate == pytest.approx(16 / s)


@pytest.mark.parametrize("raw,want", [
    ("void (anonymous namespace)::qmm_wgmma_kernel<4, true, 256, false>"
     "((anonymous namespace)::Args)",
     "qmm_wgmma_kernel<4, true, 256, false>(Args)"),
    ("void at::native::vectorized_gather_kernel<16, long>(char*, long)",
     "vectorized_gather_kernel<16, long>(char*, long)"),
    ("attn_sm90_kernel<64, 0, 2, 0, 0>", "attn_sm90_kernel<64, 0, 2, 0, 0>"),
    ("ampere_bf16_s16816gemm", "ampere_bf16_s16816gemm")])
def test_kernel_name_drops_return_type_and_namespaces(raw, want):
    """profiled_device_time_us matches name_prefix against this: the
    port's kernels live in an anonymous namespace."""
    assert B.kernel_name(raw) == want
    assert B.kernel_name(raw).startswith(want.split("<")[0].split("(")[0])


def test_engine_profile_writes_a_trace(tmp_path):
    from embeddings_tpu_torch import load_model
    eng = load_model(ROOT / "benchmarks/fixtures/tiny_trained/model",
                     dtype="q4_0", device="cpu")
    with eng.profile(tmp_path):
        eng.encode_batch(["hello world", "profile me"])
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


# ---------------------------------------------------------------------------
# the native tokenizer: the port's own build, ids equal to Python's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lib():
    """Build once per module (a no-op when another test built it)."""
    path = N.build()
    assert N.available() and path.parent.parent == N.BUILD_DIR
    return path


def test_native_build_is_the_ports_own(lib, tmp_path):
    assert lib.name == "libetok.so" and lib.exists()
    assert not str(lib).startswith(str(ROOT / "native"))
    ours = (lib.parent / "unicode_tables.h").read_text().splitlines()
    assert ours[0].startswith("// Generated by embeddings_tpu_torch")
    # the JAX package's generator's tables, all but the banner
    header = tmp_path / "unicode_tables.h"
    subprocess.run([sys.executable, str(ROOT / "native" / "gen_tables.py"),
                    str(header)], check=True, capture_output=True)
    assert ours[1:] == header.read_text().splitlines()[1:]


def test_bpe_classes_without_regex():
    """The unicodedata classes (used where ``regex`` is missing) equal
    regex's on every code point this interpreter's Unicode assigns."""
    pytest.importorskip("regex")
    rx, ud = N.bpe_classes(), N.bpe_classes(use_regex=False)
    for cp in range(0x110000):
        ch = chr(cp)
        if unicodedata.category(ch) == "Cn":
            continue
        assert [p(ch) for p in rx] == [p(ch) for p in ud], hex(cp)


def _wordpiece(small_vocab, **kw):
    from embeddings_tpu.tokenizer import WordPieceTokenizer as JT, \
        WordPieceVocab as JV
    from embeddings_tpu_torch.tokenizer import WordPieceTokenizer, \
        WordPieceVocab
    return (WordPieceTokenizer(WordPieceVocab.from_tokens(small_vocab), **kw),
            JT(JV.from_tokens(small_vocab), **kw))


@pytest.mark.parametrize("lowercase", [True, False])
def test_native_wordpiece_ids(lib, small_vocab, lowercase):
    py, jax_py = _wordpiece(small_vocab, lowercase=lowercase)
    fast = N.wrap_fast(py)
    assert isinstance(fast, N.NativeWordPieceTokenizer)
    for t in TEXTS:
        for max_len in (None, 8):
            ids = fast.encode(t, max_len=max_len)
            assert ids == py.encode(t, max_len=max_len) \
                == jax_py.encode(t, max_len=max_len), t
    assert fast.encode_batch(TEXTS) == py.encode_batch(TEXTS)


def test_native_wordpiece_refusals(lib, small_vocab):
    """Configs the C++ side cannot represent keep the Python path."""
    py, _ = _wordpiece(small_vocab, lowercase=True, strip_accents=False)
    assert N.NativeWordPieceTokenizer.wrap(py) is None
    py, _ = _wordpiece(small_vocab)
    py.max_input_chars_per_word = 50
    assert N.wrap_fast(py) is None
    assert N.NativeUnigramTokenizer.wrap(py) is None


def _bpe_pair(pattern, **kw):
    """The port's and the JAX package's byte-level BPE on one small
    vocabulary (the JAX native tests' merges)."""
    from embeddings_tpu.tokenizer.bpe import ByteLevelBPETokenizer as JB
    from embeddings_tpu_torch.tokenizer.bpe import ByteLevelBPETokenizer, \
        bytes_to_unicode
    alphabet = sorted(set(bytes_to_unicode().values()))
    vocab = {t: i for i, t in enumerate(alphabet)}
    merges = []
    for pair in [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o"),
                 ("Ġ", "w"), ("Ġw", "o"), ("Ġwo", "r"), ("Ġwor", "l"),
                 ("t", "h"), ("th", "e"), ("Ġ", "t"), ("Ġt", "he"),
                 ("1", "2"), ("12", "3"), ("Ġ", "Ġ"), ("'", "s")]:
        merges.append(pair)
        vocab.setdefault(pair[0] + pair[1], len(vocab))
    return (ByteLevelBPETokenizer(vocab, merges, pattern=pattern, **kw),
            JB(vocab, merges, pattern=pattern, **kw))


@pytest.mark.parametrize("which", ["gpt2", "qwen2"])
def test_native_bpe_ids(lib, which):
    pytest.importorskip("regex")
    from embeddings_tpu_torch.tokenizer import bpe
    pattern = {"gpt2": bpe._GPT2_PATTERN, "qwen2": bpe._QWEN2_PATTERN}[which]
    py, jax_py = _bpe_pair(pattern, add_prefix_space=which == "gpt2")
    fast = N.wrap_fast(py)
    assert isinstance(fast, N.NativeBPETokenizer)
    for t in TEXTS + ["hello world 123 he'll", "  the  the\n\n"]:
        assert fast.encode(t) == py.encode(t) == jax_py.encode(t), t
        assert fast.encode(t, max_len=5) == py.encode(t, max_len=5)
    py.pattern = r"\w+"  # a pattern the C++ scanner does not implement
    assert N.NativeBPETokenizer.wrap(py) is None


def test_native_unigram_ids(lib):
    from embeddings_tpu.tokenizer.unigram import UnigramTokenizer as JU
    from embeddings_tpu_torch.tokenizer.unigram import SPIECE, \
        UnigramTokenizer
    rng = np.random.default_rng(0)
    letters = "abcdefghijklmnop"
    pieces = [("<s>", 0.0), ("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0),
              (SPIECE, -2.0)]
    pieces += [(SPIECE + c, -3.0) for c in letters[:12]]
    pieces += [(c, -4.0) for c in letters[:12]]
    seen = {p for p, _ in pieces}
    while len(pieces) < 300:
        w = "".join(letters[i] for i in rng.integers(0, 16,
                                                     rng.integers(2, 6)))
        w = SPIECE + w if rng.random() < 0.5 else w
        if w not in seen:
            seen.add(w)
            pieces.append((w, -float(rng.uniform(1.0, 12.0))))
    py, jax_py = UnigramTokenizer(pieces, unk_id=3), JU(pieces, unk_id=3)
    fast = N.wrap_fast(py)
    assert isinstance(fast, N.NativeUnigramTokenizer)
    texts = TEXTS + ["abc def ghij klmnop", " a  b ", "ponm lkji"]
    for t in texts:
        assert fast.encode(t) == py.encode(t) == jax_py.encode(t), t
        assert fast.encode(t, max_len=6) == py.encode(t, max_len=6)
    assert fast.encode_pair("abc", "def ghi", max_len=9) == \
        py.encode_pair("abc", "def ghi", max_len=9)


def test_engine_tokenizes_natively(lib, small_vocab):
    """The Engine takes the native tokenizer when it can, and its ids are
    the Python tokenizer's."""
    from embeddings_tpu_torch.config import BertConfig, EngineConfig
    from embeddings_tpu_torch.models import params as P
    from embeddings_tpu_torch.runtime.engine import Engine
    py, _ = _wordpiece(small_vocab)
    cfg = BertConfig(vocab_size=len(small_vocab), hidden_size=32,
                     num_hidden_layers=1, num_attention_heads=2,
                     intermediate_size=64, max_position_embeddings=32)
    eng = Engine(P.init_params(cfg, 0), cfg, py,
                 EngineConfig(max_seq_len=32, seq_buckets=(32,)),
                 device="cpu")
    assert isinstance(eng._fast_tokenizer, N.NativeWordPieceTokenizer)
    for t in TEXTS:
        assert eng.tokenize(t) == py.encode(t, max_len=32)
