"""The port's model path against the JAX package, end to end on the CPU.

(a) encode_tokens through the kernels' plain versions against JAX run
    through its Pallas kernels in interpret mode: the same arithmetic, so
    f32 agrees to summation-order noise (max abs 2e-4 on unit vectors;
    bf16 activations: min cosine 0.9999, bf16 rounding flips compound
    over the layers).
(b) the same port path against JAX's default CPU path (XLA fallback:
    f32 operands, exact-erf GELU, softmax einsum): min cosine 0.999.
(c) the trained fixture through both packages' load_model: token ids
    identical, vectors equal to f32 noise; the safetensors reader against
    safetensors' own; load_native of a file written by JAX's save_native.
(d) nothing of the port, nor chip_smoke.py, imports jax or embeddings_tpu.
"""

import ast
import dataclasses
import functools
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from embeddings_tpu.config import BertConfig as JaxConfig
from embeddings_tpu.models import bert as jbert
from embeddings_tpu.models import params as JP

from embeddings_tpu_torch.config import BertConfig, EngineConfig
from embeddings_tpu_torch.models import bert as tbert
from embeddings_tpu_torch.models import params as P
from embeddings_tpu_torch.runtime.engine import Engine, load_model

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "benchmarks" / "fixtures" / "tiny_trained" / "model"
SMALL = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=256,
             max_position_embeddings=64, pooling="cls")


def _batch(seed=0, B=3, L=32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 256, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 10:] = 0
    mask[2, 1:] = 0
    return ids, mask


@pytest.fixture(scope="module")
def small_q4():
    """bge-shaped (post-LN, CLS) small model, q4_0 packed + fused qkv,
    with trained-scale weights (std 0.1) so GELU sees real inputs."""
    jcfg = JaxConfig(**SMALL)
    jp = JP.init_params(jcfg, 0)
    rng = np.random.default_rng(1)
    for lin in ("q", "k", "v", "o"):
        w = jp["layers"]["attn"][lin]["w"]
        jp["layers"]["attn"][lin]["w"] = jnp.asarray(
            rng.standard_normal(w.shape, dtype=np.float32) * 0.1)
    for lin in ("up", "down"):
        w = jp["layers"]["mlp"][lin]["w"]
        jp["layers"]["mlp"][lin]["w"] = jnp.asarray(
            rng.standard_normal(w.shape, dtype=np.float32) * 0.1)
    jp = JP.fuse_qkv(JP.pack_q4_params(JP.quantize_params(jp, "q4_0")))
    return jcfg, jp, BertConfig(**SMALL), P.from_jax_params(jp)


def _jax_kernels(jp, jcfg, ids, mask, **kw):
    """JAX forward through its Pallas kernels in interpret mode."""
    jlin = importlib.import_module("embeddings_tpu.ops.linear")
    jattn = importlib.import_module("embeddings_tpu.ops.attention")
    orig = jattn.fused_attention
    jattn.fused_attention = functools.partial(orig, interpret=True)
    try:
        with jlin.pallas_mode("always"), jlin.interpret_mode():
            return np.asarray(jbert.encode_tokens(
                jp, jcfg, jnp.asarray(ids), jnp.asarray(mask), **kw))
    finally:
        jattn.fused_attention = orig


def _port(tp, cfg, ids, mask, **kw):
    return tbert.encode_tokens(tp, cfg, torch.from_numpy(ids),
                               torch.from_numpy(mask), **kw).numpy()


def test_encode_tokens_matches_jax_kernels_f32(small_q4):
    jcfg, jp, cfg, tp = small_q4
    ids, mask = _batch()
    ref = _jax_kernels(jp, jcfg, ids, mask)
    got = _port(tp, cfg, ids, mask)
    assert got.shape == (3, 128) and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 2e-4


def test_encode_tokens_matches_jax_kernels_bf16(small_q4):
    jcfg, jp, cfg, tp = small_q4
    ids, mask = _batch(1)
    ref = _jax_kernels(jp, jcfg, ids, mask, compute_dtype="bfloat16")
    got = _port(tp, cfg, ids, mask, compute_dtype=torch.bfloat16)
    assert (got * ref).sum(-1).min() >= 0.9999


def test_encode_tokens_matches_jax_default_path(small_q4):
    jcfg, jp, cfg, tp = small_q4
    ids, mask = _batch(2)
    ref = np.asarray(jbert.encode_tokens(jp, jcfg, jnp.asarray(ids),
                                         jnp.asarray(mask)))
    got = _port(tp, cfg, ids, mask)
    assert (got * ref).sum(-1).min() >= 0.999
    # the port's plain path IS the JAX fallback's arithmetic
    plain = _port(tp, cfg, ids, mask, use_kernels=False)
    assert np.abs(plain - ref).max() <= 2e-5


@pytest.mark.parametrize("pooling", ["mean", "max", "lasttoken"])
def test_pooling_and_einsum_route_match_jax(small_q4, pooling):
    """Other poolings, and prefix_mask=False (the einsum route) with a
    non-prefix mask, against JAX's default path."""
    jcfg, jp, cfg, tp = small_q4
    ids, mask = _batch(3)
    mask[0, 3] = 0  # a hole: not a prefix
    ref = np.asarray(jbert.encode_tokens(
        jp, jcfg, jnp.asarray(ids), jnp.asarray(mask), pooling=pooling,
        prefix_mask=False))
    got = _port(tp, cfg, ids, mask, pooling=pooling, prefix_mask=False,
                use_kernels=False)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_engine_cpu_matches_jax_engine(small_q4, small_vocab,
                                       our_tokenizer):
    """Engine.encode_batch (bucketing, padding, scatter) on the CPU against
    the JAX Engine's default path on the same q4 weights."""
    from embeddings_tpu.runtime.engine import Engine as JaxEngine
    jcfg, jp, cfg, tp = small_q4
    texts = ["hello world", "the quick brown fox", "a", "hello world",
             "jumps over the lazy dog " * 3]
    ec = dict(batch_size=4, max_seq_len=64)
    from embeddings_tpu.config import EngineConfig as JaxEC
    ref = JaxEngine(jp, jcfg, our_tokenizer, JaxEC(**ec)).encode_batch(texts)
    from embeddings_tpu_torch.tokenizer import WordPieceTokenizer, \
        WordPieceVocab
    tok = WordPieceTokenizer(WordPieceVocab.from_tokens(small_vocab))
    eng = Engine(tp, cfg, tok, EngineConfig(**ec), device="cpu")
    got = eng.encode_batch(texts)
    assert got.shape == ref.shape
    assert (got * ref).sum(-1).min() >= 0.999
    np.testing.assert_array_equal(got[0], got[3])  # identical sentences
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1, atol=1e-5)
    single = eng.encode("hello world")
    np.testing.assert_allclose(single, got[0], atol=1e-6)


def test_engine_device_and_unported_modes():
    cfg = BertConfig(**SMALL)
    tp = P.init_params(cfg, 0)
    from embeddings_tpu_torch.tokenizer import WordPieceTokenizer, \
        WordPieceVocab
    tok = WordPieceTokenizer(WordPieceVocab.from_tokens(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Engine(tp, cfg, tok)  # device=None means cuda
    # the int8 mode is ported: the engine runs it (K3's plain version here)
    eng8 = Engine(tp, cfg, tok, EngineConfig(int8_compute=True),
                  device="cpu")
    emb8 = eng8.encode("a")
    assert eng8._int8 and emb8.shape == (128,) and np.isfinite(emb8).all()
    with pytest.raises(NotImplementedError, match="num_experts"):  # MoE
        Engine(tp, dataclasses.replace(cfg, num_experts=4), tok,
               device="cpu")
    eng = Engine(tp, cfg, tok, device="cpu")
    assert eng._compute_dtype == torch.float32 and eng.n_embd == 128
    assert eng.warmup(batch_sizes=(1, 2), seq_lens=(16, 32)) == 4


@pytest.mark.parametrize("dtype", ["f32", "q4_0"])
def test_load_model_fixture_matches_jax(dtype):
    from embeddings_tpu.runtime.engine import load_model as jax_load
    texts = [line.split("\t")[1] for line in (
        FIXTURE.parent / "sts-test.tsv").read_text().splitlines()[:24]]
    je = jax_load(FIXTURE, dtype=dtype)
    te = load_model(FIXTURE, dtype=dtype, device="cpu")
    assert te.config.pooling == je.config.pooling
    for t in texts[:8]:
        assert te.tokenize(t) == je.tokenize(t)
    ref = je.encode_batch(texts)
    got = te.encode_batch(texts)
    if dtype == "f32":
        # f32 weights: exp2/clamp attention vs softmax einsum, f32 noise
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    else:
        # bf16 operands + tanh GELU (port) vs f32 + erf (JAX fallback)
        assert (got * ref).sum(-1).min() >= 0.999
        plain = load_model(FIXTURE, dtype=dtype, device="cpu",
                           engine_config=EngineConfig(
                               use_pallas="never", max_seq_len=128))
        np.testing.assert_allclose(plain.encode_batch(texts), ref, rtol=0,
                                   atol=2e-5)


def test_safetensors_reader_matches_library(tmp_path):
    from safetensors.numpy import load_file
    want = load_file(str(FIXTURE / "model.safetensors"))
    got = P.read_safetensors(FIXTURE / "model.safetensors")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            np.array_equal(got[k], want[k]), k
    # other dtypes, bf16 included, through safetensors' torch writer
    from safetensors.torch import save_file
    rng = np.random.default_rng(0)
    tensors = {"bf16": torch.from_numpy(rng.standard_normal(
                   (3, 5), dtype=np.float32)).to(torch.bfloat16),
               "f16": torch.arange(6, dtype=torch.float16).reshape(2, 3),
               "i64": torch.arange(4, dtype=torch.int64),
               "scalar": torch.tensor(2.5)}
    save_file(tensors, str(tmp_path / "t.safetensors"),
              metadata={"format": "pt"})
    got = P.read_safetensors(tmp_path / "t.safetensors")
    assert got["bf16"].dtype == np.float32
    np.testing.assert_array_equal(got["bf16"], tensors["bf16"].float())
    np.testing.assert_array_equal(got["f16"], tensors["f16"].numpy())
    np.testing.assert_array_equal(got["i64"], tensors["i64"].numpy())
    assert got["scalar"].shape == () and got["scalar"] == 2.5


def test_load_native_reads_jax_checkpoint(small_q4, tmp_path):
    jcfg, jp, cfg, tp = small_q4
    path = tmp_path / "m.npz"
    JP.save_native(path, jp, jcfg)
    params, config = P.load_native(path)
    assert config == cfg
    ids, mask = _batch(4)
    want = _port(tp, cfg, ids, mask)
    np.testing.assert_array_equal(_port(params, config, ids, mask), want)
    # and the port's own writer round-trips
    P.save_native(tmp_path / "p.npz", params, config)
    again, _ = P.load_native(tmp_path / "p.npz")
    np.testing.assert_array_equal(_port(again, config, ids, mask), want)


# ---------------------------------------------------------------------------
# (d) the port imports nothing of JAX
# ---------------------------------------------------------------------------

PORT_FILES = sorted((ROOT / "embeddings_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    # aiohttp too: the card's machine has none, the port's HTTP server
    # is its own
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "embeddings_tpu", "aiohttp")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    depth = len(path.relative_to(ROOT).parts) - 1  # package nesting
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad = [a.name for a in node.names if _forbidden(a.name)]
            assert not bad, f"{path}:{node.lineno} imports {bad}"
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0 or node.level <= depth, \
                f"{path}:{node.lineno} imports above the package"
            if node.level == 0:
                assert not _forbidden(node.module or ""), \
                    f"{path}:{node.lineno} imports {node.module}"
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__"):
            args = [a.value for a in node.args
                    if isinstance(a, ast.Constant)]
            assert not any(_forbidden(str(a)) for a in args), \
                f"{path}:{node.lineno} imports {args}"


def test_capi_embedded_python_imports_no_jax():
    """The Python source the C ABI host embeds (``csrc/capi.cpp``'s
    helper string) parses, imports the port's engine and nothing of JAX:
    the import check above, on it."""
    src = (ROOT / "embeddings_tpu_torch" / "csrc" / "capi.cpp").read_text()
    helper = src.split('R"PY(', 1)[1].split(')PY"', 1)[0]
    tree = ast.parse(helper)
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods.append(node.module or "")
    assert "embeddings_tpu_torch.runtime.engine" in mods, mods
    assert not [m for m in mods if _forbidden(m)], mods
    assert "embeddings_tpu." not in helper.replace("embeddings_tpu_torch",
                                                   "")


def test_port_files_hold_the_format_modules():
    """The checks above walk the checkpoint formats' modules too."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"embeddings_tpu_torch/models/ggml_io.py",
            "embeddings_tpu_torch/models/gguf_io.py"} <= names


def test_port_files_hold_the_serving_surface():
    """The checks above walk the CLI, the utilities and the native
    tokenizer's binding too."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"embeddings_tpu_torch/cli.py",
            "embeddings_tpu_torch/utils/benchmarking.py",
            "embeddings_tpu_torch/utils/embedding_quant.py",
            "embeddings_tpu_torch/tokenizer/native.py",
            "embeddings_tpu_torch/runtime/server.py",
            "embeddings_tpu_torch/runtime/client.py"} <= names


def test_port_import_adds_no_jax_module():
    """Importing every module of the port (in a fresh interpreter) loads
    no jax, no embeddings_tpu and no aiohttp module, and has no side
    effect: no CUDA call, no native tokenizer build or load."""
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in PORT_FILES[:-1]]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import sys; before = set(sys.modules)\n"
            f"import importlib\nfor m in {mods!r}: importlib.import_module(m)\n"
            "new = set(sys.modules) - before\n"
            "bad = sorted(m for m in new if m.split('.')[0] in "
            "('jax', 'jaxlib', 'embeddings_tpu', 'aiohttp'))\n"
            "import torch\n"
            "from embeddings_tpu_torch.tokenizer import native\n"
            "bad += ['cuda'] * torch.cuda.is_initialized()\n"
            "bad += ['native'] * (native._lib is not None\n"
            "                     or native._lib_error is not None)\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
