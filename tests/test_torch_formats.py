"""The ggml ``.bin`` and GGUF formats in the port against the JAX package,
on the CPU (``embeddings_tpu_torch/models/{ggml_io,gguf_io}.py`` and the
codecs of ``ops/quant.py``).

(a) Same bytes: every legacy (.bin) and GGUF block codec, the K-quants
    included, and ``write_ggml`` / ``write_gguf`` in every dtype, for the
    same parameters (carried across with ``from_jax_params``).
(b) The reference's own files: ``read_ggml`` of ``ggml-model-f32.bin`` is
    bit-exact to ``model.safetensors`` (read with the port's
    ``read_safetensors``); the f16 file is within f16 rounding.
(c) Load parity: ``load_model(.bin | .gguf, device="cpu")`` in both
    packages, the port's kernel path (the kernels' plain versions here)
    against JAX's Pallas path in interpret mode: max abs 1e-5 in f32 and
    2e-3 quantized (the documented q4_0 tolerance), over q4_0 (packed and
    not), q4_1, q8_0 and K-quant files re-quantized on load; a quantized
    file keeps its kind and is packed only for a q4 dtype.
(d) Other archs and tokenizers: nomic-bert and jina-bert-v2 GGUFs agree
    across the packages; a nomic-bert-moe GGUF reads and loads to JAX's
    tree and forward, and the writers refuse its MoE tree (the GGUF
    export has no form for it); ``_tokenizer_from_gguf`` (bert, t5 with a
    charsmap, gpt2) gives JAX's ids; malformed files raise JAX's errors.
"""

import functools
import importlib
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from embeddings_tpu.config import BertConfig as JaxConfig, \
    EngineConfig as JaxEngineConfig
from embeddings_tpu.models import bert as jbert, ggml_io as JG, \
    gguf_io as JF, params as JP
from embeddings_tpu.ops import quant as JQ
from embeddings_tpu.runtime.engine import load_model as jax_load

from embeddings_tpu_torch.config import BertConfig
from embeddings_tpu_torch.models import bert as tbert, ggml_io as TG, \
    gguf_io as TF, params as P
from embeddings_tpu_torch.ops import quant as TQ
from embeddings_tpu_torch.ops.quant import QuantizedTensor
from embeddings_tpu_torch.runtime.engine import load_model

from .test_gguf_io import _arch_weights, _write_raw_gguf
from .test_moe import MOE_HF_DICT, _moe_state_dict, _write_moe_gguf

jlin = importlib.import_module("embeddings_tpu.ops.linear")

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "ref_parity"
TEXTS = ["hello world", "the quick brown fox jumps over the lazy dog",
         "你好世界", "hello world"]
# (hidden, intermediate): E=64 for the 32-blocked kinds, E=256 for the
# K-quants (a 256-element super-block along every quantized row)
SHAPES = {"small": (64, 128), "kquant": (256, 512)}


def _cfgs(small_vocab, which):
    E, I = SHAPES[which]
    kw = dict(vocab_size=len(small_vocab), hidden_size=E,
              num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=I, max_position_embeddings=64)
    return JaxConfig(**kw), BertConfig(**kw)


@pytest.fixture(scope="module")
def trees(small_vocab):
    """{which: (jax cfg, jax params, port cfg, port params)}."""
    out = {}
    for which in SHAPES:
        jcfg, cfg = _cfgs(small_vocab, which)
        jp = JP.init_params(jcfg, rng=0)
        out[which] = (jcfg, jp, cfg, P.from_jax_params(jp))
    return out


# ---------------------------------------------------------------------------
# (a) same bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["ggml_q4_0", "ggml_q4_1", "ggml_q8_0",
                                   "q4_0", "q4_1", "q8_0", "q4_K", "q5_K",
                                   "q6_K", "helpers"])
def test_codecs_match_jax(codec):
    rng = np.random.default_rng(11)
    w = rng.standard_normal((256, 24), dtype=np.float32)  # [K, N]
    if codec.startswith("ggml_"):
        kind = codec[5:]
        if kind == "q4_1":
            q, d, m = TQ.quantize_q4_1(w)
            buf = TQ.pack_ggml_q4_1(q, d, m)
            assert buf == JQ.pack_ggml_q4_1(q, d, m)
        else:
            q, d = getattr(TQ, f"quantize_{kind}")(w)
            buf = getattr(TQ, f"pack_ggml_{kind}")(q, d)
            assert buf == getattr(JQ, f"pack_ggml_{kind}")(q, d)
        got = getattr(TQ, f"unpack_ggml_{kind}")(buf, 256, 24)
        ref = getattr(JQ, f"unpack_ggml_{kind}")(buf, 256, 24)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    elif codec == "helpers":
        qt = TQ.quantize(w, "q4_1", pack4=True)
        jqt = JQ.quantize(w, "q4_1", pack4=True)
        np.testing.assert_array_equal(TQ.codes_int8(qt), JQ.codes_int8(jqt))
        emb = TQ.quantize(w.T.copy(), "q4_0", block_axis=-1, pack4=True)
        jemb = JQ.quantize(w.T.copy(), "q4_0", block_axis=-1, pack4=True)
        np.testing.assert_array_equal(TQ.codes_int8(emb),
                                      JQ.codes_int8(jemb))
        c, s, m = (TQ.codes_int8(qt), qt.scales.numpy(), qt.mins.numpy())
        np.testing.assert_array_equal(TQ.dequantize_np(c, s, m, "q4_1"),
                                      JQ.dequantize_np(c, s, m, "q4_1"))
        np.testing.assert_array_equal(TQ.nibble_histogram(c),
                                      JQ.nibble_histogram(c))
        un = P.unpack_q4_params({"w": qt})["w"]
        assert not un.packed
        np.testing.assert_array_equal(un.codes.numpy(), c)
        assert P.param_bytes({"w": qt, "b": qt.scales}) == (
            qt.codes.numel() + 2 * qt.scales.numel() * 4
            + qt.mins.numel() * 4)
    else:
        a = np.ascontiguousarray(w.T)  # [R, K], K innermost
        buf = getattr(TF, f"{codec}_to_bytes")(a)
        assert buf == getattr(JF, f"{codec}_to_bytes")(a)
        got = getattr(TF, f"{codec}_from_bytes")(buf, 24, 256)
        ref = getattr(JF, f"{codec}_from_bytes")(buf, 24, 256)
        for g, r in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("fmt,dtype", [
    ("bin", "f32"), ("bin", "f16"), ("bin", "q4_0"), ("bin", "q4_1"),
    ("gguf", "f32"), ("gguf", "f16"), ("gguf", "q4_0"), ("gguf", "q4_1"),
    ("gguf", "q8_0"), ("gguf", "q4_K")])
def test_writers_match_jax_bytes(tmp_path, trees, small_vocab, fmt,
                                 dtype):
    jcfg, jp, cfg, tp = trees["kquant" if dtype == "q4_K" else "small"]
    port, jax_ = tmp_path / f"port.{fmt}", tmp_path / f"jax.{fmt}"
    if fmt == "bin":
        TG.write_ggml(port, tp, cfg, small_vocab, dtype=dtype)
        JG.write_ggml(jax_, jp, jcfg, small_vocab, dtype=dtype)
    else:
        TF.write_gguf(port, tp, cfg, small_vocab, dtype=dtype)
        JF.write_gguf(jax_, jp, jcfg, small_vocab, dtype=dtype)
    assert port.read_bytes() == jax_.read_bytes()
    # and the port's reader reads the file as JAX's does
    if fmt == "bin":
        got, gcfg, vocab = TG.read_ggml(port, dequant=True)
        ref, rcfg, _ = JG.read_ggml(port, dequant=True)
        assert vocab == list(small_vocab)
    else:
        got, gcfg, _ = TF.read_gguf(port, dequant=True)
        ref, rcfg, _ = JF.read_gguf(port, dequant=True)
    assert gcfg.to_dict() == rcfg.to_dict() and set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)


# ---------------------------------------------------------------------------
# (b) the reference's own files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ggml-model-f32.bin", "ggml-model-f16.bin"])
def test_reference_bin_matches_safetensors(name):
    sd, cfg, vocab = TG.read_ggml(FIXTURE / name)
    st = P.read_safetensors(FIXTURE / "model.safetensors")
    st = {k.removeprefix("bert."): v for k, v in st.items()}
    assert set(sd) == set(st) - {"pooler.dense.weight", "pooler.dense.bias"}
    assert vocab == (FIXTURE / "vocab.txt").read_text(
        encoding="utf-8").splitlines()
    assert (cfg.hidden_size, cfg.num_hidden_layers) == (64, 2)
    for k, v in sd.items():
        if name.endswith("f32.bin") or v.ndim == 1:
            np.testing.assert_array_equal(v, st[k], err_msg=k)
        else:  # 2-D .weight tensors stored f16
            np.testing.assert_array_equal(
                v, st[k].astype(np.float16).astype(np.float32), err_msg=k)


# ---------------------------------------------------------------------------
# (c) load parity
# ---------------------------------------------------------------------------

def _jax_kernels(eng, texts=TEXTS):
    """A JAX Engine's encode through its Pallas kernels in interpret
    mode (the Engine was built with use_pallas="always")."""
    jattn = importlib.import_module("embeddings_tpu.ops.attention")
    orig = jattn.fused_attention
    jattn.fused_attention = functools.partial(orig, interpret=True)
    try:
        with jlin.interpret_mode(True):
            return eng.encode_batch(texts)
    finally:
        jattn.fused_attention = orig


@pytest.mark.parametrize("fmt,file_dtype,load_dtype", [
    ("bin", "f32", "f32"), ("bin", "q4_0", "f32"), ("bin", "q4_0", "q4_0"),
    ("bin", "q4_1", "q4_1"), ("gguf", "f16", "f32"),
    ("gguf", "q4_0", "f32"), ("gguf", "q4_0", "q4_0"),
    ("gguf", "q8_0", "f32"), ("gguf", "q4_K", "q4_0"),
    ("gguf", "q6_K", "q8_0")])
def test_load_model_matches_jax(tmp_path, trees, small_vocab, fmt,
                                file_dtype, load_dtype):
    which = "kquant" if file_dtype.endswith("_K") else "small"
    jcfg, jp, _, _ = trees[which]
    path = tmp_path / f"m.{fmt}"
    (JG.write_ggml if fmt == "bin" else JF.write_gguf)(
        path, jp, jcfg, small_vocab, dtype=file_dtype)
    te = load_model(path, dtype=load_dtype, device="cpu")
    je = jax_load(path, dtype=load_dtype,
                  engine_config=JaxEngineConfig(use_pallas="always"))
    for t in TEXTS:
        assert te.tokenize(t) == je.tokenize(t)
    got, ref = te.encode_batch(TEXTS), _jax_kernels(je)
    quant = file_dtype not in ("f32", "f16") or load_dtype != "f32"
    assert np.abs(got - ref).max() <= (2e-3 if quant else 1e-5)
    np.testing.assert_array_equal(got[0], got[3])
    up = te.params["layers"]["mlp"]["up"]["w"]
    if file_dtype in ("q4_0", "q4_1", "q8_0"):
        # a quantized file keeps its kind; packed only for a q4 dtype
        assert isinstance(up, QuantizedTensor) and up.kind == file_dtype
        assert up.packed == (load_dtype in TQ.PACK4_KINDS)
        assert te.params["embeddings"]["word"].block_axis == -1
    elif load_dtype != "f32":
        assert isinstance(up, QuantizedTensor) and up.kind == load_dtype


# ---------------------------------------------------------------------------
# (d) other archs, tokenizers, malformed files
# ---------------------------------------------------------------------------

def _arch_file(tmp_path, arch, small_vocab):
    """A nomic-bert (fused qkv, q4_0 gate) or jina-bert-v2 (ALiBi, gated,
    biasless gate/up) GGUF, as the JAX package's own tests write them."""
    w = _arch_weights(0 if arch == "nomic-bert" else 2)
    V, E, I, NL = 64, 64, 96, 2
    t = {"token_embd.weight": w(V, E), "token_types.weight": w(2, E),
         "token_embd_norm.weight": 1.0 + 0.1 * w(E),
         "token_embd_norm.bias": 0.1 * w(E)}
    for i in range(NL):
        b = f"blk.{i}."
        if arch == "nomic-bert":
            t[b + "attn_qkv.weight"] = w(3 * E, E)
            t[b + "attn_qkv.bias"] = 0.1 * w(3 * E)
        else:
            for nm in ("attn_q", "attn_k", "attn_v"):
                t[b + nm + ".weight"] = w(E, E)
                t[b + nm + ".bias"] = 0.1 * w(E)
            t[b + "ffn_down.bias"] = 0.1 * w(E)
        t[b + "attn_output.weight"] = w(E, E)
        t[b + "attn_output.bias"] = 0.1 * w(E)
        for nm in ("attn_output_norm", "layer_output_norm"):
            t[b + nm + ".weight"] = 1.0 + 0.1 * w(E)
            t[b + nm + ".bias"] = 0.1 * w(E)
        t[b + "ffn_gate.weight"] = w(I, E)
        t[b + "ffn_up.weight"] = w(I, E)
        t[b + "ffn_down.weight"] = w(E, I)
    tensors = [(k, v, JF.GGML_Q4_0 if ".ffn_gate.weight" in k
                and arch == "nomic-bert" else JF.GGML_F32)
               for k, v in t.items()]
    hp = dict(embedding_length=E, block_count=NL, feed_forward_length=I,
              context_length=128, vocab_size=V,
              **{"attention.head_count": 4,
                 "attention.layer_norm_epsilon": 1e-12})
    hp.update({"rope.freq_base": 1000.0} if arch == "nomic-bert"
              else {"pooling_type": 1})
    path = tmp_path / f"{arch}.gguf"
    _write_raw_gguf(path, arch, hp, tensors, small_vocab[:V])
    return path


@pytest.mark.parametrize("arch", ["nomic-bert", "jina-bert-v2"])
def test_arch_gguf_matches_jax(tmp_path, small_vocab, arch):
    path = _arch_file(tmp_path, arch, small_vocab)
    te = load_model(path, device="cpu")
    je = jax_load(path, engine_config=JaxEngineConfig(use_pallas="always"))
    assert te.config.to_dict() == je.config.to_dict()
    assert te.config.position_embedding_type == (
        "rotary" if arch == "nomic-bert" else "alibi")
    assert te.config.gated_mlp
    if arch == "nomic-bert":
        assert isinstance(te.params["layers"]["mlp"]["gate"]["w"],
                          QuantizedTensor)
    got, ref = te.encode_batch(TEXTS), _jax_kernels(je)
    assert np.abs(got - ref).max() <= (2e-3 if arch == "nomic-bert"
                                       else 1e-5)


def test_moe_gguf_reads_then_refused(tmp_path):
    rng = np.random.default_rng(0)
    sd = _moe_state_dict(rng, MOE_HF_DICT)
    tokens = [f"tok{j}" for j in range(MOE_HF_DICT["vocab_size"])]
    path = tmp_path / "moe.gguf"
    _write_moe_gguf(path, sd, MOE_HF_DICT, tokens)
    got, cfg, _ = TF.read_gguf(path)
    ref, rcfg, _ = JF.read_gguf(path)
    assert cfg.to_dict() == rcfg.to_dict() and cfg.num_experts == 4
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    params, tcfg, _ = TF.load_gguf_model(path)
    jparams, _, _ = JF.load_gguf_model(path)
    assert set(params["layers"]) == {"dense", "moe"}
    ids = np.random.default_rng(1).integers(5, 96, (2, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    got = tbert.encode_tokens(params, tcfg, torch.from_numpy(ids),
                              torch.from_numpy(mask)).numpy()
    ref = np.asarray(jbert.encode_tokens(jparams, rcfg, ids, mask))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    eng = load_model(path, dtype="q4_0", device="cpu")
    assert eng.config.num_experts == 4
    # the export formats have no form for an MoE tree
    with pytest.raises(ValueError, match="mixture-of-experts"):
        TF.write_gguf(tmp_path / "back.gguf", params, tcfg, tokens)
    with pytest.raises(ValueError, match="mixture-of-experts"):
        TG.write_ggml(tmp_path / "back.bin", params, tcfg, tokens)


def _charsmap_meta():
    from .test_charsmap import build_charsmap
    return {"tokenizer.ggml.model": "t5",
            "tokenizer.ggml.tokens": ["<s>", "<pad>", "</s>", "<unk>",
                                      "▁fi", "ne", "▁x", "▁hello", "▁wor",
                                      "ld", "▁"],
            "tokenizer.ggml.scores": [0.0, 0.0, 0.0, 0.0, -1.0, -1.5, -2.0,
                                      -2.0, -3.0, -3.1, -1.0],
            "tokenizer.ggml.unknown_token_id": 3,
            "tokenizer.ggml.precompiled_charsmap": list(
                build_charsmap({"ﬁ": "fi"}))}


def _gpt2_meta(pre):
    alphabet = [chr(c) for c in range(33, 127)] + ["Ġ"]
    vocab = ["<s>", "<pad>", "</s>", "<unk>"] + alphabet + [
        "he", "ll", "llo", "hello", "Ġw", "Ġwo", "Ġworld"]
    return {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.tokens": vocab,
            "tokenizer.ggml.merges": ["h e", "l l", "ll o", "he llo",
                                      "Ġ w", "Ġw o"],
            "tokenizer.ggml.pre": pre}


@pytest.mark.parametrize("model", ["bert", "t5", "gpt2", "qwen2"])
def test_tokenizer_from_gguf_matches_jax(small_vocab, model):
    meta = {"bert": {"tokenizer.ggml.model": "bert",
                     "tokenizer.ggml.tokens": list(small_vocab)},
            "t5": _charsmap_meta(), "gpt2": _gpt2_meta("gpt-2"),
            "qwen2": _gpt2_meta("qwen2")}[model]
    tok, jtok = TF._tokenizer_from_gguf(meta), JF._tokenizer_from_gguf(meta)
    assert type(tok).__name__ == type(jtok).__name__
    for text in ("hello world", "ﬁne x", "Hello  WORLD's 123", "", "你好"):
        assert tok.encode(text) == jtok.encode(text), text
        assert tok.encode_pair(text, "world") == jtok.encode_pair(
            text, "world"), text


def _malformed(tmp_path, small_vocab, trees, case):
    """(reader name, file) for one malformed-input case."""
    jcfg, jp, _, _ = trees["small"]
    fmt = "bin" if case.startswith("bin") else "gguf"
    good = tmp_path / f"good.{fmt}"
    (JG.write_ggml if fmt == "bin" else JF.write_gguf)(
        good, jp, jcfg, small_vocab, dtype="q4_0")
    blob = good.read_bytes()
    p = tmp_path / f"{case}.{fmt}"
    if case == "bin_magic":
        data = b"XXXX" + blob[4:]
    elif case.startswith("bin_trunc") or case.startswith("gguf_trunc"):
        data = blob[:int(case.rsplit("_", 1)[1])]
    elif case == "bin_ftype":
        off = 8 + 24 + sum(4 + len(t.encode()) for t in small_vocab)
        data = bytearray(blob)
        data[off + 8:off + 12] = struct.pack("<i", 99)
        data = bytes(data)
    elif case == "gguf_magic":
        data = b"NOPE" + blob[4:]
    elif case == "gguf_version":
        data = blob[:4] + struct.pack("<I", 99) + blob[8:]
    elif case in ("gguf_q2k", "gguf_ktrunc"):
        with open(p, "wb") as f:
            f.write(struct.pack("<IIQQ", JF.MAGIC, 3, 1, 1))
            JF._w_str(f, "general.architecture")
            f.write(struct.pack("<I", JF.T_STRING))
            JF._w_str(f, "bert")
            JF._w_str(f, "token_embd.weight")
            f.write(struct.pack("<I", 2))
            if case == "gguf_q2k":
                f.write(struct.pack("<QQ", 64, 64))
                f.write(struct.pack("<IQ", 10, 0))  # Q2_K: not read
            else:
                f.write(struct.pack("<QQ", 256, 4))
                f.write(struct.pack("<IQ", 12, 0))  # Q4_K, data missing
            f.write(b"\x00" * 64)
        return p
    else:  # a foreign arch, or a supported one without its hparams
        arch = {"gguf_arch": "llama", "gguf_hparams": "nomic-bert"}[case]
        with open(p, "wb") as f:
            f.write(struct.pack("<IIQQ", JF.MAGIC, 3, 0, 1))
            JF._w_str(f, "general.architecture")
            f.write(struct.pack("<I", JF.T_STRING))
            JF._w_str(f, arch)
        return p
    p.write_bytes(data)
    return p


@pytest.mark.parametrize("case", [
    "bin_magic", "bin_trunc_6", "bin_trunc_20", "bin_trunc_120",
    "bin_trunc_3000", "bin_ftype", "gguf_magic", "gguf_version",
    "gguf_trunc_10", "gguf_trunc_30", "gguf_trunc_200", "gguf_trunc_3000",
    "gguf_q2k", "gguf_ktrunc", "gguf_arch", "gguf_hparams"])
def test_malformed_files_raise_jax_errors(tmp_path, small_vocab, trees,
                                          case):
    p = _malformed(tmp_path, small_vocab, trees, case)
    port, jax_ = ((TG.read_ggml, JG.read_ggml) if case.startswith("bin")
                  else (TF.read_gguf, JF.read_gguf))
    errors = []
    for read in (jax_, port):
        with pytest.raises(Exception) as exc:
            read(p)
        errors.append(exc.value)
    assert type(errors[1]) is type(errors[0]), errors
    assert str(errors[1]) == str(errors[0])
    assert isinstance(errors[1], (ValueError, EOFError, struct.error,
                                  KeyError, UnicodeDecodeError, OSError))
