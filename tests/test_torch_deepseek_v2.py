"""DeepSeek-V2 on the port (MLA, YaRN, leading dense layer, MoE of gated
experts with a shared expert), against the benchmark's plain float32
reference ``perfbench/reference/deepseek_v2.py`` on seeded random
weights at a tiny size, on the CPU.

Tolerances, each with its reason:
- f32 (``use_pallas="never"``: the q4_0 weights dequantized as the
  reference's codec does, f32 products, the einsum attention): the port
  computes the reference's operations in
  another order at most, so outputs agree to f32 rounding (relative
  1e-5 on a layer's output, cosine gap 1e-9 end to end; the bf16 run
  below is 1e-6 or more away, so it fails these).
- bf16 (activations in bf16, the kernels' plain versions): one bf16
  rounding (2^-9 relative) a stored activation, over three layers (2e-5
  read); cosine gap 1e-4 end to end, which a reference on other weights
  is far outside.
- q4_0 weights with f32 activations (``load_model``): both sides round
  the same weights, K1's plain version rounds its inputs to bf16; cosine
  gap 1e-4.
"""

import json
import math

import numpy as np
import pytest
import torch

from embeddings_tpu_torch import BertConfig, EngineConfig, load_model
from embeddings_tpu_torch.models import bert
from embeddings_tpu_torch.models import params as P
from embeddings_tpu_torch.ops import attention as A
from embeddings_tpu_torch.ops import rotary
from embeddings_tpu_torch.ops.moe import moe_ffn_ragged
from embeddings_tpu_torch.runtime.engine import Engine
from perfbench import compare, weights
from perfbench.reference import deepseek_v2 as ref

BOS, EOS = 100000, 100001
HF = {"attention_bias": False, "first_k_dense_replace": 1,
      "hidden_act": "silu", "hidden_size": 64, "intermediate_size": 96,
      "kv_lora_rank": 32, "max_position_embeddings": 4096,
      "model_type": "deepseek_v2", "moe_intermediate_size": 32,
      "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 8,
      "n_shared_experts": 1, "norm_topk_prob": False,
      "num_attention_heads": 4, "num_experts_per_tok": 3,
      "num_hidden_layers": 3, "num_key_value_heads": 4,
      "q_lora_rank": None, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
      "rms_norm_eps": 1e-06,
      "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                       "mscale": 0.707, "mscale_all_dim": 0.707,
                       "original_max_position_embeddings": 4096,
                       "type": "yarn"},
      "rope_theta": 10000, "routed_scaling_factor": 1,
      "scoring_func": "softmax", "topk_group": 1, "topk_method": "greedy",
      "v_head_dim": 16, "vocab_size": 100002}
HEAD = {"pooling": "lasttoken", "normalize": True}
CPU = torch.device("cpu")
LENGTHS = (3, 9, 30, 61, 126, 200)


class Ids:
    """The special ids the Engine reads from a tokenizer."""
    cls_id, sep_id, pad_id, unk_id = BOS, EOS, EOS, EOS


def _hf(**kw):
    return {**HF, **kw}


def _sd(hf, seed=42):
    return weights.make(ref.checkpoint_spec(hf), seed, CPU)


def _seqs(lengths=LENGTHS, seed=1):
    rng = np.random.default_rng(seed)
    return [[BOS, *rng.integers(0, BOS, n).tolist(), EOS] for n in lengths]


def _engine(hf, sd, dtype="q4_0", **ec):
    cfg = BertConfig.from_hf_dict(hf)
    tree = P.from_hf_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)
    if dtype != "f32":
        tree = P.pack_q4_params(P.quantize_params(tree, dtype))
    cfg = BertConfig.from_hf_dict(hf, pad_token_id=EOS)
    return Engine(tree, cfg, Ids(), EngineConfig(
        batch_size=4, max_seq_len=256, **ec), device="cpu")


def _gap(got, want):
    return compare.numbers(np.asarray(got), np.asarray(want))


def _layer_input(seed=3, B=2, L=40):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, L, HF["hidden_size"], generator=g)


# -- the pieces -------------------------------------------------------------

def _check_mapping():
    cfg = BertConfig.from_hf_dict(HF)
    assert (cfg.norm_style, cfg.norm_type, cfg.causal, cfg.pooling) == \
        ("pre", "rmsnorm", True, "lasttoken")
    assert (cfg.num_experts, cfg.moe_top_k, cfg.moe_every_n_layers,
            cfg.first_k_dense_replace, cfg.expert_width,
            cfg.n_shared_experts) == (8, 3, 1, 1, 32, 1)
    assert (cfg.qk_head_dim, cfg.v_head_dim, cfg.kv_lora_rank) == (24, 16,
                                                                   32)
    assert dict(cfg.rope_scaling)["factor"] == 40
    assert (cfg.cls_token_id, cfg.sep_token_id, cfg.pad_token_id) == \
        (BOS, EOS, EOS)
    # the port's own fields round-trip through to_dict; other configs
    # keep the JAX package's keys
    assert BertConfig(**cfg.to_dict()) == cfg
    assert "kv_lora_rank" not in BertConfig().to_dict()
    for bad in ({"q_lora_rank": 1536}, {"topk_method":
                                        "group_limited_greedy"},
                {"moe_layer_freq": 2}, {"scoring_func": "sigmoid"}):
        with pytest.raises(ValueError):
            BertConfig.from_hf_dict(_hf(**bad))
    sd = _sd(HF)
    tree = P.from_hf_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)
    dense, moe = tree["layers"]["dense"], tree["layers"]["moe"]
    a = moe["attn"]
    assert a["q"]["w"].shape == (2, 64, 4 * 24)
    assert a["kv_a"]["w"].shape == (2, 64, 32 + 8)
    assert a["kv_b"]["w"].shape == (2, 32, 4 * (16 + 16))
    assert a["o"]["w"].shape == (2, 4 * 16, 64)
    assert a["latent"]["ln"]["scale"].shape == (2, 32)
    assert dense["mlp"]["gate"]["w"].shape == (1, 64, 96)
    m = moe["mlp"]
    assert m["router"]["w"].shape == (2, 64, 8)
    assert m["gate"]["w"].shape == m["up"]["w"].shape == (2, 8, 64, 32)
    assert m["down"]["w"].shape == (2, 8, 32, 64)
    assert "b" not in m["up"] and "b" not in m["down"]
    assert m["shared"]["down"]["w"].shape == (2, 32, 64)
    # HF [out, in] -> the tree's [in, out]; experts one by one
    w = sd["model.layers.2.mlp.experts.5.up_proj.weight"]
    assert torch.equal(m["up"]["w"][1, 5], w.T)
    assert torch.equal(a["q"]["w"][0],
                       sd["model.layers.1.self_attn.q_proj.weight"].T)
    # the layout: layer 0 dense, layers 1, 2 the MoE stack
    lays = bert.layer_views(tree, cfg)
    assert "router" not in lays[0]["mlp"] and "router" in lays[2]["mlp"]
    assert torch.equal(lays[2]["attn"]["q"]["w"], a["q"]["w"][1])
    # quantized: projections, dense and shared SwiGLUs, the word table;
    # not the router, the routed experts or the norms
    q = P.quantize_params(tree, "q4_0")
    qm = q["layers"]["moe"]["mlp"]
    from embeddings_tpu_torch.ops.quant import QuantizedTensor
    assert isinstance(q["layers"]["moe"]["attn"]["kv_b"]["w"],
                      QuantizedTensor)
    assert isinstance(qm["shared"]["gate"]["w"], QuantizedTensor)
    assert not isinstance(qm["up"]["w"], QuantizedTensor)
    assert qm["router"]["w"].dtype == torch.float32
    assert "qkv" not in P.fuse_qkv(q)["layers"]["moe"]["attn"]


def _check_yarn():
    """YaRN's frequencies against the closed form at DeepSeek-V2-Lite's
    rotated width: corr(32) = 10.47 and corr(1) = 22.50, so pairs 0-10
    keep base^(-2i/64), pairs 23-31 take it over 40, and the ones
    between mix linearly; the tables against the reference's."""
    sc = dict(BertConfig.from_hf_dict(HF).rope_scaling)
    inv = rotary.yarn_inv_freq(64, 10000.0, sc)
    i = torch.arange(32, dtype=torch.float64)
    extra = 10000.0 ** (-2 * i / 64)

    def corr(r):
        return 64 * math.log(4096 / (2 * math.pi * r)) / (2 * math.log(1e4))
    assert (math.floor(corr(32)), math.ceil(corr(1))) == (10, 23)
    ramp = ((i - 10) / 13).clamp(0, 1)
    want = extra / 40 * ramp + extra * (1 - ramp)
    assert torch.allclose(inv, want, rtol=1e-15, atol=0)
    assert torch.allclose(inv[:11], extra[:11], rtol=1e-15)
    assert torch.allclose(inv[23:], extra[23:] / 40, rtol=1e-15)
    assert rotary.yarn_mscale(40, 0.707) == pytest.approx(1.26081, abs=1e-5)
    hf = _hf(qk_rope_head_dim=64)
    cfg = BertConfig.from_hf_dict(hf)
    cos, sin = bert.mla_rope(cfg, torch.arange(300))
    rcos, rsin = ref.yarn_cos_sin(hf, 300, CPU)
    # both in f64, base^(-2i/d) taken in another order (1 f64 ulp apart),
    # rounded once to f32: at most one f32 ulp apart
    for got, want in ((cos, rcos), (sin, rsin)):
        torch.testing.assert_close(got, want, rtol=0, atol=2 ** -23)
    assert bert.mla_softmax_scale(cfg) == pytest.approx(
        ref.softmax_scale(hf), rel=1e-15)
    # DeepSeek-V2-Lite's 192^-0.5 * mscale(40, 0.707)^2 = 0.1147
    full = BertConfig.from_hf_dict(_hf(qk_nope_head_dim=128,
                                       qk_rope_head_dim=64))
    assert bert.mla_softmax_scale(full) == pytest.approx(0.11472, abs=1e-5)


def _check_mla():
    """One MLA half (o-projection included) in f32 against the
    reference's, causal, a pad at the end of the second row."""
    hf, cfg = HF, BertConfig.from_hf_dict(HF)
    sd = _sd(hf)
    tree = P.from_hf_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)
    lay = bert.layer_views(tree, cfg)[1]
    x = _layer_input()
    B, L, _ = x.shape
    ok = torch.ones(B, L, dtype=torch.bool)
    ok[1, 33:] = False
    mask = ((1.0 - ok.float()) * -1e9)[:, None, None, :] \
        + bert._causal_bias(L, -1e9, CPU)
    rope = bert.mla_rope(cfg, torch.arange(L))
    ctx = bert.mla_context(lay, cfg, x, mask, None, rope, use_kernels=False)
    got = bert.linear(ctx, lay["attn"]["o"]["w"], lay["attn"]["o"]["b"],
                      use_kernels=False)
    cos, sin = ref.yarn_cos_sin(hf, L, CPU)
    w = {k: v.float() for k, v in sd.items()}
    want = ref.mla(x, ok, w, "model.layers.1.", hf, cos, sin)
    real = ok[..., None].expand_as(got)
    torch.testing.assert_close(got[real], want[real], rtol=1e-5, atol=1e-6)


def _check_moe(shared: bool):
    """One MoE FFN (routed experts, and the shared expert) in f32 against
    the reference's."""
    hf = _hf(n_shared_experts=1 if shared else 0)
    cfg = BertConfig.from_hf_dict(hf)
    sd = _sd(hf)
    tree = P.from_hf_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)
    m = bert.layer_views(tree, cfg)[2]["mlp"]
    assert ("shared" in m) == shared
    x = _layer_input(seed=5).reshape(-1, hf["hidden_size"])
    n0 = moe_ffn_ragged.expert_gemms
    got = moe_ffn_ragged(x, m, top_k=3, act="silu", use_kernels=False)
    assert (moe_ffn_ragged.expert_gemms - n0) % 3 == 0
    w = {k: v.float() for k, v in sd.items()}
    want = ref.moe(x, w, "model.layers.2.", hf)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _check_moe_grouped():
    """The routed experts held in bf16 (the Engine's holding): each of
    the three products is one grouped product (three launches, no host
    read), each expert's rows as that expert's own product gives them,
    and the MoE within bf16 rounding of the f32 per-expert loop's on the
    same (bf16-representable) rows, so the routing is the same. Stacks
    in another dtype than the rows are refused, not cast."""
    from embeddings_tpu_torch.ops.moe import _grouped
    g = torch.Generator().manual_seed(7)
    counts = torch.tensor([5, 0, 1, 17, 0, 9, 3, 29])
    a = torch.randn(int(counts.sum()), 64, generator=g).bfloat16()
    w = torch.randn(8, 64, 32, generator=g).bfloat16()
    reads, gemms = moe_ffn_ragged.host_reads, moe_ffn_ragged.expert_gemms
    got = _grouped(counts, torch.bfloat16)(a, w)
    assert (moe_ffn_ragged.host_reads, moe_ffn_ragged.expert_gemms) == \
        (reads, gemms + 1)
    want = torch.cat([p.float() @ w[e].float()
                      for e, p in enumerate(a.split(counts.tolist()))])
    # f32 sums of the same products, each rounded to bf16 once: one bf16
    # step (2^-8 to 2^-7 of the value) apart at most
    torch.testing.assert_close(got.float(), want, rtol=2 ** -7, atol=1e-6)

    hf, cfg = HF, BertConfig.from_hf_dict(HF)
    tree = P.from_hf_state_dict(
        {k: v.numpy() for k, v in _sd(hf).items()}, cfg)
    x = _layer_input(seed=5).reshape(-1, hf["hidden_size"]).bfloat16()
    kw = dict(top_k=3, act="silu", use_kernels=False)
    m32 = bert.layer_views(tree, cfg)[2]["mlp"]
    with pytest.raises(TypeError):
        moe_ffn_ragged(x, m32, **kw)
    plain = moe_ffn_ragged(x.float(), m32, **kw)
    m16 = bert.layer_views(P.hold_gated_experts(tree, torch.bfloat16),
                           cfg)[2]["mlp"]
    reads, gemms = moe_ffn_ragged.host_reads, moe_ffn_ragged.expert_gemms
    got = moe_ffn_ragged(x, m16, **kw)
    assert (moe_ffn_ragged.host_reads, moe_ffn_ragged.expert_gemms) == \
        (reads, gemms + 3)
    # six bf16 roundings on the way (the three stacks, gate and up, their
    # product, the expert outputs, the output), each 2^-9 of its terms,
    # which cancel in part: 2^-6 of |out| + rms(out) each element; the f32
    # tolerance above (1e-5) fails
    err = (got.float() - plain).abs()
    rms = plain.square().mean().sqrt()
    assert (err <= 2 ** -6 * (plain.abs() + rms)).all()
    assert err.max() > 1e-5 * rms


def _check_encode_f32():
    sd, seqs = _sd(HF), _seqs()
    got = _engine(HF, sd, use_pallas="never").encode_toks(seqs)
    want = ref.encode(sd, HF, HEAD, seqs, CPU).numpy()
    assert _gap(got, want)["cos_gap_max"] < 1e-9


def _check_encode_bf16():
    sd, seqs = _sd(HF), _seqs()
    eng = _engine(HF, sd, compute_dtype="bfloat16")
    # the routed experts held in the compute dtype, the router in f32
    m = eng.params["layers"]["moe"]["mlp"]
    assert m["up"]["w"].dtype == torch.bfloat16
    assert m["router"]["w"].dtype == torch.float32
    got = eng.encode_toks(seqs)
    want = ref.encode(sd, HF, HEAD, seqs, CPU).numpy()
    gap = _gap(got, want)
    # bf16 rounding shows (the f32 tolerance fails), within its own
    assert 1e-9 < gap["cos_gap_max"] < 1e-4
    other = ref.encode(_sd(HF, 43), HF, HEAD, seqs, CPU).numpy()
    assert _gap(got, other)["cos_gap_mean"] > 1e-2


def _check_load_model(tmp_path):
    """``load_model`` on an HF-layout directory (config.json and
    model.safetensors under DeepseekV2ForCausalLM's names, an LM head
    included) embeds through the pre-norm stack."""
    from safetensors.numpy import save_file
    sd = _sd(HF)
    arrays = {k: v.numpy() for k, v in sd.items()}
    arrays["lm_head.weight"] = np.zeros((HF["vocab_size"], 64), np.float32)
    save_file(arrays, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(
        {**HF, "bos_token_id": BOS, "eos_token_id": EOS}))
    eng = load_model(tmp_path, dtype="q4_0", device="cpu", tokenizer=Ids())
    assert eng.config.mla and eng.config.pooling == "lasttoken"
    seqs = _seqs((5, 40, 130))
    got = eng.encode_toks(seqs)
    want = ref.encode(sd, HF, HEAD, seqs, CPU).numpy()
    assert _gap(got, want)["cos_gap_max"] < 1e-4


def _check_routes(monkeypatch):
    """The einsum path on the CPU at the tiny widths, which no kernel is
    built for; where ``fused_attention_ok`` takes the shape (the tiny
    widths registered as a kernel's, L % 128 == 0) the kernel's plain
    version, and the same embeddings within the bf16 tolerance."""
    cfg = BertConfig.from_hf_dict(HF)
    lens = torch.ones(2)
    ok = [bert.fused_attention_ok(L, 4, 24, True, lens, None, causal=True,
                                  dv=16) for L in (64, 128)]
    assert ok == [False, False]
    assert bert.attention_route_name(256, 64, causal=True, mla=True) == \
        "stream_causal_mla"
    assert bert.fused_attention_ok(2048, 16, 192, True, lens, None,
                                   causal=True, dv=128)
    assert not bert.fused_attention_ok(2048, 16, 192, True, lens, None,
                                       causal=False, dv=128)
    assert not bert.fused_attention_ok(2000, 16, 192, True, lens, None,
                                       causal=True, dv=128)
    sd, seqs = _sd(HF), _seqs((20, 100, 120))
    eng = _engine(HF, sd)
    before = eng.encode_toks(seqs)
    calls = []
    plain = A.fused_attention_stream_ref

    def counted(*a, **kw):
        calls.append((kw["L"], kw["dv"]))
        return plain(*a, **kw)
    monkeypatch.setattr(A, "MLA_HEAD_DIMS", A.MLA_HEAD_DIMS + ((24, 16),))
    monkeypatch.setattr(A, "fused_attention_stream_ref", counted)
    assert bert.fused_attention_ok(128, 4, 24, True, lens, None,
                                   causal=True, dv=16)
    after = eng.encode_toks(seqs)
    assert calls == [(128, 16)] * cfg.num_hidden_layers
    want = ref.encode(sd, HF, HEAD, seqs, CPU).numpy()
    assert _gap(after, want)["cos_gap_max"] < 1e-4
    assert _gap(after, before)["cos_gap_max"] < 1e-4


PIECES = {"mapping": _check_mapping, "yarn": _check_yarn,
          "mla": _check_mla, "moe_routed": lambda: _check_moe(False),
          "moe_shared": lambda: _check_moe(True),
          "moe_grouped": _check_moe_grouped,
          "encode_f32": _check_encode_f32, "encode_bf16": _check_encode_bf16}


@pytest.mark.parametrize("piece", list(PIECES))
def test_deepseek_v2_piece(piece):
    PIECES[piece]()


def test_deepseek_v2_load_model(tmp_path):
    _check_load_model(tmp_path)


def test_deepseek_v2_routes(monkeypatch):
    _check_routes(monkeypatch)


def test_mla_refuses_what_no_kernel_takes():
    qkv = torch.zeros(2 * 128, 4 * (2 * 24 + 16))
    lens = torch.tensor([128, 3], dtype=torch.int32)
    with pytest.raises(ValueError):
        A.fused_attention_stream(qkv, lens, B=2, L=128, H=4, D=24, BK=128,
                                 causal=True, dv=16)
    with pytest.raises(ValueError):
        A.attention_kernel(A.MODE_STREAM, 192, dv=128)
    assert A.attention_kernel(A.MODE_CAUSAL, 192, dv=128) == "sm90"
