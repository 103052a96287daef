"""Smoke test of the PyTorch/CUDA port on one GPU: builds the hand-written
kernels (K1-K7, K6w, K6c and K6ca, the chained-int8 modes K1e, K3e, K3x,
K2e, K4e and K2i8, and the context-parallel K8a and K8b; K1 and K3 on the
wgmma matmul kernel, every attention kernel on the Hopper attention
library), holds each against its plain PyTorch version on the card,
checks each
profiled forward's matmul and attention launches by kernel, and drives
the port's paths through Engine -> encode_batch (or encode_batch_packed)
-> BatchingService -> TCP, checking each path's kernel launch counts:

- bge-base q4_0: the bf16 encode path (K1 + K2), the int8 compute mode
  (K3 + K2, the int8 weights requantized once when the Engine is built),
  the chained int8 path under each of the 8 link subsets with
  int8 scores off and on (K3 with K3x / K3e, K2 with K2e / K2i8, packed
  K4e), and token-packed serving (K1 + K4 or K5);
- a bge-base-shaped BERT with 2,048 positions on rows past the whole-row
  rule (K1 + K6 plain);
- all-mpnet-base-v2 q4_0 (K1 + K7 with the relative-position bias);
- jina-embeddings-v2-base-en q4_0 (GeGLU: 5 K1 a layer; K6 with in-kernel
  ALiBi at L=8192, K7 with the ALiBi bias at L=1024), and the trained
  tiny ALiBi fixture; its weights in a causal config (K6ca: causal
  attention with in-kernel ALiBi at L=8192);
- gte-modernbert-base q4_0 (pre-norm, RoPE, GeGLU, 22 layers: 8 global
  on K2 at L=1024 or K6 plain at L=8192, 14 local on the banded K6w,
  mode 6 of the Hopper attention kernel);
- gte-Qwen2-1.5B-instruct q4_0 (RMSNorm, grouped-query attention, SwiGLU,
  28 layers, last-token pooling; one weight tree for both forms): causal
  on K6c at L=512 and L=4096, bidirectional (as published) on K2 at L=512
  and K6 plain at L=4096, 7 K1 a layer;
- context parallelism on a (data, seq) mesh that names the one card once
  per shard: bge-base on a 2 x 2 mesh (K1 + K8a, local queries against
  the gathered K/V) and nomic-embed-text-v1 on a 1 x 4 mesh (RoPE,
  SwiGLU: K1 + K8b), against the single-device Engine and the plain f32
  CP forward;
- the encoder families on K1 and K2 alone, each from its published
  config with HF-named random weights through ``from_hf_state_dict``:
  distilbert-base-uncased and all-distilroberta-v1 (6 layers; RoBERTa
  also token-packed on K4), roformer_chinese_base (interleaved RoPE, also
  at L=1,536) and albert-base-v2 (its 128-wide embeddings projected, one
  layer applied 12 times; also int8 on K3 and CP on K8a);
- the checkpoint formats on K1 and K2: bge-base written by the port's
  ``write_ggml`` (q4_0, q4_1) and ``write_gguf`` (q4_0, q8_0, f16, q4_K)
  and read back by ``load_model``, each quantized file's weights reaching
  K1 as they were read (int8 codes, or packed for a q4 dtype), dense and
  K-quant files quantized to q4_0 on load; the reference's own
  ggml-model-f32.bin against its HF directory;
- bge-reranker-base (XLM-R, vocab 250,002) q4_0 through
  ``Engine.rerank`` on 128 STS documents (K1 + K2, then the head's two
  f32 products on the CLS rows) against the plain f32 path;
- nomic-embed-text-v2-moe (12 layers, an MoE FFN of 8 experts routed
  top-2 at the 6 odd ones) q4_0 from HF-named weights through
  ``from_hf_state_dict``: 36 K1 + 12 K2 (K6 at L=2,048, K4 packed; the
  int8 mode 36 K3) a forward, the experts' products torch's, against the
  plain f32 path, dense dispatch, bucketed rows and the trained
  ``tiny_trained_moe`` on the CPU;

- two processes on torch.distributed sharing the card (gloo, the CUDA
  tensors staged through host memory): bge-base's distributed encode
  (K1 + K2 in each process), a global (data=2, model=2) mesh with data
  across the processes, and a model axis and a seq axis (K8a) across
  them, against the single-device Engine;
- four cards of one host (only where four are visible; one "not run"
  line each otherwise): one process driving them (each card's kernels
  while cuda:0 is current, an Engine on cuda:3, DP, TP, int8 TP and CP
  meshes over ``devices=None`` with each card's kernels counted), and
  four processes, one card each, over NCCL (the distributed encode and
  meshes whose axes cross them, under torchrun's and JAX's variables);

then times the kernels and the forwards, with a device-time profile of
each forward by kernel; then the serving surface: the port's native
tokenizer against the Python one, bge-base (and the reranker) behind
the TCP (v1, v2) and HTTP front-ends on every route, 2,000 sentences
from 64 connections (requests/s, latency percentiles, the device's busy
share), and the CLI in subprocesses (convert, quantize, encode,
tokenize, bench).

    python3 chip_smoke.py              # every phase, needs one CUDA device
    python3 chip_smoke.py --phases device,build,k1,k2,k3,k4k5,k6k7,k6w,k6c,\
        k6ca,emit,attn_emit,k8
    python3 chip_smoke.py --phases device,build,k1      # K1 alone
    python3 chip_smoke.py --phases device,build,k2,k6k7,k6c,k6ca  # attention
    python3 chip_smoke.py --phases device,build,k8,cp_path
    python3 chip_smoke.py --phases device,build,k6w,modernbert_path,timing
    python3 chip_smoke.py --phases device,build,distilbert_path,\
        roberta_path,roformer_path,albert_path,timing
    python3 chip_smoke.py --phases device,build,ggml_path,gguf_path,\
        rerank_path,timing
    python3 chip_smoke.py --phases device,build,moe_path,timing
    python3 chip_smoke.py --phases device,build,mla_path,timing  # DeepSeek-V2
    python3 chip_smoke.py --phases device,build,moe_combine,timing  # combine
    python3 chip_smoke.py --phases device,build,multihost_path
    python3 chip_smoke.py --phases device,build,multicard_path,nccl_path
    python3 chip_smoke.py --phases device,build,main,timing,native_tok,\
        http_path,serve_latency,cli_path

Each phase prints one JSON line. The last two lines are the kernel table
and ``{"ok": true, "device": {...}}``; any failure exits non-zero before
them. Without a CUDA device (or without the package beside this file) the
script exits non-zero and prints no result. Long output goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "benchmarks" / "fixtures" / "tiny_trained"
ALIBI_FIXTURE = ROOT / "benchmarks" / "fixtures" / "tiny_trained_alibi"
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM data-sheet peaks (dense): bf16 and int8 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

# bge-base at the timing shape
B, L, E, H, D, F, NL = 128, 256, 768, 12, 64, 3072, 12
M = B * L
# main-path matmuls: name -> (K, N, epilogue)
K1_SHAPES = {"qkv": (E, 3 * E, "bias"),
             "o_proj": (E, E, "bias_residual_ln"),
             "ffn_up": (E, F, "bias_gelu"),
             "ffn_down": (F, E, "bias_residual_ln")}
K1_REPLACES = "embeddings_tpu/ops/qmatmul.py:153 (_qmm_kernel via qmatmul :446)"
K2_REPLACES = ("embeddings_tpu/ops/attention.py:73 (_attn_kernel via "
               "fused_attention :1039)")
# the attention library: every attention kernel of the port
ATTN90_SOURCE = "embeddings_tpu_torch/csrc/attention_sm90.cu"
K3_REPLACES = ("embeddings_tpu/ops/qmatmul.py:309 (_qmm_int8 via qmatmul "
               ":446, int8_compute)")
K4_REPLACES = ("embeddings_tpu/ops/attention.py:294 (_attn_kernel_segmented "
               "via fused_attention_segmented :490)")
K5_REPLACES = ("embeddings_tpu/ops/attention.py:337 (_attn_kernel_seg_window "
               "via fused_attention_segmented_blockskip :425)")
K6_REPLACES = ("embeddings_tpu/ops/attention.py:661 (_attn_kernel_stream "
               "via _stream_call :842, fused_attention_stream :900)")
K7_REPLACES = ("embeddings_tpu/ops/attention.py:180 (_attn_kernel_bias via "
               "fused_attention_bias :240)")
K6W_REPLACES = ("embeddings_tpu/ops/attention.py:661 (_attn_kernel_stream, "
                "span + window mode, via fused_attention_window :920)")
K6C_REPLACES = ("embeddings_tpu/ops/attention.py:661 (_attn_kernel_stream, "
                "causal mode, via fused_attention_stream(causal=True) :900)")
K6CA_REPLACES = ("embeddings_tpu/ops/attention.py:713 (_attn_kernel_stream, "
                 "causal with ALiBi, via fused_attention_stream(causal=True, "
                 "alibi_slopes=) :900)")
EMIT_REPLACES = ("embeddings_tpu/ops/qmatmul.py:262 (_emit via qmatmul :446, "
                 "emit_quantized)")
K3X_REPLACES = ("embeddings_tpu/ops/qmatmul.py:386 (_qmm_int8's sx_ref path "
                "via qmatmul :446, int8 x + x_scale)")
K2E_REPLACES = ("embeddings_tpu/ops/attention.py:61 (_emit_int8_rows from "
                "_attn_kernel :160 via fused_attention :1039, emit_quantized)")
K4E_REPLACES = ("embeddings_tpu/ops/attention.py:61 (_emit_int8_rows from "
                "_attn_kernel_segmented :330 via fused_attention_segmented "
                ":490)")
K2I8_REPLACES = ("embeddings_tpu/ops/attention.py:109 (_attn_kernel's "
                 "int8_scores branch via fused_attention :1039)")
K8A_REPLACES = ("embeddings_tpu/ops/attention.py:580 (_attn_kernel_cp via "
                "fused_attention_cp :610)")
K8B_REPLACES = ("embeddings_tpu/ops/attention.py:936 (_attn_kernel_cp_stream "
                "via fused_attention_cp_stream :985)")
# the CP kernels' checks (B, Lc, L): K8a at bge's shard shape on the 2 x 2
# mesh and at L=1,024; K8b at nomic's shard shape on the 1 x 4 mesh
# (BK=512) and at L=8,192
K8A_CASES = [(16, 256, 512), (8, 256, 1024)]
K8B_CASES = [(4, 512, 2048), (1, 2048, 8192)]
# the CP paths: bge-base at B=32, L=512 on dp=2 x sp=2 (a shard: B=16,
# Lc=256: K8a), nomic-embed-text-v1 at B=4, L=2,048 on dp=1 x sp=4 (a
# shard: B=4, Lc=512: K8b, past the whole-row rule)
CP_BGE, CP_BGE_MESH = (32, 512), (2, 2)
# data x model meshes of the card (tp_path): bge at B=32, L=512, MPNet
# at B=32, L=256, nomic-embed-text-v2-moe at B=4, L=256; a shard's
# matmuls at tp=2 and tp=4: name -> (K, N, epilogue)
TP_SHAPE, TP_MESHES = (32, 512), ((1, 2), (2, 2), (1, 4))
TP_MPNET, TP_MOE = (32, 256), (4, 256)
TP_M = TP_SHAPE[0] * TP_SHAPE[1]
TP_K1_SHAPES = {"tp2_qkv": (E, E // 2, "bias"),
                "tp2_o_proj": (E // 2, E, "none"),
                "tp2_ffn_up": (E, F // 2, "bias_gelu"),
                "tp2_ffn_down": (F // 2, E, "none"),
                "tp4_qkv": (E, E // 4, "bias"),
                "tp4_o_proj": (E // 4, E, "none")}
CP_NOMIC, CP_NOMIC_MESH = (4, 2048), (1, 4)
# the chained links' emitting calls at bge's shapes (K1e / K3e): name ->
# (K, N, epilogue, emit), and one N = 4,096 case (bge-large's FFN)
EMIT_SHAPES = {"o_proj_both": (E, E, "bias_residual_ln", "both"),
               "ffn_down_both": (F, E, "bias_residual_ln", "both"),
               "ffn_up_only": (E, F, "bias_gelu", "only"),
               "up4096_only": (1024, 4096, "bias_gelu", "only")}
# K2i8 beyond 512 tokens (K2's blocked-query route in JAX)
I8S_LONG = (16, 1024)
# the link subsets of the chained int8 path, as sorted tuples
LINK_SUBSETS = [(), ("attn",), ("ln",), ("ffn",), ("attn", "ln"),
                ("attn", "ffn"), ("ffn", "ln"), ("attn", "ffn", "ln")]
# packed shapes: K4 at the default row_len 128 (256 rows), K5 at 1024
PACK_SHORT = (256, 128)
PACK_LONG = (32, 1024)
# the logit-bias families' shapes (B, L): MPNet's timing batch, jina's
# long rows (K6 ALiBi) and short rows (K7 ALiBi), and the long-row BERT
# (K6 plain)
MPNET_SHAPE = (128, 256)
JINA_LONG = (4, 8192)
JINA_SHORT = (32, 1024)
BERT_LONG = (2, 2048)
# gte-modernbert-base: 22 layers, every 3rd global, a 128-token window on
# the others; the same two shapes as jina's (K2 or K6 on global layers)
MB_LONG, MB_SHORT, MB_WINDOW = (4, 8192), (32, 1024), 128
MB_NL, MB_GLOBAL, MB_LOCAL, MB_F = 22, 8, 14, 1152
# its matmuls beside bge's: o-proj and down with a plain bias epilogue
# (the residual adds are outside, in the pre-norm block), GeGLU gate | up
MB_K1_SHAPES = {"mb_o_proj": (E, E, "bias"),
                "mb_gate": (E, MB_F, "bias_gelu"),
                "mb_up": (E, MB_F, "bias"),
                "mb_down": (MB_F, E, "bias")}
# gte-Qwen2-1.5B-instruct: 28 layers, 12 query heads of 128, 2 K/V heads,
# SwiGLU FFN 8,960; two shapes of 16,384 token slots on both sides of the
# whole-row rule (K2 up to 896 tokens at E=1,536, K6 beyond; causal rows
# take K6c at both)
QW_SHORT, QW_LONG = (32, 512), (4, 4096)
QW_NL, QW_E, QW_H, QW_D, QW_F, QW_KV = 28, 1536, 12, 128, 8960, 256
QW_M = 16384
QW_K1 = 7 * QW_NL  # q, k, v, o, gate, up, down a layer
# its matmuls (q and o share a shape, k and v another): plain bias
# epilogues, the gate's SiLU in K1's epilogue
QW_K1_SHAPES = {"qw_q_o": (QW_E, QW_E, "bias"),
                "qw_k_v": (QW_E, QW_KV, "bias"),
                "qw_gate": (QW_E, QW_F, "bias_silu"),
                "qw_up": (QW_E, QW_F, "bias"),
                "qw_down": (QW_F, QW_E, "bias")}

# the encoder families on K1 and K2 alone (DistilBERT, RoBERTa, RoFormer,
# ALBERT): their timing shape, RoFormer's whole rows of 1,536 (under the
# whole-row rule's 1,920 at E=768), ALBERT under CP at B=32, L=512 on
# data 2 x seq 2 (a shard B=16, Lc=256: K8a on every application of the
# shared layer), and ALBERT's FFN-up with the tanh-GELU epilogue
# (gelu_new) for K1 and K3
ENC_SHAPE = (128, 256)
ROFORMER_LONG = (16, 1536)
CP_ALBERT, CP_ALBERT_MESH = (32, 512), (2, 2)
ALBERT_UP = (E, F, "bias_gelu_tanh")

# nomic-embed-text-v2-moe: 12 layers, an MoE FFN of 8 experts (top-2) at
# the 6 odd ones; 36 K1 a forward (qkv and o in every layer, up and down
# in the 6 dense ones); bucketed at B=128, L=256 (K2) and B=4, L=2,048
# (K6: past the whole-row rule at E=768), packed 256 rows of 128 (K4)
# DeepSeek-V2-Lite (the benchmark's configuration file): MLA's K6c at
# the cell's buckets (B=8; 16 heads, q and k 192 wide, v 128), a forward
# of the main path at full width and the cell's depth (the leading dense
# layer and 11 MoE layers), its routed experts' grouped products at a
# 1,024 bucket
DSV2_CONFIG = ROOT / "perfbench" / "configs" / "deepseek-v2-lite.json"
MLA_SHAPES = ((8, 1024), (8, 2048), (8, 4096))
MLA_H, MLA_D, MLA_DV = 16, 192, 128
DSV2_LAYERS = 12
# a forward at each bucket of the cell (8 rows a forward): 1,024, 2,048,
# 4,096
DSV2_LENGTHS = (129, 300, 512, 700, 900, 1000, 1024, 1024,
                1100, 1300, 1500, 1700, 1800, 1900, 2000, 2048,
                2500, 3001, 4096)
DSV2_EXPERTS, DSV2_HIDDEN, DSV2_I = 64, 2048, 1408
DSV2_ROWS = 8 * 1024 * 6  # (token, expert) pairs of a 1,024 bucket, top-6
MLA_REPLACES = ("none: the port's own mode (K6c at MLA's widths, q and k "
                "192 wide, v 128, the scale passed in); the JAX package "
                "has no MLA")
MOE_SHORT, MOE_LONG, MOE_PACK = (128, 256), (4, 2048), (256, 128)
MOE_NL, MOE_EXPERTS, MOE_K1 = 12, 8, 36
# the MoE combine's two kernels, one each a MoE layer (nomic: 6 a forward)
MOE_COMBINE_WANT = {"moe_combine_kernel": MOE_NL // 2,
                    "moe_positions_kernel": MOE_NL // 2}
# the MoE combine (ops.moe.combine_experts, csrc/moe_combine.cu) at the
# main paths' shapes: name -> (tokens T, k, D, experts, optional
# operands): DeepSeek-V2's 4,096 and 1,024 buckets (B=8; the shared
# expert), nomic's B=128 L=256 (the down and output biases), and a width
# off the 16-byte rows (the scalar instantiation; parity only)
COMBINE_SHAPES = {"dsv2_L4096": (32768, 6, 2048, 64, ("shared",)),
                  "dsv2_L1024": (8192, 6, 2048, 64, ("shared",)),
                  "nomic": (32768, 2, 768, 8, ("down_b", "bias")),
                  "odd_D100": (1000, 3, 100, 8,
                               ("down_b", "bias", "shared"))}
COMBINE_SOURCE = "embeddings_tpu_torch/csrc/moe_combine.cu"
COMBINE_REPLACES = ("none: the port's own (ops/moe.py combine_experts); "
                    "the JAX package combines with XLA's segment sum")
MOE_FIXTURE = ROOT / "benchmarks" / "fixtures" / "tiny_trained_moe"

# the checkpoint formats: bge-base's f32 tree (numpy seed 0) written by the
# port's writers, each file loaded with the dtypes below (file kind ->
# load dtypes: "f32" keeps a quantized file's weights as they were read,
# int8 codes; a q4 kind packs them; a dense or K-quant file is quantized
# to q4_0 on load); the reference's own .bin against its HF directory;
# and bge-reranker-base through Engine.rerank on 128 STS documents
GGML_FILES = {"q4_0": ("f32", "q4_0"), "q4_1": ("f32", "q4_1")}
GGUF_FILES = {"q4_0": ("f32", "q4_0"), "q8_0": ("f32",), "f16": ("q4_0",),
              "q4_K": ("q4_0",)}
REF_PARITY = ROOT / "tests" / "fixtures" / "ref_parity"
RERANK_DOCS = 128
# the reranker against the plain f32 path of the same tree: the CLS rows
# the head reads at the embedding paths' cosine (0.999), the logits at
# Pearson >= 0.99 over the documents (their max abs error reported).
# Random-init logits vary little across documents (their spread is the
# signal Pearson sees), so bf16 rounding alone holds Pearson near 0.995
# (the plain versions in bf16 on the CPU, 2-6 layers at E=768), below the
# 0.999 an embedding's cosine reaches.
RERANK_PEARSON = 0.99


def file_engine_name(fmt: str, kind: str, dtype: str) -> str:
    """The file-loaded engine's name: "ggml_q4_0", "gguf_f16_as_q4_0"."""
    return f"{'ggml' if fmt == 'bin' else 'gguf'}_{kind}" + (
        f"_as_{dtype}" if dtype != "f32" else "")


# the weight layouts a file gives K1 beyond the main path's q4_0 packed
# codes: layout -> the engine whose forward runs it
FILE_LAYOUTS = {("q4_0", False): "ggml_q4_0", ("q4_1", True):
                "ggml_q4_1_as_q4_1", ("q8_0", False): "gguf_q8_0"}
FILE_ENGINES = [file_engine_name(fmt, kind, dtype)
                for fmt, files in (("bin", GGML_FILES), ("gguf", GGUF_FILES))
                for kind, dtypes in files.items() for dtype in dtypes]

# tolerances (kernel vs plain version on the same inputs, bf16 outputs):
# both round the same bf16 operands and accumulate in f32 in different
# orders, so outputs differ where an f32 value sits next to a bf16
# rounding boundary: one bf16 ulp (2^-8 relative) plus what that flip
# carries through an epilogue. K2 also rounds each probability to bf16
# after exp2 (CUDA exp2f vs torch.exp2 may differ by an f32 ulp), so its
# flips reach the output through the p.v sum.
K1_RTOL, K1_ATOL_RMS = 2.0 ** -7, 1e-3
K2_RTOL, K2_ATOL_RMS = 2.0 ** -6, 1e-2
# K3 as K1: its int8 operands equal the plain version's bit for bit and
# its s32 sums are exact, so only the activation's last f32 bits and the
# bf16 rounding of the output differ. K4-K7 as K2.
K3_RTOL, K3_ATOL_RMS = K1_RTOL, K1_ATOL_RMS
# emission (K1e / K3e): the int8 codes of the f32 epilogue output may
# differ by one step where the kernel's f32 value and the plain version's
# straddle a rounding midpoint (LayerNorm sums, K1's product order), and
# the row scales by those values' last bits
EMIT_CODE_STEPS, EMIT_SCALE_RTOL = 1, 1e-4

RESULTS: dict = {}   # one JSON line per phase, dumped at the end
STATE: dict = {}     # engines, parameters, launch counts, inputs


def emit(phase: str, **fields) -> None:
    """Print a phase's JSON line, with the phase's K1 launches by tile
    route (``qmatmul.routes``)."""
    from embeddings_tpu_torch.ops.qmatmul import qmatmul
    if qmatmul.routes and "routes" not in fields:
        fields["k1_routes"] = dict(qmatmul.routes)
    line = {"phase": phase, **fields}
    RESULTS[phase] = line
    print(json.dumps(line), flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms (CUDA events around iters calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float,
             peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops = flops / peak * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def compare(got, ref, rtol: float, atol_rms: float) -> dict:
    """max abs error, min row cosine, and whether every element is within
    rtol * |ref| + atol_rms * rms(ref)."""
    import torch
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    rms = r.square().mean().sqrt().item()
    ok = bool(torch.isfinite(g).all()) and bool(
        (err <= rtol * r.abs() + atol_rms * rms).all())
    gn = torch.nn.functional.normalize(g, dim=-1)
    rn = torch.nn.functional.normalize(r, dim=-1)
    nz = r.abs().amax(-1) > 0
    cos = (gn * rn).sum(-1)[nz]
    return {"max_abs_err": err.max().item(), "ref_rms": rms,
            "min_row_cos": cos.min().item() if cos.numel() else 1.0,
            "ok": ok}


def quantized_weight(rng, K: int, N: int, kind: str, packed: bool, device):
    from embeddings_tpu_torch.ops.quant import quantize
    w = rng.standard_normal((K, N), dtype=np.float32) * np.float32(0.02)
    qt = quantize(w, kind, pack4=packed)
    return qt.map(lambda t: t.to(device))


def k1_inputs(rng, Mx, K, N, kind, packed, epilogue, device):
    import torch
    qt = quantized_weight(rng, K, N, kind, packed, device)

    def f32(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * np.float32(scale)).to(device)

    args = dict(x=f32(Mx, K).to(torch.bfloat16), codes=qt.codes,
                scales=qt.scales, mins=qt.mins, bias=f32(N, scale=0.1))
    kw = dict(kind=kind, epilogue=epilogue, packed=qt.packed)
    if epilogue == "bias_residual_ln":
        kw.update(residual=f32(Mx, N).to(torch.bfloat16),
                  ln_scale=1.0 + f32(N, scale=0.1), ln_bias=f32(N, scale=0.1))
    return args, kw, qt


def k1_cost(Mx, K, N, epilogue, kind: str = "q4_0",
            packed: bool = True) -> tuple[float, float]:
    """(flops, bytes) of one K1 call: each input read once, the output
    written once (the codes: nibbles when packed, else one byte each; f32
    scales, q4_1's f32 mins, and the bias)."""
    codes = K // 2 * N if packed else K * N
    mins = K // 32 * N * 4 if kind == "q4_1" else 0
    nbytes = (Mx * K * 2 + codes + K // 32 * N * 4 + mins + N * 4
              + Mx * N * 2)
    if epilogue == "bias_residual_ln":
        nbytes += Mx * N * 2 + 2 * N * 4
    return 2.0 * Mx * K * N, float(nbytes)


def counters() -> dict:
    """The kernels' launch counters: name -> (wrapper, attribute). K6c
    and K6ca count apart from K6 on the same wrapper; the chained-int8
    modes on theirs: K3x (int8 x, no row quantization), K1e / K3e / K2e /
    K4e by emission mode, K2i8; K3's own launches beside its product:
    "K3_rows" its row quantization, "K3_requant" a weight's
    requantization (none in a forward: the Engine keeps them);
    "quantize_act" counts the plain quantization of an activation (the
    embedding output under the "ln" link)."""
    from embeddings_tpu_torch.ops import attention as A, linear as Lin, \
        qmatmul as Q
    stream = A.fused_attention_stream
    fa, seg = A.fused_attention, A.fused_attention_segmented
    return {"K1": (Q.qmatmul, "launches"),
            "K2": (fa, "launches"),
            "K3": (Q.qmatmul_int8, "launches"),
            "K4": (seg, "launches"),
            "K5": (A.fused_attention_segmented_blockskip, "launches"),
            "K6": (stream, "launches"),
            "K7": (A.fused_attention_bias, "launches"),
            "K6w": (A.fused_attention_window, "launches"),
            "K6c": (stream, "causal_launches"),
            "K6ca": (stream, "causal_alibi_launches"),
            "K1e_both": (Q.qmatmul, "both_launches"),
            "K1e_only": (Q.qmatmul, "only_launches"),
            "K3x": (Q.qmatmul_int8, "x8_launches"),
            "K3_rows": (Q.quantize_rows_int8, "launches"),
            "K3_requant": (Q.requantize_int8, "launches"),
            "K3e_both": (Q.qmatmul_int8, "both_launches"),
            "K3e_only": (Q.qmatmul_int8, "only_launches"),
            "K2e_both": (fa, "both_launches"),
            "K2e_only": (fa, "only_launches"),
            "K2i8": (fa, "i8s_launches"),
            "K4e_both": (seg, "both_launches"),
            "K4e_only": (seg, "only_launches"),
            "K8a": (A.fused_attention_cp, "launches"),
            "K8b": (A.fused_attention_cp_stream, "launches"),
            "quantize_act": (Lin.quantize_act, "calls")}


def reset_counts() -> None:
    from embeddings_tpu_torch.ops import attention as A, qmatmul as Q
    set_counts(dict.fromkeys(counters(), 0))
    for f, _ in counters().values():
        if hasattr(f, "shapes"):
            f.shapes.clear()
            f.modes.clear()
    Q.qmatmul_int8.routes.clear()
    for f in (A.fused_attention_bias, A.fused_attention_segmented,
              A.fused_attention_segmented_blockskip, A.fused_attention_cp,
              A.fused_attention_cp_stream, A.fused_attention_window):
        f.routes.clear()


def set_counts(counts: dict) -> None:
    for k, (f, attr) in counters().items():
        setattr(f, attr, counts[k])


def read_counts() -> dict:
    return {k: getattr(f, attr) for k, (f, attr) in counters().items()}


def only(**launches) -> dict:
    """The launch counts of a run that launched these kernels, and no
    other."""
    return {k: launches.get(k, 0) for k in counters()}


def packed_tables(rows: int, row_len: int):
    """Token-packed device arrays from the STS fixture: up to rows - 1
    packed rows (the last row stays all pad), built by the port's
    planner. Returns (ids, seg, pos, pool) numpy arrays and the bucketed
    block-skip window."""
    from embeddings_tpu_torch.runtime.engine import _bucket_window
    from embeddings_tpu_torch.runtime.packing import materialize, \
        max_block_span, plan_packing
    from embeddings_tpu_torch.tokenizer import tokenizer_from_dir
    tok = tokenizer_from_dir(FIXTURE / "model")
    toks = [tok.encode(t, max_len=row_len) for t in _sts_sentences(2400)]
    b = plan_packing([len(t) for t in toks], row_len, rows - 1,
                     max_segs=max(2, row_len // 8))[0]
    b.batch = rows
    ids, seg, pos, pool, _ = materialize(b, toks, tok.pad_id, "cls")
    w = max_block_span(seg) if row_len > 128 else 0
    return (ids, seg, pos, pool), _bucket_window(w, row_len)


def seg_flops(seg: np.ndarray) -> float:
    """Operations that segment-masked attention needs on this data: the
    two products over same-segment (query, key) pairs only."""
    pairs = 0
    for row in seg:
        _, n = np.unique(row[row >= 0], return_counts=True)
        pairs += int((n.astype(np.int64) ** 2).sum())
    return 4.0 * H * D * pairs


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    STATE["nvidia_smi"] = smi[0] if smi else None
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()
    STATE["sm_clock_mhz"] = float(clock[0]) if clock else None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi[0] if smi else None,
         max_sm_clock_mhz=STATE["sm_clock_mhz"],
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])


SOURCES = ("qmatmul", "attention_sm90")
# the libraries without tensor-core products (built beside SOURCES)
PLAIN_SOURCES = ("moe_combine",)


def phase_build():
    """Build the libraries; the two of SOURCES hold wgmma and no
    mma.sync: bf16 (HGMMA) and int8 (IGMMA: K3 in qmatmul's, K2i8 in the
    attention one) in each, and no library holds HMMA (bf16 mma.sync /
    WMMA) or IMMA (int8 mma.sync), so the port has no mma.sync at all.
    ptxas's C75xx notes (each a kernel whose wgmma it serializes) are
    counted per library from its -v report; no library has one. The MoE
    combine's registers and spills are printed from that report. The
    native tokenizer (g++) builds beside them, in a thread."""
    import threading
    from embeddings_tpu_torch.ops import _cuda
    from embeddings_tpu_torch.tokenizer import native
    native_err = []

    def build_native():
        t0 = time.perf_counter()
        try:
            native.build()
        except RuntimeError as exc:
            native_err.append(str(exc))
        STATE["native_build_s"] = time.perf_counter() - t0

    tok = threading.Thread(target=build_native)
    tok.start()
    t0 = time.perf_counter()
    seconds = _cuda.build(*SOURCES, *PLAIN_SOURCES)  # one nvcc each
    tok.join()
    check(not native_err, f"native tokenizer build failed: {native_err}")
    hgmma = {name: hgmma_count(name) for name in SOURCES}
    for name, n in hgmma.items():
        check(n > 0, f"{name}'s library holds no HGMMA (wgmma) instruction")
    igmma = {name: hgmma_count(name, "IGMMA") for name in SOURCES}
    for name, n in igmma.items():
        check(n > 0, f"{name}'s library holds no IGMMA (int8 wgmma)")
    mma_sync = {name: {op: hgmma_count(name, op) for op in ("HMMA", "IMMA")}
                for name in SOURCES + PLAIN_SOURCES}
    for name, ops in mma_sync.items():
        check(not any(ops.values()),
              f"{name}'s library holds mma.sync instructions: {ops}")
    c75 = {name: _cuda.BUILD_LOGS[name].count("(C75")
           for name in SOURCES if name in _cuda.BUILD_LOGS}
    for name, n in c75.items():
        check(n == 0, f"ptxas serializes wgmma in {name}'s library: "
              + "; ".join(line for line in _cuda.BUILD_LOGS[name]
                          .splitlines() if "(C75" in line)[:2000])
    emit("build", seconds=time.perf_counter() - t0, per_source=seconds,
         native_tokenizer_s=STATE["native_build_s"],
         hgmma_in_sass=hgmma, igmma_in_sass=igmma,
         mma_sync_in_sass=mma_sync, ptxas_c75xx_notes=c75,
         ptxas={name: [line.strip() for line in _cuda.BUILD_LOGS.get(
             name, "").splitlines() if "registers" in line or "spill" in line]
             for name in PLAIN_SOURCES})


def hgmma_count(name: str, opcode: str = "HGMMA") -> int:
    """HGMMA (bf16 wgmma) instructions, or those of another opcode
    (IGMMA: int8 wgmma; HMMA, IMMA: bf16 and int8 WMMA / mma.sync), in the
    built library ``name``'s SASS, as ``cuobjdump --dump-sass`` lists
    them."""
    from embeddings_tpu_torch.ops import _cuda
    cuobjdump = Path(_cuda._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass",
                           str(_cuda._target(name))],
                          capture_output=True, text=True, timeout=300).stdout
    return sass.count(opcode)


# K1's cases beyond the main shapes (name -> M, K, N, epilogue, emit): the
# LayerNorm cluster at 8 and 16 blocks, ragged M (32,768 + 40) at bge's
# four shapes, the LayerNorm emission, context parallelism's shard
# (M = 4,096, where the tile is 128 rows) at the two LayerNorm shapes, and
# ALBERT's FFN-up (tanh GELU)
K1_EXTRA = {
    "ln_N1024": (M, 1024, 1024, "bias_residual_ln", "no"),
    "ln_N2048": (M, 1024, 2048, "bias_residual_ln", "no"),
    **{f"ragged_{name}": (M + 40, K, N, epi, "no")
       for name, (K, N, epi) in K1_SHAPES.items()},
    "ln_emit_both": (M, E, E, "bias_residual_ln", "both"),
    "ln_emit_only": (M, E, E, "bias_residual_ln", "only"),
    "cp_o_proj": (4096, E, E, "bias_residual_ln", "no"),
    "cp_ffn_down": (4096, F, E, "bias_residual_ln", "no"),
    "albert_up": (M, *ALBERT_UP, "no"),
    # a tensor-parallel shard's (tp_path, B=32 L=512: 16,384 rows):
    # column slices with their bias, row slices with no epilogue (the sum
    # and the LayerNorm follow); at tp=4 q/k/v are 192 wide (1.5 tiles)
    **{name: (TP_M, K, N, epi, "no") for name, (K, N, epi)
       in TP_K1_SHAPES.items()}}


def phase_k1():
    import torch
    from embeddings_tpu_torch.ops.qmatmul import EPILOGUES, qmatmul, \
        qmatmul_ref
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    hgmma = hgmma_count("qmatmul")
    check(hgmma > 0, "K1's library holds no HGMMA (wgmma) instruction")
    main = {}
    for name, (K, N, epi) in {**K1_SHAPES, **MB_K1_SHAPES,
                              **QW_K1_SHAPES}.items():
        Mx = QW_M if name in QW_K1_SHAPES else M
        args, kw, _ = k1_inputs(rng, Mx, K, N, "q4_0", True, epi, dev)
        got = qmatmul(*args.values(), **kw)
        ref = qmatmul_ref(*args.values(), **kw)
        torch.cuda.synchronize()
        main[name] = compare(got, ref, K1_RTOL, K1_ATOL_RMS)
        check(main[name]["ok"], f"K1 {name} disagrees: {main[name]}")
    extra = {}
    for name, (Mx, K, N, epi, em) in K1_EXTRA.items():
        args, kw, _ = k1_inputs(rng, Mx, K, N, "q4_0", True, epi, dev)
        got = qmatmul(*args.values(), emit_quantized=em, **kw)
        ref = qmatmul_ref(*args.values(), emit_quantized=em, **kw)
        torch.cuda.synchronize()
        if em == "no":
            r = compare(got, ref, K1_RTOL, K1_ATOL_RMS)
        else:
            r = emit_compare(got, ref, em)
        extra[name] = dict(r, shape=[Mx, K, N], epilogue=epi, emit=em)
        check(r["ok"], f"K1 {name} disagrees: {r}")
        del got, ref
    small, worst = {}, 0.0
    for kind, packed in (("q4_0", False), ("q4_0", True), ("q4_1", False),
                         ("q4_1", True), ("q8_0", False), ("nf4", False),
                         ("nf4", True)):
        for epi in EPILOGUES:
            # ragged M (not a multiple of any tile) and N (128 + 8)
            args, kw, _ = k1_inputs(rng, 40, 128, 136, kind, packed, epi, dev)
            got = qmatmul(*args.values(), **kw)
            ref = qmatmul_ref(*args.values(), **kw)
            r = compare(got, ref, K1_RTOL, K1_ATOL_RMS)
            key = f"{kind}{'_packed' if packed else ''}/{epi}"
            small[key] = r
            worst = max(worst, r["max_abs_err"])
            check(r["ok"], f"K1 {key} disagrees: {r}")
    emit("k1_parity", tolerance=f"|err| <= {K1_RTOL}*|ref| + "
         f"{K1_ATOL_RMS}*rms(ref); emission: codes within "
         f"{EMIT_CODE_STEPS} step, scales within {EMIT_SCALE_RTOL} "
         f"relative", hgmma_in_sass=hgmma, main=main, extra=extra,
         small_cases=len(small), small_worst_max_abs_err=worst,
         routes=dict(qmatmul.routes))
    RESULTS["k1_small"] = small


def _k2_case(rng, Bx, Lx, lengths, dev, Hx=H, Dx=D):
    import torch
    from embeddings_tpu_torch.ops.attention import fused_attention, \
        fused_attention_ref
    Ex = Hx * Dx
    qkv = torch.from_numpy(rng.standard_normal(
        (Bx * Lx, 3 * Ex), dtype=np.float32)).to(dev, torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = fused_attention(qkv, lens, B=Bx, L=Lx, H=Hx, D=Dx)
    ref = fused_attention_ref(qkv, lens, B=Bx, L=Lx, H=Hx, D=Dx)
    torch.cuda.synchronize()
    r = compare(got, ref, K2_RTOL, K2_ATOL_RMS)
    zero_rows = [b for b, n in enumerate(lengths) if n == 0]
    r["zero_rows_exact"] = all(
        bool((got.reshape(Bx, Lx, Ex)[b] == 0).all()) for b in zero_rows)
    return r


# lengths on the Hopper attention kernel's tile edges (64 queries, 128
# keys), clipped to L in use
TILE_EDGES = (0, 1, 63, 64, 65, 127, 128, 129)


def fused_attention_routes() -> dict:
    """K2's, K6's and K6w's launches so far by kernel
    (``attention_kernel``; K7's: ``bias_routes``)."""
    from embeddings_tpu_torch.ops import attention as A
    return {"fused_attention": dict(A.fused_attention.routes),
            "fused_attention_stream": dict(A.fused_attention_stream.routes),
            "fused_attention_window": dict(A.fused_attention_window.routes)}


def phase_k2():
    import torch
    rng = np.random.default_rng(2)
    dev = torch.device("cuda")
    lens = rng.integers(1, L + 1, B)
    lens[0], lens[1], lens[2] = 0, L, 1
    r256 = _k2_case(rng, B, L, lens.tolist(), dev)
    lens512 = rng.integers(1, 513, 16)
    lens512[0], lens512[1] = 0, 512
    r512 = _k2_case(rng, 16, 512, lens512.tolist(), dev)
    # Qwen2's bidirectional short rows: D=128 at B=32, L=512
    lensq = rng.integers(1, QW_SHORT[1] + 1, QW_SHORT[0])
    lensq[0], lensq[1] = 0, QW_SHORT[1]
    rq = _k2_case(rng, *QW_SHORT, lensq.tolist(), dev, QW_H, QW_D)
    # ModernBERT's global layers at B=32, L=1,024 (blocked queries in JAX)
    lensm = rng.integers(1, MB_SHORT[1] + 1, MB_SHORT[0])
    lensm[0], lensm[1] = 0, MB_SHORT[1]
    rm = _k2_case(rng, *MB_SHORT, lensm.tolist(), dev)
    # RoFormer's whole rows at B=16, L=1,536
    lensr = rng.integers(1, ROFORMER_LONG[1] + 1, ROFORMER_LONG[0])
    lensr[0], lensr[1] = 0, ROFORMER_LONG[1]
    rr = _k2_case(rng, *ROFORMER_LONG, lensr.tolist(), dev)
    out = {"L256": r256, "L512": r512, "L512_D128": rq, "L1024": rm,
           "L1536": rr}
    # lengths on the Hopper kernel's tile edges (64 queries, 128 keys), at
    # a ragged L=200 and at L=512, D=64 and 128
    for Lx, (Hx, Dx) in ((200, (H, D)), (512, (H, D)), (512, (QW_H, QW_D))):
        lensx = [min(n, Lx) for n in TILE_EDGES] + [Lx]
        out[f"edges_L{Lx}_D{Dx}"] = _k2_case(rng, len(lensx), Lx, lensx,
                                             dev, Hx, Dx)
    for name, r in out.items():
        check(r["ok"] and r["zero_rows_exact"],
              f"K2 {name} disagrees: {r}")
    emit("k2_parity", tolerance=f"|err| <= {K2_RTOL}*|ref| + "
         f"{K2_ATOL_RMS}*rms(ref); len-0 rows exactly 0",
         routes=fused_attention_routes(), **out)


# K3's kinds and its tile edges: (M, K, N) with K not a multiple of its
# 128-value chunk (96, 160; 192 packed), one partial N tile (136), M
# ragged against both row tiles (40, 257), and LayerNorm clusters of 16
# blocks (N = 2,048, 128-row tiles)
K3_KINDS = (("q4_0", False), ("q4_0", True), ("q4_1", False), ("q4_1", True),
            ("q8_0", False), ("nf4", False), ("nf4", True))
K3_EDGES = ((40, 96, 136), (257, 160, 256), (40, 128, 2048))


def phase_k3():
    """K3 (K1's wgmma kernel on int8 operands): its int8 operands bit for
    bit against the plain version's (the kept weight ``requantize_int8``
    vs ``requantize_weight``, the rows ``quantize_rows_int8`` vs
    ``quantize_rows``, every kind, packed and not); bge's four shapes at
    full width (and ALBERT's FFN-up, tanh GELU) through
    qmatmul(int8_compute=True) with the weight kept and without it (a
    per-call requantization); every kind and epilogue at
    the tile edges (K3_EDGES), with emission "no", "both" and "only"."""
    import torch
    from embeddings_tpu_torch.ops import qmatmul as Q
    rng = np.random.default_rng(4)
    dev = torch.device("cuda")
    bits = {}
    for kind, packed in K3_KINDS:
        K = 192 if packed else 160
        args, kw, qt = k1_inputs(rng, 257, K, 136, kind, packed, "bias", dev)
        w8t, cs = Q.requantize_int8(qt.codes, qt.scales, qt.mins, kind=kind,
                                    packed=packed)
        w8, rcs = Q.requantize_weight(qt.codes, qt.scales, qt.mins, kind,
                                      packed)
        q8, sx = Q.quantize_rows_int8(args["x"])
        rq8, rsx = Q.quantize_rows(args["x"])
        torch.cuda.synchronize()
        key = f"{kind}{'_packed' if packed else ''}"
        bits[key] = {"w8": bool(torch.equal(w8t, w8.t())),
                     "cs": bool(torch.equal(cs, rcs.reshape(-1))),
                     "q": bool(torch.equal(q8, rq8)),
                     "sx": bool(torch.equal(sx, rsx.reshape(-1)))}
        check(all(bits[key].values()), f"K3 operands of {key} differ from "
              f"the plain version's: {bits[key]}")
    main = {}
    for name, (K, N, epi) in {**K1_SHAPES, "albert_up": ALBERT_UP}.items():
        args, kw, qt = k1_inputs(rng, M, K, N, "q4_0", True, epi, dev)
        kept = Q.keep_int8_weight(qt).int8
        ref = Q.qmatmul_int8_ref(*args.values(), **kw)
        # through qmatmul(int8_compute=True), the route the engine takes
        got = Q.qmatmul(*args.values(), int8_compute=True, int8_weight=kept,
                        **kw)
        once = Q.qmatmul(*args.values(), int8_compute=True, **kw)
        torch.cuda.synchronize()
        main[name] = compare(got, ref, K3_RTOL, K3_ATOL_RMS)
        main[name]["per_call_requant"] = compare(once, ref, K3_RTOL,
                                                 K3_ATOL_RMS)
        check(main[name]["ok"] and main[name]["per_call_requant"]["ok"],
              f"K3 {name} disagrees: {main[name]}")
        del got, once, ref
    small, worst = {}, 0.0
    for kind, packed in K3_KINDS:
        for epi in Q.EPILOGUES:
            for Mx, K, N in K3_EDGES:
                K = K if not packed else -(-K // 64) * 64
                for how in ("no", "both", "only"):
                    args, kw, _ = k1_inputs(rng, Mx, K, N, kind, packed, epi,
                                            dev)
                    got = Q.qmatmul_int8(*args.values(), emit_quantized=how,
                                         **kw)
                    ref = Q.qmatmul_int8_ref(*args.values(),
                                             emit_quantized=how, **kw)
                    r = (compare(got, ref, K3_RTOL, K3_ATOL_RMS)
                         if how == "no" else emit_compare(got, ref, how))
                    key = (f"{kind}{'_packed' if packed else ''}/{epi}/"
                           f"{Mx}x{K}x{N}/{how}")
                    small[key] = r
                    worst = max(worst, r["max_abs_err"])
                    check(r["ok"], f"K3 {key} disagrees: {r}")
    emit("k3_parity", tolerance=f"|err| <= {K3_RTOL}*|ref| + "
         f"{K3_ATOL_RMS}*rms(ref); emission as K1e; int8 operands bit for "
         f"bit", operands_bit_for_bit=bits, main=main,
         small_cases=len(small), small_worst_max_abs_err=worst,
         routes=dict(Q.qmatmul_int8.routes))
    RESULTS["k3_small"] = small


def phase_k4k5():
    import torch
    from embeddings_tpu_torch.ops import attention as A
    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    out = {}
    for name, (Bx, Lx) in (("K4", PACK_SHORT), ("K5", PACK_LONG)):
        arrays, W = packed_tables(Bx, Lx)
        seg = torch.from_numpy(arrays[1]).to(dev)
        qkv = torch.from_numpy(rng.standard_normal(
            (Bx * Lx, 3 * E), dtype=np.float32)).to(dev, torch.bfloat16)
        kw = dict(B=Bx, L=Lx, H=H, D=D)
        routes = None
        if name == "K4":
            # K4 runs on the Hopper kernel (mode 1), every head a block
            got, routes = _routed(A.fused_attention_segmented,
                                  lambda: A.fused_attention_segmented(
                                      qkv, seg, **kw))
            ref = A.fused_attention_segmented_ref(qkv, seg, **kw)
        else:
            # K5 on the Hopper kernel (mode 2), every head a block
            check(W == 3, f"K5 window {W} at row_len {Lx}, expected 3")
            got, routes = _routed(
                A.fused_attention_segmented_blockskip,
                lambda: A.fused_attention_segmented_blockskip(
                    qkv, seg, window=W, **kw))
            ref = A.fused_attention_segmented_blockskip_ref(
                qkv, seg, window=W, **kw)
        torch.cuda.synchronize()
        r = compare(got, ref, K2_RTOL, K2_ATOL_RMS)
        r["routes"] = routes
        check(routes == {"sm90": 1}, f"{name} launches by route {routes}")
        pad = (seg.reshape(-1) < 0)
        r.update(rows=Bx, row_len=Lx, window=W,
                 pad_rows_exact_zero=bool((got[pad] == 0).all()),
                 all_pad_rows=int((seg < 0).all(1).sum()),
                 segments=int(sum(len(np.unique(s[s >= 0]))
                                  for s in arrays[1])))
        if name == "K5":
            # the window drops nothing here: K5 equals the full K4 math
            full = A.fused_attention_segmented_ref(qkv, seg, **kw)
            r["vs_full_segmented"] = compare(got, full, K2_RTOL,
                                             K2_ATOL_RMS)
            check(r["vs_full_segmented"]["ok"], "K5 differs from the full "
                  f"segmented attention: {r['vs_full_segmented']}")
        check(r["ok"] and r["pad_rows_exact_zero"] and r["all_pad_rows"],
              f"{name} disagrees: {r}")
        out[name] = r
        STATE[name] = (qkv, seg, arrays, W)
    out["K5_dropping"] = _k5_dropping(rng, dev)
    emit("k4k5_parity", tolerance=f"|err| <= {K2_RTOL}*|ref| + "
         f"{K2_ATOL_RMS}*rms(ref); pad query rows exactly 0", **out)


def _k5_dropping(rng, dev) -> dict:
    """K5 at PACK_LONG's shape with a window that really drops key blocks:
    the fixture's packed rows re-cut into segments of 200-400 tokens
    (spans of up to 4 key blocks) under W=2, the last 3 rows all pad and
    every other row's tail past 800 pad (all-pad query blocks, the empty
    range (nK, -1)); against its plain version, one "sm90" launch."""
    import torch
    from embeddings_tpu_torch.ops import attention as A
    Bx, Lx = PACK_LONG
    seg = np.full((Bx, Lx), -1, np.int32)
    for b in range(Bx - 3):
        end = Lx if b % 2 else 800
        pos, s = 0, 0
        while pos < end:
            n = int(rng.integers(200, 401))
            seg[b, pos:min(pos + n, end)] = s
            pos, s = pos + n, s + 1
    seg = torch.from_numpy(seg).to(dev)
    qkv = torch.from_numpy(rng.standard_normal(
        (Bx * Lx, 3 * E), dtype=np.float32)).to(dev, torch.bfloat16)
    kw = dict(B=Bx, L=Lx, H=H, D=D, window=2)
    kbs, kbe = A.block_ranges(seg, Lx)
    spans = (kbe - kbs + 1).clamp_min(0)
    got, routes = _routed(
        A.fused_attention_segmented_blockskip,
        lambda: A.fused_attention_segmented_blockskip(qkv, seg, **kw))
    r = compare(got, A.fused_attention_segmented_blockskip_ref(qkv, seg,
                                                                **kw),
                K2_RTOL, K2_ATOL_RMS)
    pad = seg.reshape(-1) < 0
    r.update(routes=routes, window=2,
             query_blocks_dropping=int((spans > 2).sum()),
             empty_query_blocks=int((kbe < kbs).sum()),
             pad_rows_exact_zero=bool((got[pad] == 0).all()))
    check(r["ok"] and r["pad_rows_exact_zero"] and routes == {"sm90": 1}
          and r["query_blocks_dropping"] > 0 and r["empty_query_blocks"] > 0,
          f"K5 with dropped blocks disagrees: {r}")
    return r


def _sts_sentences(n: int) -> list[str]:
    rows = (FIXTURE / "sts-test.tsv").read_text().splitlines()
    out = []
    for row in rows:
        out.extend(row.split("\t")[1:3])
    return out[:n]


def n_bucketed_forwards(eng, texts) -> int:
    """Device batches ``Engine.encode_batch`` runs for these texts."""
    from embeddings_tpu_torch.runtime.batching import extend_buckets, \
        plan_batches
    bs = eng.engine_config.batch_size
    return len(plan_batches(
        [len(eng.tokenize(t)) for t in texts], bs, eng._seq_buckets(),
        extend_buckets(eng.engine_config.batch_buckets, bs)))


def _bge_base_engine(mesh=None, device=None, **ec):
    """bge-base q4_0 packed on the card (``device``, default the current
    one), from one random tree (numpy seed 0) built once: fused qkv on
    one device and on a CP mesh, q/k/v apart on a ("data", "model") mesh
    (tensor parallelism shards them; a model axis of 1 fuses them)."""
    import torch
    from embeddings_tpu_torch import BertConfig, EngineConfig, KNOWN_MODELS
    from embeddings_tpu_torch.models import params as P
    from embeddings_tpu_torch.runtime.engine import Engine
    from embeddings_tpu_torch.tokenizer import tokenizer_from_dir
    if "params" not in STATE:
        cfg = BertConfig(**{**KNOWN_MODELS["bge-base-en-v1.5"],
                            "vocab_size": 30528})
        t0 = time.perf_counter()
        unfused = P.pack_q4_params(P.quantize_params(
            P.init_params(cfg, np.random.default_rng(0)), "q4_0"))
        STATE["params"] = (cfg, P.fuse_qkv(unfused), time.perf_counter() - t0)
        STATE["params_unfused"] = unfused
    cfg, params, _ = STATE["params"]
    if mesh is not None and "model" in mesh.shape:
        params = STATE["params_unfused"]
    tok = tokenizer_from_dir(FIXTURE / "model")
    return Engine(params, cfg, tok, EngineConfig(**{"batch_size": 128, **ec}),
                  device=None if mesh else (device or torch.device("cuda")),
                  mesh=mesh)


def phase_main_path():
    import torch
    from embeddings_tpu_torch.ops.qmatmul import qmatmul
    eng = _bge_base_engine()
    texts = _sts_sentences(300)
    texts += texts[:8]  # identical sentences: cosine 1.0
    n_forwards = n_bucketed_forwards(eng, texts)
    reset_counts()
    t0 = time.perf_counter()
    emb = eng.encode_batch(texts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    k1, k2 = counts["K1"], counts["K2"]
    STATE.setdefault("launches", {}).update(
        qmatmul=dict(qmatmul.shapes), fused_attention=k2)
    norms = np.linalg.norm(emb, axis=1)
    dup = (emb[:8] * emb[-8:]).sum(-1)
    plain = _bge_base_engine(use_pallas="never", compute_dtype="float32")
    emb_plain = plain.encode_batch(texts)
    cos = (emb * emb_plain).sum(-1) / (
        np.linalg.norm(emb, axis=1) * np.linalg.norm(emb_plain, axis=1))
    emit("main_path", model="bge-base-en-v1.5 (random init, numpy seed 0, "
         "vocab 30528) q4_0 packed + fused qkv", sentences=len(texts),
         forwards=n_forwards, wall_s=wall,
         init_quantize_s=STATE["params"][2],
         k1_launches=k1, k2_launches=k2,
         k1_per_forward=k1 / n_forwards, k2_per_forward=k2 / n_forwards,
         norm_min=float(norms.min()), norm_max=float(norms.max()),
         identical_min_cos=float(dup.min()),
         kernel_vs_plain_f32_min_cos=float(cos.min()),
         finite=bool(np.isfinite(emb).all()))
    check(np.isfinite(emb).all() and emb.shape == (len(texts), E),
          "main path output not finite / wrong shape")
    check(counts == only(K1=48 * n_forwards, K2=12 * n_forwards),
          f"launches {counts} over {n_forwards} forwards")
    check(np.abs(norms - 1).max() < 1e-3, "embeddings are not unit norm")
    check(dup.min() >= 1 - 1e-6, "identical sentences differ")
    check(cos.min() >= 0.999, f"kernel path vs plain f32: {cos.min()}")
    STATE["engine"], STATE["main_emb"] = eng, emb


def phase_trained():
    import torch
    from embeddings_tpu_torch import EngineConfig, load_model
    texts = _sts_sentences(200)
    q4 = load_model(FIXTURE / "model", dtype="q4_0",
                    device=torch.device("cuda"))
    f32 = load_model(FIXTURE / "model", dtype="f32",
                     device=torch.device("cuda"),
                     engine_config=EngineConfig(use_pallas="never",
                                                compute_dtype="float32"))
    a, b = q4.encode_batch(texts), f32.encode_batch(texts)
    cos = (a * b).sum(-1)
    emit("trained_fixture", model=str(FIXTURE.relative_to(ROOT) / "model"),
         sentences=len(texts), q4_0_vs_f32_min_cos=float(cos.min()),
         q4_0_vs_f32_mean_cos=float(cos.mean()))
    check(cos.min() > 0.99, f"q4_0 vs f32 cosine {cos.min()}")


def phase_server():
    _check_tcp("server", STATE["engine"])


def _check_tcp(phase: str, eng, **extra) -> None:
    """Six texts through serve_tcp, one connection: answers equal
    Engine.encode."""
    from embeddings_tpu_torch.runtime.client import TcpClient
    from embeddings_tpu_torch.runtime.server import serve_tcp
    texts = _sts_sentences(6)

    async def run():
        server, service = await serve_tcp(eng, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]

        def client():
            with TcpClient("127.0.0.1", port, timeout=120) as c:
                return c.n_embd, [c.embed(t) for t in texts]
        try:
            return await asyncio.to_thread(client)
        finally:
            server.close()
            await server.wait_closed()
            await service.stop()

    n_embd, answers = asyncio.run(run())
    direct = [eng.encode(t) for t in texts]
    diff = max(float(np.abs(a - d).max()) for a, d in zip(answers, direct))
    emit(phase, requests=len(texts), n_embd=n_embd,
         max_abs_diff_vs_encode=diff, **extra)
    check(n_embd == eng.config.hidden_size and diff <= 1e-6,
          f"{phase}: n_embd {n_embd}, TCP answers differ by {diff}")


def phase_int8_path():
    """The int8 compute mode end to end: every quantized matmul through
    K3 (its rows quantized in a launch each, its weights kept from the
    Engine's build: no requantization), attention through K2."""
    import torch
    from embeddings_tpu_torch.ops.qmatmul import qmatmul_int8
    eng8 = _bge_base_engine(int8_compute=True)
    texts = _sts_sentences(300)
    texts += texts[:8]
    n_forwards = n_bucketed_forwards(eng8, texts)
    reset_counts()
    t0 = time.perf_counter()
    emb = eng8.encode_batch(texts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    STATE.setdefault("launches", {})["qmatmul_int8"] = dict(
        qmatmul_int8.shapes)
    if "main_emb" not in STATE:
        STATE["main_emb"] = _bge_base_engine().encode_batch(texts)
    bf16 = STATE["main_emb"]
    cos = (emb * bf16).sum(-1) / (np.linalg.norm(emb, axis=1)
                                  * np.linalg.norm(bf16, axis=1))
    norms = np.linalg.norm(emb, axis=1)
    dup = (emb[:8] * emb[-8:]).sum(-1)
    routes = dict(qmatmul_int8.routes)
    emit("int8_path", sentences=len(texts), forwards=n_forwards,
         wall_s=wall, launches=counts, k3_routes=routes,
         k3_per_forward=counts["K3"] / n_forwards,
         k2_per_forward=counts["K2"] / n_forwards,
         int8_vs_bf16_min_cos=float(cos.min()),
         int8_vs_bf16_mean_cos=float(cos.mean()),
         norm_min=float(norms.min()), norm_max=float(norms.max()),
         identical_min_cos=float(dup.min()))
    check(np.isfinite(emb).all() and emb.shape == (len(texts), E),
          "int8 path output not finite / wrong shape")
    check(counts == only(K2=12 * n_forwards, K3=48 * n_forwards,
                         K3_rows=48 * n_forwards),
          f"int8 launches {counts} over {n_forwards} forwards")
    check(sum(routes.values()) == 48 * n_forwards,
          f"int8 K3 routes {routes} over {n_forwards} forwards")
    check(np.abs(norms - 1).max() < 1e-3, "int8: not unit norm")
    check(dup.min() >= 1 - 1e-6, "int8: identical sentences differ")
    check(cos.min() >= 0.99, f"int8 vs bf16 kernel path: {cos.min()}")
    STATE["engine8"], STATE["int8_emb"] = eng8, (texts, emb)
    _check_tcp("int8_server", eng8)


def chain_want(links, scores: bool, n: int) -> dict:
    """The launches of n bge-base int8 forwards (NL layers) under a link
    subset: 4 K3 and one K2 a layer as unchained; K3x on qkv and up with
    "ln", on o-proj with "attn", on down with "ffn", and a row
    quantization on every other K3; K3e "both" on o-proj and down with
    "ln", "only" on up with "ffn"; K2e "only" with "attn"; K2i8 with int8
    scores; one quantize_act (the embedding output) with "ln"."""
    ln, attn, ffn = ("ln" in links), ("attn" in links), ("ffn" in links)
    x8 = NL * (2 * ln + attn + ffn)
    per = {"K3": 4 * NL, "K2": NL, "K3x": x8, "K3_rows": 4 * NL - x8,
           "K3e_both": 2 * NL * ln, "K3e_only": NL * ffn,
           "K2e_only": NL * attn, "K2i8": NL * scores,
           "quantize_act": int(ln)}
    return only(**{k: v * n for k, v in per.items()})


def phase_int8_chain_path():
    """The chained int8 forward of bge-base (int8_compute) through
    Engine.encode_batch under each of the 8 link subsets, with int8
    scores off and on: exact launch counts per subset (chain_want), unit
    norms, cosine >= 0.999 against the unchained int8 path (the JAX
    package's bar for the chain); TCP answers equal Engine.encode with
    every link on; the packed int8 forward with the "attn" link (12 K4e
    a forward). Every attention launch takes its route: K2, K2e and K2i8
    the Hopper library ("sm90"); K4e "sm90". The defaults stay off: no
    links, scores "off"."""
    import torch
    from embeddings_tpu_torch.ops.attention import fused_attention, \
        int8_scores_mode
    from embeddings_tpu_torch.ops.linear import active_chain_links, \
        chain_links
    from embeddings_tpu_torch.ops.qmatmul import qmatmul_int8
    check(active_chain_links() == frozenset(), "chain links on by default")
    eng8 = STATE.setdefault("engine8", STATE.get("engine8")
                            or _bge_base_engine(int8_compute=True))
    if "int8_emb" not in STATE:
        texts = _sts_sentences(300)
        STATE["int8_emb"] = (texts + texts[:8],
                             eng8.encode_batch(texts + texts[:8]))
    texts, base = STATE["int8_emb"]
    n = n_bucketed_forwards(eng8, texts)
    out = {}
    for links in LINK_SUBSETS:
        for scores in (False, True):
            with chain_links(links), \
                    int8_scores_mode("on" if scores else "off"):
                reset_counts()
                t0 = time.perf_counter()
                emb, routes = _routed(fused_attention,
                                      lambda: eng8.encode_batch(texts))
                wall = time.perf_counter() - t0
                counts = read_counts()
            cos = _row_cos(emb, base)
            norms = np.linalg.norm(emb, axis=1)
            key = "+".join(links) or "none"
            key += "/scores_on" if scores else ""
            want = chain_want(links, scores, n)
            out[key] = dict(launches=counts, k2_routes=routes, wall_s=wall,
                            vs_unchained_min_cos=float(cos.min()),
                            norm_min=float(norms.min()),
                            norm_max=float(norms.max()))
            check(np.isfinite(emb).all() and emb.shape == (len(texts), E),
                  f"chain {key}: output not finite / wrong shape")
            check(counts == want, f"chain {key}: launches {counts}, "
                  f"expected {want}")
            check(routes == {"sm90": NL * n},
                  f"chain {key}: K2 launches by route {routes}")
            check(np.abs(norms - 1).max() < 1e-3, f"chain {key}: not unit "
                  f"norm")
            check(cos.min() >= 0.999, f"chain {key} vs unchained int8: "
                  f"{cos.min()}")
            if scores and not links:
                STATE["launches_K2i8"] = counts["K2i8"] // n
            if links == LINK_SUBSETS[-1] and not scores:
                # the kernel table's launches: this run's, per forward
                modes = {k: v / n for k, v in qmatmul_int8.modes.items()}
                want_modes = {(E, 3 * E, "bias", "no", True): NL,
                              (E, E, "bias_residual_ln", "both", True): NL,
                              (E, F, "bias_gelu", "only", True): NL,
                              (F, E, "bias_residual_ln", "both", True): NL}
                check(modes == want_modes, f"chain {key}: K3 launches by "
                      f"shape and mode {modes}, expected {want_modes}")
                STATE["chain_all"] = (
                    {k: v // n for k, v in counts.items()},
                    {k: int(v) for k, v in modes.items()})
    with chain_links(("attn", "ln", "ffn")):
        _check_tcp("int8_chain_server", eng8)
    out["packed_attn"] = _packed_chain(eng8)
    emit("int8_chain_path", forwards_per_run=n, sentences=len(texts),
         subsets=out)


def _packed_chain(eng8) -> dict:
    """The packed int8 forward (256 rows of 128 tokens) with the "attn"
    link: 48 K3 (12 of them K3x, the o-projection) and 12 K4 emitting
    "only" a forward (bge's 12 layers), against the same forward
    unchained."""
    from embeddings_tpu_torch.ops.attention import fused_attention_segmented
    from embeddings_tpu_torch.ops.linear import chain_links
    texts = _sts_sentences(2400)
    base = eng8.encode_batch_packed(texts, row_len=PACK_SHORT[1])
    calls = []
    run = eng8._forward_packed

    def spy(*a, **k):
        calls.append(1)
        return run(*a, **k)
    eng8._forward_packed = spy
    try:
        with chain_links(("attn",)):
            reset_counts()
            emb, routes = _routed(
                fused_attention_segmented,
                lambda: eng8.encode_batch_packed(texts,
                                                 row_len=PACK_SHORT[1]))
            counts = read_counts()
    finally:
        del eng8._forward_packed
    n = len(calls)
    cos = _row_cos(emb, base)
    want = only(K3=4 * NL * n, K3x=NL * n, K3_rows=3 * NL * n, K4=NL * n,
                K4e_only=NL * n)
    check(n >= 1 and counts == want, f"packed chain: launches {counts}, "
          f"expected {want}")
    check(routes == {"sm90": NL * n}, f"packed chain: K4e launches by "
          f"route {routes}")
    check(np.isfinite(emb).all() and cos.min() >= 0.999,
          f"packed chain vs unchained: {cos.min()}")
    STATE["launches_K4e"] = counts["K4e_only"] // n
    return dict(packed_forwards=n, launches=counts, k4_routes=routes,
                vs_unchained_min_cos=float(cos.min()))


def phase_packed_path():
    """Token-packed encode: K4 at the default row_len 128 and K5 (window
    3) at row_len 1024 (both on the Hopper kernel: their launches counted
    by route), sentences past row_len handed to the bucketed path, and
    BatchingService(packed=True) over TCP."""
    import torch
    from embeddings_tpu_torch.ops import attention as A
    eng = STATE.get("engine") or _bge_base_engine()
    short = _sts_sentences(2400)
    # at row_len 128, two texts longer than 128 tokens go to the bucketed
    # path (at 1024 they would widen the window past 3 key blocks)
    texts = short + [" ".join(short[i:i + 30]) for i in (0, 100)]
    ref = eng.encode_batch(texts)
    windows = []
    run = eng._forward_packed

    def spy(ids, seg, pos, pool, attn_window=0):
        windows.append((list(ids.shape), attn_window))
        return run(ids, seg, pos, pool, attn_window)

    eng._forward_packed = spy
    out = {}
    try:
        for name, row_len, rows, txt in (("row128", 128, None, texts),
                                         ("row1024", 1024, 32, short)):
            windows.clear()
            long_txt = [t for t in txt if len(eng.tokenize(t)) > row_len]
            n_long = n_bucketed_forwards(eng, long_txt) if long_txt else 0
            reset_counts()
            t0 = time.perf_counter()
            emb = eng.encode_batch_packed(txt, row_len=row_len,
                                          batch_rows=rows)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            kattn = "K4" if row_len == 128 else "K5"
            routes = dict((A.fused_attention_segmented if kattn == "K4" else
                           A.fused_attention_segmented_blockskip).routes)
            n = len(windows)
            cos = (emb * ref[:len(txt)]).sum(-1)
            out[name] = dict(
                sentences=len(txt), packed_forwards=n,
                shapes=[w[0] for w in windows],
                windows=[w[1] for w in windows], bucketed_forwards=n_long,
                launches=counts, attention_routes=routes, wall_s=wall,
                packed_vs_bucketed_min_cos=float(cos.min()))
            STATE.setdefault("launches", {})[kattn] = counts[kattn]
            want = only(K1=48 * (n + n_long), K2=12 * n_long,
                        **{kattn: 12 * n})
            check(n >= 1 and counts == want,
                  f"packed {name}: launches {counts}, expected {want}")
            # every K4 / K5 launch on the Hopper kernel
            check(routes == {"sm90": 12 * n}, f"packed {name}: {kattn} "
                  f"launches by route {routes}, expected {12 * n} sm90")
            if kattn == "K5":
                check(all(w[1] == 3 for w in windows),
                      f"packed row1024 windows {windows}, expected 3")
            check(np.isfinite(emb).all() and cos.min() >= 0.999,
                  f"packed {name} vs bucketed: min cos {cos.min()}")
    finally:
        del eng._forward_packed  # back to the class method
    out["tcp"] = _packed_tcp(eng, texts[:16], ref[:16])
    emit("packed_path", **out)


def _packed_tcp(eng, texts, ref) -> dict:
    """16 concurrent connections to serve_tcp over
    BatchingService(packed=True): one batch of 8 or more runs packed."""
    import concurrent.futures
    from embeddings_tpu_torch.runtime.client import TcpClient
    from embeddings_tpu_torch.runtime.server import BatchingService, \
        serve_tcp

    async def run():
        service = BatchingService(eng, packed=True, max_wait_ms=500)
        server, _ = await serve_tcp(service, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]

        def one(t):
            with TcpClient("127.0.0.1", port, timeout=120) as c:
                return c.embed(t)

        def clients():
            with concurrent.futures.ThreadPoolExecutor(len(texts)) as ex:
                return list(ex.map(one, texts))
        try:
            return await asyncio.to_thread(clients), service.stats.as_dict()
        finally:
            server.close()
            await server.wait_closed()
            await service.stop()

    from embeddings_tpu_torch.ops.attention import fused_attention_segmented
    reset_counts()
    answers, stats = asyncio.run(run())
    counts = read_counts()
    routes = dict(fused_attention_segmented.routes)
    cos = (np.stack(answers) * ref).sum(-1)
    r = dict(requests=len(texts), batches=stats["batches"], launches=counts,
             k4_routes=routes, min_cos_vs_bucketed=float(cos.min()))
    check(counts["K4"] > 0 and cos.min() >= 0.999
          and routes == {"sm90": counts["K4"]},
          f"packed TCP: {r} (no packed batch ran, a K4 launch off the "
          f"Hopper kernel, or answers differ)")
    return r


# ---------------------------------------------------------------------------
# the logit-bias families (K6, K7)
# ---------------------------------------------------------------------------

def _attn_qkv(rng, Bx: int, Lx: int, dev, ragged: bool = True,
              Ex: int = E):
    """Unit-normal bf16 qkv [Bx*Lx, 3Ex] and int32 lengths: ragged (an
    all-pad row first, a full row last) or every row full."""
    import torch
    qkv = torch.from_numpy(rng.standard_normal(
        (Bx * Lx, 3 * Ex), dtype=np.float32)).to(dev, torch.bfloat16)
    lens = np.full(Bx, Lx)
    if ragged:
        lens = rng.integers(1, Lx + 1, Bx)
        lens[0], lens[-1] = 0, Lx
    return qkv, torch.tensor(lens.tolist(), dtype=torch.int32, device=dev)


def _family_bias(family: str, Lx: int, dev):
    """The [1, H, L, L] f32 logit bias of the family at 0..L-1: MPNet's
    bucketed table (random, numpy seed 6, unit scale) or ALiBi."""
    import torch
    from embeddings_tpu_torch import BertConfig
    from embeddings_tpu_torch.models import bert
    from embeddings_tpu_torch.ops.alibi import alibi_slopes
    pos = torch.arange(Lx, device=dev)[None]
    if family == "mpnet":
        table = torch.from_numpy(np.random.default_rng(6).standard_normal(
            (32, H), dtype=np.float32)).to(dev)
        return bert.relative_attention_bias(
            table, pos, BertConfig(relative_attention_num_buckets=32))
    return bert.alibi_attention_bias(
        torch.tensor(alibi_slopes(H), dtype=torch.float32, device=dev), pos)


def _slopes(dev):
    import torch
    from embeddings_tpu_torch.ops.alibi import alibi_slopes
    return torch.tensor(alibi_slopes(H), dtype=torch.float32, device=dev)


def phase_k6k7():
    """K7 (mode 3 of the Hopper kernel) at the MPNet shape (table bias)
    and at jina's L=1024 (ALiBi bias), and at the Hopper tiles' edges:
    L=200 (ragged, under two 128-row query blocks) and L=384, lengths
    0, 1, 63, 64, 65, 127, 128, 129 and L, both biases, D = 32, 64 and
    128, and one warpgroup's rows (L=48); K6 plain at L=2048, with
    in-kernel ALiBi at B=4, L=8192, and plain at Qwen2's D=128, B=4,
    L=4096, and each K6 mode at L=384 with lengths on the tile edges; each
    against its plain version on the same inputs."""
    import torch
    from embeddings_tpu_torch.ops import attention as A
    rng = np.random.default_rng(7)
    dev = torch.device("cuda")
    out = {}
    k7_cases = [("K7_mpnet", "mpnet", MPNET_SHAPE, D, None),
                ("K7_alibi", "jina", JINA_SHORT, D, None)]
    for Lx in (200, 384, 48):
        edges = [min(n, Lx) for n in TILE_EDGES] + [Lx]
        for family in ("mpnet", "jina"):
            for Dx in ((32, 64, 128) if Lx == 384 else (D,)):
                k7_cases.append((f"K7_{family}_edges_L{Lx}_D{Dx}", family,
                                 (len(edges), Lx), Dx, edges))
    for name, family, (Bx, Lx), Dx, lengths in k7_cases:
        qkv, lens = _attn_qkv(rng, Bx, Lx, dev, Ex=H * Dx)
        if lengths is not None:
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        bias = A.prepare_attention_bias(_family_bias(family, Lx, dev), Lx)
        kw = dict(B=Bx, L=Lx, H=H, D=Dx)
        got = A.fused_attention_bias(qkv, lens, bias, **kw)
        ref = A.fused_attention_bias_ref(qkv, lens, bias, **kw)
        torch.cuda.synchronize()
        out[name] = dict(compare(got, ref, K2_RTOL, K2_ATOL_RMS),
                         shape=[Bx, Lx, H, Dx])
        zero = [b for b in range(Bx) if int(lens[b]) == 0]
        out[name]["zero_rows_exact"] = all(
            bool((got.reshape(Bx, Lx, -1)[b] == 0).all()) for b in zero)
        check(out[name]["zero_rows_exact"], f"{name}: a len-0 row is not 0")
        del ref
    edges = [min(n, 384) for n in TILE_EDGES] + [384]
    for name, slopes, (Bx, Lx), (Hx, Dx), lengths in (
            ("K6_plain", None, BERT_LONG, (H, D), None),
            ("K6_alibi", _slopes(dev), JINA_LONG, (H, D), None),
            ("K6_plain_D128", None, QW_LONG, (QW_H, QW_D), None),
            ("K6_plain_edges", None, (len(edges), 384), (H, D), edges),
            ("K6_alibi_edges", _slopes(dev), (len(edges), 384), (H, D),
             edges),
            ("K6_plain_D128_edges", None, (len(edges), 384), (QW_H, QW_D),
             edges)):
        qkv, lens = _attn_qkv(rng, Bx, Lx, dev, Ex=Hx * Dx)
        if lengths is not None:
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        kw = dict(B=Bx, L=Lx, H=Hx, D=Dx, BK=A.pick_bk(Lx),
                  alibi_slopes=slopes)
        got = A.fused_attention_stream(qkv, lens, **kw)
        ref = A.fused_attention_stream_ref(qkv, lens, **kw)
        torch.cuda.synchronize()
        out[name] = dict(compare(got, ref, K2_RTOL, K2_ATOL_RMS),
                         shape=[Bx, Lx, Hx, Dx], BK=kw["BK"])
        del ref
    for name, r in out.items():
        check(r["ok"], f"{name} disagrees: {r}")
    emit("k6k7_parity", tolerance=f"|err| <= {K2_RTOL}*|ref| + "
         f"{K2_ATOL_RMS}*rms(ref)", routes=fused_attention_routes(),
         k7_routes=bias_routes(), **out)


def phase_attn_tp():
    """The attention kernels at the shard shapes ``tp_path`` launches
    (H/tp local heads, q, k and v of the shard concatenated), each against
    its plain version on the same inputs: K2 on 6 heads (tp = 2) and 3
    heads (tp = 4, rows 192 wide) at B=32, L=512 (bge, int8), and on 6
    heads at B=4, L=256 (nomic-embed-text-v2-moe); K4 on 6 heads at 64
    packed rows of 128 (packed at 2 x 2); K7 on 6 heads at B=32, L=256
    with each shard's [6, L, L] half of MPNet's bias. Every case has
    lengths on the Hopper tiles' edges and an all-pad row (exactly 0)."""
    import torch
    from embeddings_tpu_torch.ops import attention as A
    rng = np.random.default_rng(19)
    dev = torch.device("cuda")
    out = {}

    def lengths(Bx: int, Lx: int) -> list:
        lens = rng.integers(1, Lx + 1, Bx)
        edges = [min(n, Lx) for n in TILE_EDGES] + [Lx]
        lens[:len(edges)] = edges
        return lens.tolist()

    (Bt, Lt), (Bo, Lo) = TP_SHAPE, TP_MOE
    for name, (Bx, Lx), Hx in (("K2_6heads", (Bt, Lt), H // 2),
                               ("K2_3heads", (Bt, Lt), H // 4),
                               ("K2_6heads_moe", (Bo, Lo), H // 2)):
        lens = lengths(Bx, Lx) if Bx > len(TILE_EDGES) else \
            [0, 1, 129, Lx][:Bx]
        r, routes = _routed(A.fused_attention, lambda: _k2_case(
            rng, Bx, Lx, lens, dev, Hx=Hx))
        check(r["ok"] and r["zero_rows_exact"] and routes == {"sm90": 1},
              f"{name} disagrees: {r}, routes {routes}")
        out[name] = dict(r, shape=[Bx, Lx, Hx, D], routes=routes)
    # K4: the packed forward's rows, every shard's 6 heads
    arrays, _ = packed_tables(64, 128)
    seg = torch.from_numpy(arrays[1]).to(dev)
    Hx = H // 2
    qkv = torch.from_numpy(rng.standard_normal(
        (64 * 128, 3 * Hx * D), dtype=np.float32)).to(dev, torch.bfloat16)
    kw = dict(B=64, L=128, H=Hx, D=D)
    got, routes = _routed(A.fused_attention_segmented,
                          lambda: A.fused_attention_segmented(qkv, seg, **kw))
    ref = A.fused_attention_segmented_ref(qkv, seg, **kw)
    r = compare(got, ref, K2_RTOL, K2_ATOL_RMS)
    pad = seg.reshape(-1) < 0
    r.update(shape=[64, 128, Hx, D], routes=routes,
             pad_rows_exact_zero=bool((got[pad] == 0).all()),
             all_pad_rows=int((seg < 0).all(1).sum()))
    check(r["ok"] and r["pad_rows_exact_zero"] and r["all_pad_rows"]
          and routes == {"sm90": 1}, f"K4_6heads disagrees: {r}")
    out["K4_6heads"] = r
    # K7: MPNet's bias, each shard's half of the heads
    Bm, Lm = TP_MPNET
    full = _family_bias("mpnet", Lm, dev)
    for j in range(2):
        bias = A.prepare_attention_bias(full[:, j * Hx:(j + 1) * Hx], Lm)
        qkv, _ = _attn_qkv(rng, Bm, Lm, dev, Ex=Hx * D)
        lens = torch.tensor(lengths(Bm, Lm), dtype=torch.int32, device=dev)
        kw = dict(B=Bm, L=Lm, H=Hx, D=D)
        got, routes = _routed(A.fused_attention_bias, lambda: (
            A.fused_attention_bias(qkv, lens, bias, **kw)))
        ref = A.fused_attention_bias_ref(qkv, lens, bias, **kw)
        r = dict(compare(got, ref, K2_RTOL, K2_ATOL_RMS),
                 shape=[Bm, Lm, Hx, D], bias=list(bias.shape), routes=routes)
        r["zero_rows_exact"] = bool((got.reshape(Bm, Lm, -1)[0] == 0).all())
        check(r["ok"] and r["zero_rows_exact"] and routes == {"sm90": 1},
              f"K7_6heads_shard{j} disagrees: {r}")
        out[f"K7_6heads_shard{j}"] = r
    emit("attn_tp_parity", tolerance=f"|err| <= {K2_RTOL}*|ref| + "
         f"{K2_ATOL_RMS}*rms(ref); len-0 rows and pad query rows exactly "
         f"0", **out)


def band_pairs(lengths, Lx: int, window: int) -> int:
    """(query, key) pairs banded attention needs on this data: both
    inside the row's length and |i - j| <= window // 2."""
    w = window // 2
    total = 0
    for n in lengths:
        i = np.arange(int(n))
        total += int((np.minimum(i + w, n - 1) - np.maximum(i - w, 0)
                      + 1).sum())
    return total


def band_tiles_walked(lengths, Lx: int, window: int) -> int:
    """128-key tiles K6w's 128-row query blocks walk a head on this data
    (``ops.attention.band_tiles``, the kernel's arithmetic)."""
    from embeddings_tpu_torch.ops import attention as A
    W = A.band_half(window, Lx)
    return sum(A.band_tiles(q0, 128, W, int(n))[1] for n in lengths
               for q0 in range(0, Lx, 128))


def phase_k6w():
    """K6w (banded attention, ModernBERT's local layers; mode 6 of the
    Hopper attention kernel) at the path's two shapes with window 128,
    and at small shapes around its walk's edges (a window of 8, the band
    covering the row, L=384 where the TPU walks every key block): ragged
    rows with an all-pad row first, against its plain version on the
    same inputs, at K2's tolerance on the query rows the model reads;
    each launch on the "sm90" route."""
    import torch
    from embeddings_tpu_torch.ops import attention as A
    rng = np.random.default_rng(9)
    dev = torch.device("cuda")
    out = {}
    for name, (Bx, Lx), window in (("short", MB_SHORT, MB_WINDOW),
                                   ("long", MB_LONG, MB_WINDOW),
                                   ("L384_w128", (4, 384), MB_WINDOW),
                                   ("L512_w8", (4, 512), 8),
                                   ("L256_w1024", (4, 256), 1024)):
        qkv, lens = _attn_qkv(rng, Bx, Lx, dev)
        kw = dict(B=Bx, L=Lx, H=H, D=D, window=window)
        got, routes = _routed(A.fused_attention_window,
                              lambda: A.fused_attention_window(qkv, lens,
                                                               **kw))
        ref = A.fused_attention_window_ref(qkv, lens, **kw)
        torch.cuda.synchronize()
        # query rows i < len[b] carry the model; a pad query attends the
        # few keys in [i - w/2, len[b]) and is never read, and there one
        # bf16 flip of a probability (the two sum the scores in other
        # orders) moves the output by up to 2^-8 of a key's value
        i = torch.arange(Lx, device=dev)[None, :]
        real = (i < lens[:, None]).reshape(-1)
        none = (i >= lens[:, None] + window // 2).reshape(-1)
        r = dict(compare(got[real], ref[real], K2_RTOL, K2_ATOL_RMS),
                 shape=[Bx, Lx, H, D], window=window,
                 pad_rows_max_abs_err=(got[~real].float()
                                       - ref[~real].float()).abs().max()
                 .item(),
                 out_of_reach_rows_exact_zero=bool((got[none] == 0).all()),
                 zero_row_exact=bool((got.reshape(Bx, Lx, E)[0] == 0).all()),
                 tiles_walked=band_tiles_walked(lens.tolist(), Lx, window),
                 routes=routes)
        check(r["ok"] and r["zero_row_exact"]
              and r["out_of_reach_rows_exact_zero"]
              and bool(torch.isfinite(got).all()) and routes == {"sm90": 1},
              f"K6w {name} disagrees: {r}")
        out[name] = r
        del ref
    emit("k6w_parity", tolerance=f"|err| <= {K2_RTOL}*|ref| + "
         f"{K2_ATOL_RMS}*rms(ref) on query rows i < len; pad query rows "
         f"finite, exactly 0 past len + window/2 and on len-0 rows", **out)


def causal_compare(got, ref, qkv, lens, Bx, Lx, Hx, Dx, dv=None) -> dict:
    """K6c against its plain version. Query row i of sequence b sees
    min(i + 1, len[b]) keys. Rows that see 64 keys or more: K2's
    tolerance. Rows that see 1-63 (the first rows of every sequence, read
    by the next layer): K2's tolerance plus one bf16 flip of one
    probability p_j, which moves the output by at most 2^-7 * p_j / sum(p)
    * |v_j - out| <= 2^-6 * max|v| over those keys (an output near a
    bf16 rounding boundary of exp2 in one version and not the other; the
    two sum the scores in other orders). Rows that see no key: exactly
    0. ``dv``: the value heads' width where it is not q's and k's (MLA)."""
    import torch
    dv = dv or Dx
    i = torch.arange(Lx, device=got.device)
    nkeys = torch.minimum(i[None, :] + 1, lens[:, None].long()).reshape(-1)
    v = qkv.float().reshape(Bx, Lx, -1)[:, :64, 2 * Hx * Dx:]
    vmax = v.reshape(Bx, -1, Hx, dv).abs().amax(dim=(1, 3))      # [B, H]
    flip = (2.0 ** -6 * vmax)[:, None, :, None].expand(
        Bx, Lx, Hx, dv).reshape(Bx * Lx, Hx * dv)
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    tol = K2_RTOL * r.abs() + K2_ATOL_RMS * r.square().mean().sqrt()
    few = (nkeys > 0) & (nkeys < 64)
    many = nkeys >= 64
    beyond_k2 = (err[few] > tol[few]).any(-1)
    out = {
        "max_abs_err": err.max().item(),
        "max_abs_err_64plus_keys": err[many].max().item()
        if many.any() else 0.0,
        "max_abs_err_few_keys": err[few].max().item() if few.any() else 0.0,
        "few_key_rows": int(few.sum()),
        "few_key_rows_past_k2_tolerance": int(beyond_k2.sum()),
        "zero_rows_exact": bool((got[nkeys == 0] == 0).all()),
        "ok": bool(torch.isfinite(g).all()
                   and (err[many] <= tol[many]).all()
                   and (err[few] <= tol[few] + flip[few]).all())}
    return out


def phase_k6c():
    """K6c (causal attention, the Qwen2 decoder embedders) against its
    plain version: Qwen2's two shapes (D=128: B=4, L=4096 with full and
    partial rows, B=32, L=512 ragged with an all-pad row), a short shape
    with len-0 and len-1 rows, D=64, and lengths on the Hopper kernel's
    tile edges at L=384 (``causal_compare``'s tolerance)."""
    import torch
    from embeddings_tpu_torch.ops import attention as A
    rng = np.random.default_rng(10)
    dev = torch.device("cuda")
    out = {}
    for name, (Bx, Lx), (Hx, Dx), lengths in (
            ("qwen2_long", QW_LONG, (QW_H, QW_D),
             [4096, 4096 - 37, 1000, 4096]),
            ("qwen2_short", QW_SHORT, (QW_H, QW_D), None),
            ("short_len0", (4, 256), (QW_H, QW_D), [256, 219, 1, 0]),
            ("D64", (4, 1024), (H, D), [1024, 987, 1, 0]),
            ("edges_D128", (9, 384), (QW_H, QW_D), list(TILE_EDGES) + [384]),
            ("edges_D64", (9, 384), (H, D), list(TILE_EDGES) + [384])):
        qkv, lens = _attn_qkv(rng, Bx, Lx, dev, Ex=Hx * Dx)
        if lengths is not None:
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        kw = dict(B=Bx, L=Lx, H=Hx, D=Dx, BK=A.pick_bk(Lx), causal=True)
        got = A.fused_attention_stream(qkv, lens, **kw)
        ref = A.fused_attention_stream_ref(qkv, lens, **kw)
        torch.cuda.synchronize()
        r = dict(causal_compare(got, ref, qkv, lens, Bx, Lx, Hx, Dx),
                 shape=[Bx, Lx, Hx, Dx], BK=kw["BK"])
        check(r["ok"] and r["zero_rows_exact"], f"K6c {name} disagrees: {r}")
        out[name] = r
        del ref
    emit("k6c_parity", routes=fused_attention_routes(),
         tolerance=f"|err| <= {K2_RTOL}*|ref| + "
         f"{K2_ATOL_RMS}*rms(ref) on query rows that see >= 64 keys; "
         f"+ 2^-6 * max|v| of the keys on rows that see 1-63; rows that "
         f"see none exactly 0", **out)


def emit_compare(got, ref, emit: str) -> dict:
    """A matmul emission (K1e / K3e) against its plain version: the bf16
    output (with "both") at K1's tolerance, the codes within
    EMIT_CODE_STEPS (the count of codes one step off stated), the row
    scales within EMIT_SCALE_RTOL."""
    import torch
    torch.cuda.synchronize()
    out, o8, so = got if emit == "both" else (None, *got)
    rout, ro8, rso = ref if emit == "both" else (None, *ref)
    d = (o8.int() - ro8.int()).abs()
    srel = ((so - rso).abs() / rso).max().item()
    r = {"max_code_diff": int(d.max()), "codes_one_step_off": int((d == 1)
                                                                  .sum()),
         "codes": d.numel(), "scale_max_rel_err": srel,
         "scales_finite": bool(torch.isfinite(so).all())}
    ok = (r["max_code_diff"] <= EMIT_CODE_STEPS and srel <= EMIT_SCALE_RTOL
          and r["scales_finite"] and tuple(so.shape) == (o8.shape[0], 1))
    if out is not None:
        r["out"] = compare(out, rout, K1_RTOL, K1_ATOL_RMS)
        ok = ok and r["out"]["ok"]
        r["max_abs_err"] = r["out"]["max_abs_err"]
    else:
        r["max_abs_err"] = (o8.float() * so - ro8.float() * rso).abs().max() \
            .item()
    r["ok"] = ok
    return r


def phase_emit():
    """K1e and K3e (the emission epilogue) at the chained links' shapes —
    o-proj and FFN-down with residual + LayerNorm emitting "both", FFN-up
    with GELU emitting "only" at N=3,072 and at N=4,096 — and K3x (int8 x
    with its row scales, no row quantization) at bge's four shapes and
    with emission, each against its plain version on the same inputs;
    then small ragged-M cases over the kinds and epilogues."""
    import torch
    from embeddings_tpu_torch.ops.qmatmul import EPILOGUES, qmatmul, \
        qmatmul_int8_ref, qmatmul_ref, quantize_rows
    rng = np.random.default_rng(11)
    dev = torch.device("cuda")
    out = {}
    for name, (K, N, epi, how) in EMIT_SHAPES.items():
        args, kw, _ = k1_inputs(rng, M, K, N, "q4_0", True, epi, dev)
        a = list(args.values())
        k1e = emit_compare(qmatmul(*a, emit_quantized=how, **kw),
                                qmatmul_ref(*a, emit_quantized=how, **kw),
                                how)
        k3e = emit_compare(
            qmatmul(*a, int8_compute=True, emit_quantized=how, **kw),
            qmatmul_int8_ref(*a, emit_quantized=how, **kw), how)
        q8, sx = quantize_rows(a[0])
        x8 = [q8] + a[1:]
        k3xe = emit_compare(
            qmatmul(*x8, int8_compute=True, x_scale=sx.reshape(M),
                    emit_quantized=how, **kw),
            qmatmul_int8_ref(*x8, x_scale=sx, emit_quantized=how, **kw),
            how)
        out[name] = {"K1e": k1e, "K3e": k3e, "K3x_K3e": k3xe}
        for k, r in out[name].items():
            check(r["ok"], f"{k} {name} disagrees: {r}")
    for name, (K, N, epi) in K1_SHAPES.items():
        args, kw, _ = k1_inputs(rng, M, K, N, "q4_0", True, epi, dev)
        a = list(args.values())
        q8, sx = quantize_rows(a[0])
        got = qmatmul(q8, *a[1:], int8_compute=True, x_scale=sx.reshape(M),
                      **kw)
        ref = qmatmul_int8_ref(q8, *a[1:], x_scale=sx, **kw)
        torch.cuda.synchronize()
        r = compare(got, ref, K3_RTOL, K3_ATOL_RMS)
        check(r["ok"], f"K3x {name} disagrees: {r}")
        out[f"K3x_{name}"] = r
    worst, n_small = 0.0, 0
    for kind, packed in (("q4_0", False), ("q4_1", True), ("q8_0", False),
                         ("nf4", True)):
        for epi in EPILOGUES:
            for how in ("both", "only"):
                # ragged M, N = 256 (two column tiles), K = 128
                args, kw, _ = k1_inputs(rng, 40, 128, 256, kind, packed, epi,
                                        dev)
                a = list(args.values())
                for mode, ref_fn in ((False, qmatmul_ref),
                                     (True, qmatmul_int8_ref)):
                    r = emit_compare(
                        qmatmul(*a, int8_compute=mode, emit_quantized=how,
                                **kw),
                        ref_fn(*a, emit_quantized=how, **kw), how)
                    check(r["ok"], f"emission {kind}/{epi}/{how} "
                          f"int8={mode} disagrees: {r}")
                    worst = max(worst, r["max_abs_err"])
                    n_small += 1
    emit("emit_parity", tolerance=f"bf16 output as K1; codes within "
         f"{EMIT_CODE_STEPS} step; scales rtol {EMIT_SCALE_RTOL}; K3x as K3",
         small_cases=n_small, small_worst_max_abs_err=worst, **out)


def attn_emit_compare(got, ref, emit: str) -> dict:
    """An attention emission (K2e / K4e, also with K2i8) against its plain
    version: the bf16 context (with "both") at K2's tolerance; the codes
    dequantized (o8 * so) within K2's tolerance of the plain version's
    plus one step of each, since the two contexts already differ by K2's
    tolerance before they are quantized; the scales at K2's tolerance.
    Beside it, the emission's own arithmetic: with "both" the codes and
    scales equal the plain quantization of the kernel's own bf16 context
    (``self_exact``), and the counts of codes one step off the plain
    version's and of rows whose scale is off by more than
    EMIT_SCALE_RTOL."""
    import torch
    from embeddings_tpu_torch.ops.attention import _emit_int8_rows
    out, o8, so = got if emit == "both" else (None, *got)
    rout, ro8, rso = ref if emit == "both" else (None, *ref)
    deq, rdeq = o8.float() * so, ro8.float() * rso
    err = (deq - rdeq).abs()
    rms = rdeq.square().mean().sqrt()
    tol = K2_RTOL * rdeq.abs() + K2_ATOL_RMS * rms + so + rso
    d = (o8.int() - ro8.int()).abs()
    srel = (so - rso).abs() / rso
    r = {"max_code_diff": int(d.max()),
         "codes_off": int((d > 0).sum()), "codes": d.numel(),
         "dequant_max_abs_err": err.max().item(),
         "scales": compare(so, rso, K2_RTOL, K2_ATOL_RMS),
         "scale_max_rel_err": srel.max().item(),
         "rows_scale_rel_over": int((srel > EMIT_SCALE_RTOL).sum()),
         "rows": int(so.numel())}
    ok = bool((err <= tol).all()) and r["scales"]["ok"] \
        and r["max_code_diff"] <= EMIT_CODE_STEPS
    if out is not None:
        r["out"] = compare(out, rout, K2_RTOL, K2_ATOL_RMS)
        r["out_at_K1_tolerance"] = compare(out, rout, K1_RTOL,
                                           K1_ATOL_RMS)["ok"]
        s8, ss = _emit_int8_rows(out.float())
        r["self_exact"] = bool(torch.equal(s8, o8) and torch.equal(ss, so))
        ok = ok and r["out"]["ok"] and r["self_exact"]
    r["max_abs_err"] = (r["out"] if out is not None else r)[
        "max_abs_err" if out is not None else "dequant_max_abs_err"]
    r["ok"] = ok
    return r


def _routed(wrapper, call):
    """call()'s result and the launches it added to ``wrapper.routes``, by
    route."""
    import torch
    before = dict(wrapper.routes)
    got = call()
    torch.cuda.synchronize()
    return got, {k: v - before.get(k, 0) for k, v in wrapper.routes.items()
                 if v != before.get(k, 0)}


def phase_attn_emit():
    """K2e and K4e (attention emission, "both" and "only", on the Hopper
    kernel) at the main path's shapes (B=128, L=256 with a len-0 and a
    full row; 256 packed rows of 128) and at a ragged one (B=16, L=200,
    H=16, D=128: two heads' more, the tile edge inside the row), each one
    launch on the "sm90" route; K2i8 (int8 scores, its own kernel in the
    Hopper library) at B=128, L=256 and at B=16, L=1,024, without
    emission and with "both" and "only", each one launch on the "sm90"
    route against its plain version; len-0 rows finite (K2i8 gives them
    the mean of v)."""
    import torch
    from embeddings_tpu_torch.ops import attention as A
    rng = np.random.default_rng(12)
    dev = torch.device("cuda")
    out = {}
    qkv, lens = _attn_qkv(rng, B, L, dev, Ex=E)
    kw = dict(B=B, L=L, H=H, D=D)
    rq, rl = _attn_qkv(rng, 16, 200, dev, Ex=16 * 128)
    rkw = dict(B=16, L=200, H=16, D=128)
    for name, (q2, l2, k2) in (("", (qkv, lens, kw)),
                               ("_ragged", (rq, rl, rkw))):
        for how in ("both", "only"):
            got, routes = _routed(A.fused_attention, lambda: A.fused_attention(
                q2, l2, emit_quantized=how, **k2))
            r = attn_emit_compare(
                got, A.fused_attention_ref(q2, l2, emit_quantized=how, **k2),
                how)
            r["routes"] = routes
            check(r["ok"] and routes == {"sm90": 1},
                  f"K2e {how}{name} disagrees: {r}")
            out[f"K2e_{how}{name}"] = r
    if "K4" not in STATE:
        phase_k4k5()
    pqkv, seg = STATE["K4"][0], STATE["K4"][1]
    pkw = dict(B=PACK_SHORT[0], L=PACK_SHORT[1], H=H, D=D)
    for how in ("both", "only"):
        got, routes = _routed(
            A.fused_attention_segmented, lambda: A.fused_attention_segmented(
                pqkv, seg, emit_quantized=how, **pkw))
        r = attn_emit_compare(
            got, A.fused_attention_segmented_ref(pqkv, seg,
                                                 emit_quantized=how, **pkw),
            how)
        r["routes"] = routes
        check(r["ok"] and routes == {"sm90": 1},
              f"K4e {how} disagrees: {r}")
        out[f"K4e_{how}"] = r
    for name, (Bx, Lx) in (("L256", (B, L)), ("L1024", I8S_LONG)):
        q2, l2 = ((qkv, lens) if Lx == L
                  else _attn_qkv(rng, Bx, Lx, dev, Ex=E))
        k2 = dict(B=Bx, L=Lx, H=H, D=D, int8_scores=True)
        got, routes = _routed(A.fused_attention,
                              lambda: A.fused_attention(q2, l2, **k2))
        ref = A.fused_attention_ref(q2, l2, **k2)
        torch.cuda.synchronize()
        r = compare(got, ref, K2_RTOL, K2_ATOL_RMS)
        r["routes"] = routes
        r["len0_rows_finite"] = bool(torch.isfinite(
            got.reshape(Bx, Lx, E)[0]).all())
        # the control: K2's bf16 softmax on the same rows must fail the
        # same check, or the check could not tell K2i8 from plain K2 (the
        # len-0 rows, 0 in K2 and the mean of v in K2i8, are left out)
        bf16 = A.fused_attention(q2, l2, B=Bx, L=Lx, H=H, D=D)
        seen = (l2 > 0).repeat_interleave(Lx)
        r["control_bf16_k2"] = compare(bf16[seen], ref[seen], K2_RTOL,
                                       K2_ATOL_RMS)
        r["vs_bf16_kernel_min_row_cos"] = compare(got, bf16, 0.0,
                                                  0.0)["min_row_cos"]
        check(r["ok"] and r["len0_rows_finite"] and routes == {"sm90": 1},
              f"K2i8 {name} disagrees: {r}")
        check(not r["control_bf16_k2"]["ok"], f"K2i8 {name}: the bf16 K2 "
              f"output passes the int8-scores check too: {r}")
        out[f"K2i8_{name}"] = r
        for how in ("both", "only"):
            got, routes = _routed(A.fused_attention, lambda: A.fused_attention(
                q2, l2, emit_quantized=how, **k2))
            e = attn_emit_compare(
                got, A.fused_attention_ref(q2, l2, emit_quantized=how, **k2),
                how)
            e["routes"] = routes
            check(e["ok"] and routes == {"sm90": 1},
                  f"K2i8 + K2e {how} {name} disagrees: {e}")
            out[f"K2i8_K2e_{how}_{name}"] = e
    STATE["attn_emit_inputs"] = (qkv, lens)
    emit("attn_emit_parity", tolerance=f"|err| <= {K2_RTOL}*|ref| + "
         f"{K2_ATOL_RMS}*rms(ref); codes dequantized within that plus one "
         f"step of each side, and within {EMIT_CODE_STEPS} step; \"both\": "
         f"codes and scales exactly those of the kernel's bf16 context", **out)


def phase_k6ca():
    """K6ca (causal attention with ALiBi: mode 8 of the streamed kernel, a
    causal jina-bert-v2) against its plain version at the jina path's
    shape (B=4, L=8,192, two rows full, two ragged), at short ragged
    rows (lengths 256, 219, 40, 1, 0: rows under one 64-key tile and an
    empty one) and at lengths on the Hopper kernel's tile edges (L=384),
    with ``causal_compare``'s tolerance (rows that see 1-63 keys may carry
    one bf16 probability flip)."""
    import torch
    from embeddings_tpu_torch.ops import attention as A
    rng = np.random.default_rng(12)
    dev = torch.device("cuda")
    out = {}
    for name, (Bx, Lx), lengths in (
            ("jina_long", JINA_LONG,
             [JINA_LONG[1], JINA_LONG[1] - 37, JINA_LONG[1] // 3,
              JINA_LONG[1]]),
            ("short_ragged", (5, 256), [256, 219, 40, 1, 0]),
            ("edges", (9, 384), list(TILE_EDGES) + [384])):
        qkv, _ = _attn_qkv(rng, Bx, Lx, dev)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        kw = dict(B=Bx, L=Lx, H=H, D=D, BK=A.pick_bk(Lx), causal=True,
                  alibi_slopes=_slopes(dev))
        got = A.fused_attention_stream(qkv, lens, **kw)
        ref = A.fused_attention_stream_ref(qkv, lens, **kw)
        torch.cuda.synchronize()
        r = dict(causal_compare(got, ref, qkv, lens, Bx, Lx, H, D),
                 shape=[Bx, Lx, H, D], BK=kw["BK"])
        check(r["ok"] and r["zero_rows_exact"], f"K6ca {name} disagrees: {r}")
        out[name] = r
        del ref
    emit("k6ca_parity", routes=fused_attention_routes(),
         tolerance=f"|err| <= {K2_RTOL}*|ref| + "
         f"{K2_ATOL_RMS}*rms(ref) on query rows that see >= 64 keys; "
         f"+ 2^-6 * max|v| of the keys on rows that see 1-63; rows that "
         f"see none exactly 0", **out)


def combine_inputs(dev, T: int, k: int, Dx: int, Ex: int, extras,
                   seed: int = 0):
    """A combine's bf16 inputs on the card: each token routed to k
    distinct experts of Ex (experts 2 and 5 never: no rows), weights on a
    1/8 grid (ties), rows [T*k, Dx] in expert order; ``extras`` names the
    optional operands to pass (down_b, bias, shared). Returns (y, top_w,
    experts, order, operands)."""
    import torch
    rng = np.random.default_rng(seed)
    live = torch.tensor([e for e in range(Ex) if e not in (2, 5)],
                        device=dev)
    pick = torch.from_numpy(np.argsort(rng.random((T, len(live)),
                                                  dtype=np.float32), -1)
                            [:, :k]).to(dev)
    flat_e = live[pick].reshape(-1)
    top_w = torch.from_numpy(rng.integers(1, 8, (T, k)).astype(np.float32)
                             / 8).to(dev)
    order = torch.argsort(flat_e, stable=True)
    y = torch.randn(T * k, Dx, device=dev, dtype=torch.bfloat16)
    ops = {"down_b": torch.randn(Ex, Dx, device=dev) * 0.1,
           "bias": torch.randn(Dx, device=dev) * 0.1,
           "shared": torch.randn(T, Dx, device=dev, dtype=torch.bfloat16)}
    return y, top_w, flat_e, order, {n: ops[n] for n in extras}


def index_add_combine(y, top_w, experts, order, down_b=None, bias=None,
                      shared=None):
    """The chain of library ops ``ops.moe`` combined with before the
    hand-written combine (the kernel table's library yardstick): f32
    rows, the bias and the weights gathered through the sort, an atomic
    ``index_add_``, the bias, the shared expert, the cast."""
    import torch
    T, k = top_w.shape
    r = y.float()
    if down_b is not None:
        r = r + down_b.float()[experts[order]]
    r = r * top_w.reshape(-1)[order][:, None]
    out = torch.zeros(T, y.shape[1], dtype=torch.float32, device=y.device)
    out.index_add_(0, order // k, r)
    if bias is not None:
        out = out + bias.float()
    if shared is not None:
        out += shared.float()
    return out.to(y.dtype)


def phase_moe_combine():
    """The MoE combine (``ops.moe.combine_experts``,
    ``csrc/moe_combine.cu``) against its plain version at
    ``COMBINE_SHAPES``: within one bf16 step (the same rounded f32
    operations in the same order: bit for bit as written), two launches
    bit for bit (no atomics), one count a call; against the index_add_
    chain it replaced within 2^-7 relative + 2^-7 of the output's RMS
    (the atomics' f32 order)."""
    import torch
    from embeddings_tpu_torch.ops import moe as Mo
    dev = torch.device("cuda")
    out = {}
    for name, (T, k, Dx, Ex, extras) in COMBINE_SHAPES.items():
        y, w, e, order, kw = combine_inputs(dev, T, k, Dx, Ex, extras, T)
        n0 = Mo.moe_ffn_ragged.combines
        got = Mo.combine_experts(y, w, e, order, **kw)
        again = Mo.combine_experts(y, w, e, order, **kw)
        want = Mo._combine_plain(y, w, e, order, **kw)
        chain = index_add_combine(y, w, e, order, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        r = {"shape": [T, k, Dx], "experts": Ex, "operands": list(extras),
             "max_abs_err": err.max().item(),
             "within_one_step": bool(
                 (err <= 2 ** -7 * want.float().abs()).all()),
             "bit_equal_plain": bool(torch.equal(got, want)),
             "repeat_bit_equal": bool(torch.equal(got, again)),
             "launches": Mo.moe_ffn_ragged.combines - n0,
             "vs_index_add": compare(got, chain, 2 ** -7, 2 ** -7)}
        check(r["within_one_step"] and r["repeat_bit_equal"]
              and r["launches"] == 2 and r["vs_index_add"]["ok"],
              f"MoE combine {name} disagrees: {r}")
        out[name] = r
        del y, got, again, want, chain
    emit("moe_combine", parity=out, source=COMBINE_SOURCE)


def combine_rows(rng, dev) -> list:
    """The MoE combine's rows of the kernel table at ``COMBINE_SHAPES``'
    main-path shapes: the kernel and the index_add_ chain it replaced
    (the library yardstick) in alternating rounds, the plain version
    (f32, k gathers) by itself; the bound is bytes at 3.35 TB/s: the k
    rows, the shared row and the output of each token, the weights, the
    sort and (with the down bias) the experts, and the biases, each read
    or written once."""
    from embeddings_tpu_torch.ops import moe as Mo
    out = []
    for name, (T, k, Dx, Ex, extras) in COMBINE_SHAPES.items():
        if name.startswith("odd"):
            continue
        y, w, e, order, kw = combine_inputs(dev, T, k, Dx, Ex, extras,
                                            int(rng.integers(1 << 30)))
        s = y.element_size()
        nbytes = (T * k * Dx * s + T * Dx * s + T * k * (4 + 8)
                  + ("shared" in kw) * T * Dx * s
                  + ("down_b" in kw) * (T * k * 8 + Ex * Dx * 4)
                  + ("bias" in kw) * Dx * 4)
        bms, by = bound_ms(0.0, nbytes)
        t = alternating_ms({
            "kernel": lambda: Mo.combine_experts(y, w, e, order, **kw),
            "library": lambda: index_add_combine(y, w, e, order, **kw)})
        launches = STATE.get("combines_dsv2" if name.startswith("dsv2")
                             else "combines_nomic", 0)
        out.append({
            "name": f"combine_experts[T{T} k{k} D{Dx} "
                    f"{'+'.join(extras)}]", "route": "cuda",
            "source": COMBINE_SOURCE, "replaces": COMBINE_REPLACES,
            "launches": launches,
            "max_abs_err": RESULTS["moe_combine"]["parity"][name][
                "max_abs_err"],
            "ms": t["kernel"][0], "ms_range": t["kernel"][1],
            "plain_ms": cuda_ms(lambda: Mo._combine_plain(
                y, w, e, order, **kw), iters=3, warmup=1),
            "bound_ms": bms, "bound_by": by,
            "roofline_pct": 100 * bms / t["kernel"][0],
            "library_ms": t["library"][0],
            "library_ms_range": t["library"][1], "bytes": nbytes,
            "shape": [T, k, Dx]})
        del y, w, e, order, kw
    return out


def _dsv2_engine():
    """DeepSeek-V2-Lite at full width from the benchmark's configuration
    file, cut to ``DSV2_LAYERS`` layers, built as the cell builds it
    (``perfbench.program.build_engine``: q4_0 projections, the routed
    experts held in bf16) from its reference's HF-named random weights
    (seed 0, made on the card and copied to the host). Returns (engine,
    model block, the f32 weights on the card for the reference)."""
    import torch
    from perfbench import program, weights
    from perfbench.reference import deepseek_v2 as ref
    model = json.loads(DSV2_CONFIG.read_text())["model"]
    model["hf_config"]["num_hidden_layers"] = DSV2_LAYERS
    dev = torch.device("cuda")
    sd = weights.make(ref.checkpoint_spec(model["hf_config"]), 0, dev)
    eng = program.build_engine(
        model, {k: v.cpu().numpy() for k, v in sd.items()}, dev)
    return eng, model, sd


def phase_mla_path():
    """DeepSeek-V2-Lite on the card. K6c at MLA's widths against its
    plain version at the cell's buckets (``causal_compare``'s tolerance,
    ragged rows with an empty and a one-key row); the routed experts'
    grouped product (``ops.moe._grouped``) against one ``torch.mm`` an
    expert at a 1,024 bucket's rows (64 experts, two empty); then one
    main-path ``encode_toks`` of rows in every bucket at the cell's depth,
    the launch counters zeroed just before it: every layer's attention
    through the MLA kernel (``mla_launches``), no plain version, no MoE
    host read, three grouped products and one combine a MoE layer (11 a
    forward), and the embeddings against the plain reference in f32
    within the cell's limits; one forward's profile: the combine's two
    kernels 11 times each under ``moe_dispatch``, and no
    ``index_add_`` (``indexFuncLargeIndex``) there."""
    import torch
    from embeddings_tpu_torch.ops import attention as A, moe as Mo
    from perfbench import compare as bench_compare, program
    from perfbench.reference import deepseek_v2 as ref
    rng = np.random.default_rng(26)
    dev = torch.device("cuda")
    out, stream = {}, A.fused_attention_stream
    E = MLA_H * (2 * MLA_D + MLA_DV)
    scale = ref.softmax_scale(json.loads(DSV2_CONFIG.read_text())
                              ["model"]["hf_config"])
    for Bx, Lx in MLA_SHAPES:
        qkv = torch.from_numpy(rng.standard_normal(
            (Bx * Lx, E), dtype=np.float32)).to(dev, torch.bfloat16)
        lens = torch.tensor([Lx, Lx - 37, 1, 0, Lx // 2, 129, Lx - 1, 64],
                            dtype=torch.int32, device=dev)[:Bx]
        kw = dict(B=Bx, L=Lx, H=MLA_H, D=MLA_D, BK=A.pick_bk(Lx),
                  causal=True, dv=MLA_DV, scale=scale)
        got = stream(qkv, lens, **kw)
        want = A.fused_attention_stream_ref(qkv, lens, **kw)
        torch.cuda.synchronize()
        r = dict(causal_compare(got, want, qkv, lens, Bx, Lx, MLA_H, MLA_D,
                                MLA_DV), shape=[Bx, Lx, MLA_H, MLA_D, MLA_DV],
                 BK=kw["BK"])
        check(r["ok"] and r["zero_rows_exact"], f"MLA L={Lx} disagrees: {r}")
        out[f"L{Lx}"] = r
        del want
    # the grouped expert product at a 1,024 bucket's rows (B=8, top-6)
    counts = torch.from_numpy(rng.multinomial(
        DSV2_ROWS, np.full(DSV2_EXPERTS, 1 / DSV2_EXPERTS)))
    counts[[5, 40]] = 0
    a = torch.randn(int(counts.sum()), DSV2_HIDDEN, device=dev,
                    dtype=torch.bfloat16)
    w = torch.randn(DSV2_EXPERTS, DSV2_HIDDEN, DSV2_I, device=dev,
                    dtype=torch.bfloat16) * 0.02
    counts = counts.to(dev)
    grouped = Mo._grouped(counts, torch.bfloat16)
    rows = counts.tolist()

    def looped():
        return torch.cat([torch.mm(x, w[e])
                          for e, x in enumerate(a.split(rows))])
    gm = compare(grouped(a, w), looped(), 2.0 ** -7, 1e-3)
    check(gm["ok"], f"grouped expert product disagrees: {gm}")
    gm.update(rows=int(counts.sum()), experts=DSV2_EXPERTS,
              K=DSV2_HIDDEN, N=DSV2_I, **{k: v[0] for k, v in alternating_ms(
                  {"grouped_ms": lambda: grouped(a, w),
                   "per_expert_mm_ms": looped}).items()})
    del a, w
    # one main-path forward set, counted from zero
    eng, model, sd = _dsv2_engine()
    lo, hi = model["tokens"]["draw"]
    tok = model["tokens"]
    seqs = [[tok["cls"], *rng.integers(lo, hi, n - 2).tolist(), tok["sep"]]
            for n in DSV2_LENGTHS]
    eng.encode_toks(seqs[:2])  # the first call's set-up, not counted
    torch.cuda.synchronize()
    rec = program.ForwardRecorder(eng)
    stream.mla_launches = stream.causal_launches = stream.launches = 0
    reads, gemms = moe_counts()
    combines = Mo.moe_ffn_ragged.combines
    with plain_calls() as calls, rec.active():
        emb = eng.encode_toks(seqs)
        torch.cuda.synchronize()
    r2, g2 = moe_counts()
    launches = {"mla": stream.mla_launches, "K6c": stream.causal_launches,
                "K6": stream.launches, "moe_host_reads": r2 - reads,
                "expert_products": g2 - gemms,
                "combines": Mo.moe_ffn_ragged.combines - combines}
    n_fwd = len(rec.forwards)
    want = {"mla": n_fwd * DSV2_LAYERS, "K6c": n_fwd * DSV2_LAYERS,
            "K6": 0, "moe_host_reads": 0,
            "expert_products": 3 * n_fwd * (DSV2_LAYERS - 1),
            "combines": n_fwd * (DSV2_LAYERS - 1)}
    check(launches == want and not any(calls.values()),
          f"DeepSeek-V2 forward launched {launches}, want {want}; plain "
          f"calls {dict(calls)}")
    STATE["launches_mla"] = {f"L{f['L']}": DSV2_LAYERS
                             for f in rec.forwards}
    STATE["combines_dsv2"] = DSV2_LAYERS - 1
    # one forward (the 1,024 bucket's 8 rows) by the span of each kernel
    dispatch = moe_span_kernels(lambda: eng.encode_toks(seqs[:8])).get(
        "moe_dispatch", {})
    n_comb = {k: sum(v[1] for name, v in dispatch.items() if k in name)
              for k in MOE_COMBINE_WANT}
    check(n_comb == dict.fromkeys(MOE_COMBINE_WANT, DSV2_LAYERS - 1)
          and not any("indexFuncLargeIndex" in k for k in dispatch),
          f"DeepSeek-V2 forward under moe_dispatch: {n_comb}, kernels "
          f"{sorted(dispatch)}")
    hf = model["hf_config"]
    ref_emb = ref.encode(sd, hf, {"pooling": model["pooling"],
                                  "normalize": model["normalize"]},
                         seqs, dev).cpu().numpy()
    gaps = bench_compare.numbers(emb, ref_emb)
    limits = json.loads((ROOT / "perfbench" / "limits" /
                         "dsv2-lite.long-docs.json").read_text())
    check(bench_compare.passed(bench_compare.judge(gaps, limits)),
          f"DeepSeek-V2 forward against the reference: {gaps}")
    del eng, sd
    emit("mla_path", routes=fused_attention_routes(),
         tolerance=f"|err| <= {K2_RTOL}*|ref| + "
         f"{K2_ATOL_RMS}*rms(ref) on query rows that see >= 64 keys; "
         f"+ 2^-6 * max|v| of the keys on rows that see 1-63; rows that "
         f"see none exactly 0", softmax_scale=scale, parity=out,
         grouped_expert_product=gm, layers=DSV2_LAYERS,
         forwards=[[f["B"], f["L"]] for f in rec.forwards],
         launches=launches, reference=gaps, limits=limits["compare"],
         moe_dispatch_kernels={k: {"ms": v[0], "launches": v[1]}
                               for k, v in dispatch.items()})


def mla_rows(rng, dev) -> list:
    """MLA's rows of the kernel table (K6c at 192/128, every row full) at
    the cell's buckets. The bound counts the causal pairs (L(L+1)/2 a
    row) through q.k at 192 and p.v at 128 against q, k, v read and the
    context written once; the library yardstick is SDPA with
    is_causal=True on [B, H, L, D] copies (v 128 wide), in alternating
    rounds with the kernel."""
    import torch
    import torch.nn.functional as Fn
    from embeddings_tpu_torch.ops import attention as A
    scale = RESULTS["mla_path"]["softmax_scale"]
    out = []
    for Bx, Lx in MLA_SHAPES:
        qkv = torch.from_numpy(rng.standard_normal(
            (Bx * Lx, MLA_H * (2 * MLA_D + MLA_DV)),
            dtype=np.float32)).to(dev, torch.bfloat16)
        lens = torch.full((Bx,), Lx, dtype=torch.int32, device=dev)
        kw = dict(B=Bx, L=Lx, H=MLA_H, D=MLA_D, BK=A.pick_bk(Lx),
                  causal=True, dv=MLA_DV, scale=scale)
        q, k, v = (t.reshape(Bx, Lx, MLA_H, -1).transpose(1, 2).contiguous()
                   for t in qkv.split([MLA_H * MLA_D] * 2
                                      + [MLA_H * MLA_DV], -1))
        pairs = Bx * Lx * (Lx + 1) // 2
        bms, by = bound_ms(2.0 * MLA_H * (MLA_D + MLA_DV) * pairs,
                           Bx * Lx * MLA_H * (2 * MLA_D + 2 * MLA_DV) * 2
                           + Bx * 4)
        t = alternating_ms({
            "kernel": functools.partial(A.fused_attention_stream, qkv, lens,
                                        **kw),
            "library": lambda: Fn.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale)})
        out.append({
            "name": f"fused_attention_stream causal mla[B{Bx} L{Lx} "
                    f"H{MLA_H} D{MLA_D} DV{MLA_DV}]", "route": "cuda",
            "source": ATTN90_SOURCE, "replaces": MLA_REPLACES,
            "launches": STATE.get("launches_mla", {}).get(f"L{Lx}", 0),
            "max_abs_err": RESULTS["mla_path"]["parity"][f"L{Lx}"][
                "max_abs_err"],
            "ms": t["kernel"][0], "ms_range": t["kernel"][1],
            "plain_ms": cuda_ms(functools.partial(
                A.fused_attention_stream_ref, qkv, lens, **kw), iters=2,
                warmup=1),
            "bound_ms": bms, "bound_by": by, "roofline_pct": 100 * bms
            / t["kernel"][0], "library_ms": t["library"][0],
            "library_ms_range": t["library"][1], "causal_pairs": pairs,
            "shape": [Bx, Lx, MLA_H, MLA_D, MLA_DV]})
        del qkv, q, k, v
    return out


def _family_engine(family: str, mesh=None, **ec):
    """all-mpnet-base-v2, jina-embeddings-v2-base-en (and "jina_causal":
    its weights in a causal config), gte-modernbert-base,
    nomic-embed-text-v1 or a bge-base-shaped BERT with 2,048 positions
    ("bert_long") at full width and depth, q4_0 packed + fused qkv, random
    weights from numpy seed 0, on the card (or on a ``mesh`` of it: q/k/v
    apart on a ("data", "model") one)."""
    import torch
    from embeddings_tpu_torch import BertConfig, EngineConfig, KNOWN_MODELS
    from embeddings_tpu_torch.models import params as P
    from embeddings_tpu_torch.runtime.engine import Engine
    from embeddings_tpu_torch.tokenizer import tokenizer_from_dir
    causal = family == "jina_causal"  # jina's weights, a causal config
    if causal:
        family = "jina"
    key = family + "_params"
    if key not in STATE:
        kw = {"mpnet": dict(KNOWN_MODELS["all-mpnet-base-v2"],
                            vocab_size=30527, max_position_embeddings=514),
              "jina": dict(KNOWN_MODELS["jina-embeddings-v2-base-en"]),
              "modernbert": dict(KNOWN_MODELS["gte-modernbert-base"]),
              "nomic": dict(KNOWN_MODELS["nomic-embed-text-v1"]),
              "bert_long": dict(KNOWN_MODELS["bge-base-en-v1.5"],
                                vocab_size=30528,
                                max_position_embeddings=2048)}[family]
        cfg = BertConfig(**{"pooling": "mean", **kw})
        t0 = time.perf_counter()
        unfused = P.pack_q4_params(P.quantize_params(
            P.init_params(cfg, np.random.default_rng(0)), "q4_0"))
        STATE[key] = (cfg, P.fuse_qkv(unfused), time.perf_counter() - t0)
        STATE[key + "_unfused"] = unfused
    cfg, params, _ = STATE[key]
    if mesh is not None and "model" in mesh.shape:
        params = STATE[key + "_unfused"]  # TP shards q, k, v apart
    if causal:
        cfg = dataclasses.replace(cfg, causal=True)
    tok = tokenizer_from_dir(FIXTURE / "model")
    ec = {"batch_size": 128, "max_seq_len": cfg.max_position_embeddings,
          **ec}
    return Engine(params, cfg, tok, EngineConfig(**ec),
                  device=None if mesh else torch.device("cuda"), mesh=mesh)


def bias_routes() -> dict:
    """K7's launches since the last reset_counts by kernel
    (``attention_kernel``: "sm90")."""
    from embeddings_tpu_torch.ops import attention as A
    return dict(A.fused_attention_bias.routes)


def _run_counted(eng, texts):
    """encode_batch with the launch counts of that run alone."""
    import torch
    n = n_bucketed_forwards(eng, texts)
    reset_counts()
    t0 = time.perf_counter()
    emb = eng.encode_batch(texts)
    torch.cuda.synchronize()
    return emb, read_counts(), n, time.perf_counter() - t0


def _row_cos(a, b) -> np.ndarray:
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=1)
                              * np.linalg.norm(b, axis=1))


def _joined(start: int, n: int) -> str:
    """STS sentences start .. start+n-1 joined into one long text."""
    return " ".join(_sts_sentences(2400)[start:start + n])


def phase_long_path():
    """A bge-base-shaped BERT with 2,048 positions on rows of 2,048: past
    the whole-row rule, so every layer runs K6 plain (the JAX package's
    route; K2 never sees these rows)."""
    eng = _family_engine("bert_long", batch_size=BERT_LONG[0])
    texts = [_joined(i * 250, 250) for i in range(BERT_LONG[0])]
    check(all(len(eng.tokenize(t)) == BERT_LONG[1] for t in texts),
          f"long-row texts do not fill L={BERT_LONG[1]}")
    emb, counts, n, wall = _run_counted(eng, texts)
    plain = _family_engine("bert_long", batch_size=BERT_LONG[0],
                           use_pallas="never", compute_dtype="float32")
    cos = _row_cos(emb, plain.encode_batch(texts))
    emit("long_path", model="bge-base-en-v1.5 shape with 2048 positions "
         "(random init, numpy seed 0) q4_0 packed + fused qkv",
         batch=list(BERT_LONG), forwards=n, launches=counts, wall_s=wall,
         kernel_vs_plain_f32_min_cos=float(cos.min()))
    check(n == 1 and counts == only(K1=48, K6=12),
          f"long-row launches {counts} over {n} forwards")
    check(np.isfinite(emb).all() and cos.min() >= 0.999,
          f"long rows vs plain f32: {cos.min()}")
    STATE["launches_K6_plain"] = counts["K6"]
    STATE["bert_long_engine"] = eng


def phase_mpnet_path():
    """all-mpnet-base-v2 q4_0 through Engine.encode_batch (every layer:
    4 K1 + K7 with the relative-position bias, no K2) and the TCP
    server; one forward at the timing shape B=128, L=256."""
    import torch
    eng = _family_engine("mpnet")
    texts = _sts_sentences(300)
    texts += texts[:8]  # identical sentences: cosine 1.0
    emb, counts, n, wall = _run_counted(eng, texts)
    k7_routes = bias_routes()
    plain = _family_engine("mpnet", use_pallas="never",
                           compute_dtype="float32")
    cos = _row_cos(emb, plain.encode_batch(texts))
    norms = np.linalg.norm(emb, axis=1)
    dup = (emb[:8] * emb[-8:]).sum(-1)
    rng = np.random.default_rng(8)
    ids = rng.integers(1000, 30000, MPNET_SHAPE).astype(np.int32)
    reset_counts()
    eng._forward(ids, np.ones(MPNET_SHAPE, np.int32))
    torch.cuda.synchronize()
    one = read_counts()
    emit("mpnet_path", model="all-mpnet-base-v2 (random init, numpy seed 0, "
         "vocab 30527) q4_0 packed + fused qkv",
         init_quantize_s=STATE["mpnet_params"][2], sentences=len(texts),
         forwards=n, wall_s=wall, launches=counts,
         k1_per_forward=counts["K1"] / n, k7_per_forward=counts["K7"] / n,
         launches_at_B128_L256=one, k7_routes=k7_routes,
         norm_min=float(norms.min()),
         norm_max=float(norms.max()), identical_min_cos=float(dup.min()),
         kernel_vs_plain_f32_min_cos=float(cos.min()))
    check(np.isfinite(emb).all() and emb.shape == (len(texts), E),
          "mpnet output not finite / wrong shape")
    check(counts == only(K1=48 * n, K7=12 * n)
          and k7_routes == {"sm90": 12 * n},
          f"mpnet launches {counts} (K7 {k7_routes}) over {n} forwards")
    check(one == only(K1=48, K7=12), f"mpnet at B=128 L=256: {one}")
    check(np.abs(norms - 1).max() < 1e-3, "mpnet: not unit norm")
    check(dup.min() >= 1 - 1e-6, "mpnet: identical sentences differ")
    check(cos.min() >= 0.999, f"mpnet kernel path vs plain f32: {cos.min()}")
    STATE["launches_K7_mpnet"] = counts["K7"]
    STATE["mpnet_engine"] = eng
    _check_tcp("mpnet_server", eng)


def phase_jina_path():
    """jina-embeddings-v2-base-en q4_0 (GeGLU: 5 K1 a layer): B=4 rows of
    8,192 tokens take K6 with in-kernel ALiBi, B=32 rows of 1,024 take K7
    with the ALiBi bias; one or two sequences of each against the plain
    f32 path (whose [B, H, L, L] f32 arrays take 3.2 GB per sequence at
    L=8192); the trained tiny ALiBi fixture's long texts against its
    plain path; the TCP server."""
    eng = _family_engine("jina", batch_size=JINA_SHORT[0])
    plain = _family_engine("jina", batch_size=JINA_SHORT[0],
                           use_pallas="never", compute_dtype="float32")
    long_texts = [_joined(i * 350, 1000) for i in range(JINA_LONG[0])]
    short_texts = [_joined(i * 70, 70) for i in range(JINA_SHORT[0])]
    check(all(len(eng.tokenize(t)) == JINA_LONG[1] for t in long_texts),
          f"long texts do not fill L={JINA_LONG[1]}")
    lens = [len(eng.tokenize(t)) for t in short_texts]
    check(JINA_SHORT[1] // 2 < min(lens) and max(lens) <= JINA_SHORT[1],
          f"short texts outside the L=1024 bucket: {min(lens)}..{max(lens)}")
    out = {}
    for name, texts, attn, shape in (("long", long_texts, "K6", JINA_LONG),
                                     ("short", short_texts, "K7",
                                      JINA_SHORT)):
        emb, counts, n, wall = _run_counted(eng, texts)
        k7_routes = bias_routes()
        cos = _row_cos(emb[:1], plain.encode_batch(texts[:1]))
        out[name] = dict(batch=list(shape),
                         forwards=n, launches=counts, wall_s=wall,
                         k7_routes=k7_routes,
                         kernel_vs_plain_f32_cos=float(cos.min()))
        check(np.isfinite(emb).all() and emb.shape == (len(texts), E),
              f"jina {name}: output not finite / wrong shape")
        check(n == 1 and counts == only(K1=60, **{attn: 12}),
              f"jina {name}: launches {counts} over {n} forwards")
        check(attn != "K7" or k7_routes == {"sm90": 12},
              f"jina {name}: K7 launches by kernel {k7_routes}")
        check(cos.min() >= 0.999, f"jina {name} vs plain f32: {cos.min()}")
        STATE[f"launches_{attn}_jina"] = counts[attn]
    out["trained_fixture"] = _trained_alibi()
    emit("jina_path", model="jina-embeddings-v2-base-en (random init, numpy "
         "seed 0) q4_0 packed + fused qkv",
         init_quantize_s=STATE["jina_params"][2], **out)
    STATE["jina_engine"] = eng
    _check_tcp("jina_server", eng)


def _trained_alibi() -> dict:
    """tiny_trained_alibi's long STS texts (about 800 tokens: K7 at
    L=1024) through Engine on the card against its plain f32 path."""
    import torch
    from embeddings_tpu_torch import EngineConfig, load_model
    rows = (ALIBI_FIXTURE / "sts-test-long.tsv").read_text().splitlines()
    texts = [c for r in rows[:8] for c in r.split("\t")[1:3]]
    model = ALIBI_FIXTURE / "model"
    q4 = load_model(model, dtype="q4_0", device=torch.device("cuda"))
    plain = load_model(model, dtype="q4_0", device=torch.device("cuda"),
                       engine_config=EngineConfig(
                           use_pallas="never", compute_dtype="float32",
                           max_seq_len=2048))
    emb, counts, n, _ = _run_counted(q4, texts)
    cos = _row_cos(emb, plain.encode_batch(texts))
    r = dict(model=str(model.relative_to(ROOT)), texts=len(texts),
             forwards=n, launches=counts,
             kernel_vs_plain_f32_min_cos=float(cos.min()))
    NLt = q4.config.num_hidden_layers
    check(counts == only(K1=5 * NLt * n, K7=NLt * n),
          f"tiny ALiBi fixture: launches {counts} over {n} forwards")
    check(cos.min() >= 0.999, f"tiny ALiBi fixture vs plain: {cos.min()}")
    return r


def phase_jina_causal_path():
    """jina-embeddings-v2-base-en's weights in a causal config (the
    ``BertConfig`` the JAX package takes with ``causal=True``) at full
    width and depth, q4_0 packed: B=4 rows of 8,192 tokens take K6ca on
    every layer (60 K1 + 12 K6ca a forward, nothing else); the first
    sequence against the plain f32 path (ALiBi and the causal triangle
    folded into the einsum path's mask)."""
    eng = _family_engine("jina_causal", batch_size=JINA_LONG[0])
    plain = _family_engine("jina_causal", batch_size=JINA_LONG[0],
                           use_pallas="never", compute_dtype="float32")
    texts = [_joined(i * 350 + 100, 1000) for i in range(JINA_LONG[0])]
    check(all(len(eng.tokenize(t)) == JINA_LONG[1] for t in texts),
          f"long texts do not fill L={JINA_LONG[1]}")
    emb, counts, n, wall = _run_counted(eng, texts)
    cos = _row_cos(emb[:1], plain.encode_batch(texts[:1]))
    check(np.isfinite(emb).all() and emb.shape == (len(texts), E),
          "jina causal: output not finite / wrong shape")
    check(n == 1 and counts == only(K1=60, K6ca=12),
          f"jina causal: launches {counts} over {n} forwards")
    check(cos.min() >= 0.999, f"jina causal vs plain f32: {cos.min()}")
    bidir = STATE["jina_engine"].encode_batch(texts[:1]) \
        if "jina_engine" in STATE else None
    STATE["launches_K6ca_jina"] = counts["K6ca"]
    STATE["jina_causal_engine"] = eng
    emit("jina_causal_path", model="jina-embeddings-v2-base-en weights "
         "(random init, numpy seed 0), causal=True, q4_0 packed + fused qkv",
         batch=list(JINA_LONG), forwards=n, launches=counts, wall_s=wall,
         kernel_vs_plain_f32_cos=float(cos.min()),
         causal_vs_bidirectional_cos=(float(_row_cos(emb[:1], bidir).min())
                                      if bidir is not None else None))


def phase_modernbert_path():
    """gte-modernbert-base q4_0 at full width and depth (22 layers, CLS
    pooling) through Engine.encode_batch: B=32 rows of 1,024 tokens run
    110 K1 + 8 K2 (global layers) + 14 K6w (local layers, each on the
    Hopper kernel's mode 6) a forward, B=4 rows of 8,192 run 110 K1 + 8 K6
    plain + 14 K6w; no einsum attention.
    One or two sequences of each against the plain f32 path; the TCP
    server."""
    eng = _family_engine("modernbert", batch_size=MB_SHORT[0])
    plain = _family_engine("modernbert", batch_size=MB_SHORT[0],
                           use_pallas="never", compute_dtype="float32")
    long_texts = [_joined(i * 350, 1000) for i in range(MB_LONG[0])]
    short_texts = [_joined(i * 70, 70) for i in range(MB_SHORT[0])]
    check(all(len(eng.tokenize(t)) == MB_LONG[1] for t in long_texts),
          f"long texts do not fill L={MB_LONG[1]}")
    lens = [len(eng.tokenize(t)) for t in short_texts]
    check(MB_SHORT[1] // 2 < min(lens) and max(lens) <= MB_SHORT[1],
          f"short texts outside the L=1024 bucket: {min(lens)}..{max(lens)}")
    from embeddings_tpu_torch.ops import attention as A
    from embeddings_tpu_torch.ops.qmatmul import qmatmul
    out, k1_shapes = {}, {}
    for name, texts, glob, shape, n_plain in (
            ("long", long_texts, "K6", MB_LONG, 1),
            ("short", short_texts, "K2", MB_SHORT, 2)):
        emb, counts, n, wall = _run_counted(eng, texts)
        for key, c in qmatmul.shapes.items():
            k1_shapes[key] = k1_shapes.get(key, 0) + c
        cos = _row_cos(emb[:n_plain], plain.encode_batch(texts[:n_plain]))
        norms = np.linalg.norm(emb, axis=1)
        out[name] = dict(batch=list(shape), forwards=n, launches=counts,
                         wall_s=wall, norm_min=float(norms.min()),
                         norm_max=float(norms.max()),
                         kernel_vs_plain_f32_min_cos=float(cos.min()),
                         plain_rows=n_plain)
        check(np.isfinite(emb).all() and emb.shape == (len(texts), E),
              f"modernbert {name}: output not finite / wrong shape")
        want = only(K1=5 * MB_NL, K6w=MB_LOCAL, **{glob: MB_GLOBAL})
        check(n == 1 and counts == want,
              f"modernbert {name}: launches {counts} over {n} forwards, "
              f"expected {want}")
        k6w_routes = dict(A.fused_attention_window.routes)
        out[name]["k6w_routes"] = k6w_routes
        check(k6w_routes == {"sm90": MB_LOCAL},
              f"modernbert {name}: K6w launches by route {k6w_routes}, "
              f"expected {MB_LOCAL} on the Hopper kernel (mode 6)")
        check(np.abs(norms - 1).max() < 1e-3,
              f"modernbert {name}: not unit norm")
        check(cos.min() >= 0.999,
              f"modernbert {name} vs plain f32: {cos.min()}")
        STATE[f"launches_K6w_modernbert_{name}"] = counts["K6w"]
        STATE[f"launches_{glob}_modernbert"] = counts[glob]
    STATE.setdefault("launches", {})["qmatmul_modernbert"] = k1_shapes
    emit("modernbert_path", model="gte-modernbert-base (random init, numpy "
         "seed 0) q4_0 packed + fused qkv, CLS pooling",
         init_quantize_s=STATE["modernbert_params"][2], **out)
    STATE["modernbert_engine"] = eng
    _check_tcp("modernbert_server", eng)


def _qwen2_engine(causal: bool, **ec):
    """gte-Qwen2-1.5B-instruct at full width and depth, q4_0 packed (q, k,
    v apart: grouped-query attention), random weights from numpy seed 0.
    The tree is built once, moved to the card once and shared by every
    engine (causal or bidirectional, kernel or plain f32 path): they
    differ only in ``config.causal`` and the engine config."""
    import torch
    from embeddings_tpu_torch import BertConfig, EngineConfig, KNOWN_MODELS
    from embeddings_tpu_torch.models import params as P
    from embeddings_tpu_torch.runtime.engine import Engine
    from embeddings_tpu_torch.tokenizer import tokenizer_from_dir
    dev = torch.device("cuda")
    if "qwen2_params" not in STATE:
        cfg = BertConfig(**KNOWN_MODELS["gte-Qwen2-1.5B-instruct"])
        t0 = time.perf_counter()
        params = P.to_device(P.fuse_qkv(P.pack_q4_params(P.quantize_params(
            P.init_params(cfg, np.random.default_rng(0)), "q4_0"))), dev)
        torch.cuda.synchronize()
        STATE["qwen2_params"] = (cfg, params, time.perf_counter() - t0)
    cfg, params, _ = STATE["qwen2_params"]
    tok = tokenizer_from_dir(FIXTURE / "model")
    ec = {"batch_size": QW_SHORT[0], "max_seq_len": QW_LONG[1], **ec}
    return Engine(params, dataclasses.replace(cfg, causal=causal), tok,
                  EngineConfig(**ec), device=dev)


def phase_qwen2_path():
    """gte-Qwen2-1.5B-instruct q4_0 at full width and depth (28 layers,
    last-token pooling) through Engine.encode_batch, four forwards of
    16,384 token slots: causal at B=32, L=512 and B=4, L=4096 (196 K1 +
    28 K6c each), bidirectional at B=32, L=512 (196 K1 + 28 K2) and B=4,
    L=4096 (196 K1 + 28 K6 plain); no einsum attention. One or two
    sequences of each against the plain f32 path on the same tree; the
    causal and bidirectional forms must differ; the TCP server for
    both."""
    from embeddings_tpu_torch.ops.qmatmul import qmatmul
    engines = {"causal": _qwen2_engine(True),
               "bidirectional": _qwen2_engine(False)}
    plain = {form: _qwen2_engine(form == "causal", use_pallas="never",
                                 compute_dtype="float32")
             for form in engines}
    eng = engines["causal"]
    long_texts = [_joined(i * 350, 1000) for i in range(QW_LONG[0])]
    short_texts = [_joined(i * 40, 30) for i in range(QW_SHORT[0])]
    check(all(len(eng.tokenize(t)) == QW_LONG[1] for t in long_texts),
          f"long texts do not fill L={QW_LONG[1]}")
    lens = [len(eng.tokenize(t)) for t in short_texts]
    check(QW_SHORT[1] // 2 < min(lens) and max(lens) <= QW_SHORT[1],
          f"short texts outside the L=512 bucket: {min(lens)}..{max(lens)}")
    out, k1_shapes, embs = {}, {}, {}
    for form, e in engines.items():
        for name, texts, shape, n_plain in (
                ("short", short_texts, QW_SHORT, 2),
                ("long", long_texts, QW_LONG, 1)):
            attn = ("K6c" if form == "causal" else
                    "K2" if name == "short" else "K6")
            emb, counts, n, wall = _run_counted(e, texts)
            for key, c in qmatmul.shapes.items():
                k1_shapes[key] = k1_shapes.get(key, 0) + c
            cos = _row_cos(emb[:n_plain],
                           plain[form].encode_batch(texts[:n_plain]))
            norms = np.linalg.norm(emb, axis=1)
            out[f"{form}_{name}"] = dict(
                batch=list(shape), forwards=n, launches=counts, wall_s=wall,
                norm_min=float(norms.min()), norm_max=float(norms.max()),
                kernel_vs_plain_f32_min_cos=float(cos.min()),
                plain_rows=n_plain)
            check(np.isfinite(emb).all() and emb.shape == (len(texts), QW_E),
                  f"qwen2 {form} {name}: output not finite / wrong shape")
            want = only(K1=QW_K1, **{attn: QW_NL})
            check(n == 1 and counts == want,
                  f"qwen2 {form} {name}: launches {counts} over {n} "
                  f"forwards, expected {want}")
            check(np.abs(norms - 1).max() < 1e-3,
                  f"qwen2 {form} {name}: not unit norm")
            check(cos.min() >= 0.999,
                  f"qwen2 {form} {name} vs plain f32: {cos.min()}")
            STATE[f"launches_{attn}_qwen2_{name}"] = counts[attn]
            embs[form, name] = emb
    # the causal mask is live: a row's first hidden states differ between
    # the two forms (the last token, pooled, sees every key in both)
    form_cos = {name: float(_row_cos(embs["causal", name],
                                     embs["bidirectional", name]).min())
                for name in ("short", "long")}
    first = _first_positions_cos(engines, short_texts[0])
    check(first < 0.999, f"qwen2: causal and bidirectional hidden states "
          f"agree on the first 64 positions (min cos {first})")
    STATE.setdefault("launches", {})["qmatmul_qwen2"] = k1_shapes
    emit("qwen2_path", model="gte-Qwen2-1.5B-instruct (random init, numpy "
         "seed 0) q4_0 packed, q/k/v apart (GQA), last-token pooling",
         init_quantize_s=STATE["qwen2_params"][2],
         causal_vs_bidirectional_pooled_min_cos=form_cos,
         causal_vs_bidirectional_first64_hidden_min_cos=first, **out)
    STATE["qwen2_causal_engine"] = engines["causal"]
    STATE["qwen2_bidir_engine"] = engines["bidirectional"]
    _check_tcp("qwen2_server_causal", engines["causal"])
    _check_tcp("qwen2_server_bidirectional", engines["bidirectional"])


def _cp_attn_inputs(rng, Bx: int, Lc: int, Lx: int, dev, ragged: bool = True,
                    fused_q: bool = False):
    """The CP kernels' operands: bf16 q [Bx*Lc, E] (with ``fused_q`` a
    column view of a local projection [Bx*Lc, 3E], row stride 3E, read in
    place as the fused tree's forward passes it), the gathered kv [Bx*Lx,
    2E] and int32 lengths: ragged (a len-0 row first, a row shorter than
    Lc second and a full row last; one row: a length past Lc short of Lx)
    or every row full."""
    import torch
    src = torch.from_numpy(rng.standard_normal(
        (Bx * Lc, 3 * E if fused_q else E), dtype=np.float32)).to(
        dev, torch.bfloat16)
    kv = torch.from_numpy(rng.standard_normal(
        (Bx * Lx, 2 * E), dtype=np.float32)).to(dev, torch.bfloat16)
    lens = np.full(Bx, Lx)
    if ragged and Bx > 2:
        lens = rng.integers(1, Lx + 1, Bx)
        lens[0], lens[1], lens[-1] = 0, Lc // 2 + 3, Lx
    elif ragged:
        lens[0] = Lx - 777
    return src[:, :E], kv, torch.tensor(lens.tolist(), dtype=torch.int32,
                                        device=dev)


def phase_k8():
    """K8a and K8b (context parallelism: a shard's Lc local queries against
    the L all-gathered keys, Lc < L) against their plain versions on the
    card, with K6's tolerance, each launch on the Hopper kernel ("sm90");
    K8a reads q in place from a [B*Lc, 3E]
    projection. The control: the same output held against the plain
    version run on the local K/V chunk alone (no gather) must fail the
    check, or the check could not see a missing gather."""
    import torch
    from embeddings_tpu_torch.ops import attention as A
    rng = np.random.default_rng(12)
    dev = torch.device("cuda")
    saved = read_counts()  # comparison launches are not path launches
    out = {}
    for name, cases in (("K8a", K8A_CASES), ("K8b", K8B_CASES)):
        for Bx, Lc, Lx in cases:
            q, kv, lens = _cp_attn_inputs(rng, Bx, Lc, Lx, dev,
                                          fused_q=name == "K8a")
            kw = dict(B=Bx, Lc=Lc, L=Lx, H=H, D=D)
            if name == "K8a":
                kernel, plain = A.fused_attention_cp, A.fused_attention_cp_ref
            else:
                kw["BK"] = A.pick_bk(Lx)
                kernel, plain = (A.fused_attention_cp_stream,
                                 A.fused_attention_cp_stream_ref)
            got, routes = _routed(kernel, lambda: kernel(q, kv, lens, **kw))
            ref = plain(q, kv, lens, **kw)
            torch.cuda.synchronize()
            r = compare(got, ref, K2_RTOL, K2_ATOL_RMS)
            r["routes"] = routes
            zero = [b for b, n in enumerate(lens.tolist()) if n == 0]
            r["zero_rows_exact"] = all(bool(
                (got.reshape(Bx, Lc, E)[b] == 0).all()) for b in zero)
            local = kv.reshape(Bx, Lx, 2 * E)[:, :Lc].reshape(Bx * Lc, 2 * E)
            ctl = A.fused_attention_cp_ref(q, local, lens.clamp(max=Lc),
                                           B=Bx, Lc=Lc, L=Lc, H=H, D=D)
            r["control_no_gather"] = compare(got, ctl, K2_RTOL, K2_ATOL_RMS)
            out[f"{name}_B{Bx}_Lc{Lc}_L{Lx}"] = dict(
                r, shape=[Bx, Lc, Lx, H, D], q_row_stride=q.stride(0),
                lengths_head=lens.tolist()[:3], **(
                    {"BK": kw["BK"]} if "BK" in kw else {}))
            del ref, ctl
    set_counts(saved)
    for key, r in out.items():
        check(r["ok"] and r["zero_rows_exact"], f"{key} disagrees: {r}")
        check(r["routes"] == {"sm90": 1}, f"{key}: launches by route "
              f"{r['routes']}")
        check(not r["control_no_gather"]["ok"],
              f"{key}: the control (no gather) passes the check")
    emit("k8_parity", tolerance=f"|err| <= {K2_RTOL}*|ref| + "
         f"{K2_ATOL_RMS}*rms(ref) (K6's); len-0 rows exactly 0; the "
         f"control against the local chunk alone must fail", **out)


def _cp_case(name: str, make, single, shape, mesh_shape, k1_layer: int,
             kernel: str, single_want: dict, texts) -> dict:
    """One CP path: ``make(mesh=..., **ec)`` builds the Engine on a mesh
    naming the card once per shard; one forward through encode_batch with
    exact launch counts (k1_layer K1 and one ``kernel`` a layer a shard,
    nothing else), against the single-device Engine ``single`` (which
    launches ``single_want``) and the plain f32 CP forward."""
    import torch
    from embeddings_tpu_torch.parallel import make_mesh_cp
    Bx, Lx = shape
    dp, sp = mesh_shape
    mesh = make_mesh_cp(dp, sp, [torch.device("cuda")] * (dp * sp))
    ec = dict(batch_size=Bx, max_seq_len=Lx)
    eng = make(mesh=mesh, **ec)
    check(all(len(eng.tokenize(t)) == Lx for t in texts),
          f"{name}: texts do not fill L={Lx}")
    from embeddings_tpu_torch.ops import attention as A
    emb, counts, n, wall = _run_counted(eng, texts)
    wrapper = (A.fused_attention_cp if kernel == "K8a"
               else A.fused_attention_cp_stream)
    routes = dict(wrapper.routes)
    nl, shards = eng.config.num_hidden_layers, dp * sp
    want = only(K1=k1_layer * nl * shards, **{kernel: nl * shards})
    check(n == 1 and counts == want,
          f"{name}: launches {counts} over {n} forwards, want {want}")
    check(routes == {"sm90": nl * shards},
          f"{name}: {kernel} launches by route {routes}")
    emb_single, counts_single, _, _ = _run_counted(single, texts)
    check(counts_single == single_want,
          f"{name}: single-device launches {counts_single}")
    plain = make(mesh=mesh, use_pallas="never", compute_dtype="float32",
                 **ec)
    cos_single = _row_cos(emb, emb_single)
    cos_plain = _row_cos(emb, plain.encode_batch(texts))
    norms = np.linalg.norm(emb, axis=1)
    check(np.isfinite(emb).all() and emb.shape == (Bx, E),
          f"{name}: output not finite / wrong shape")
    check(np.abs(norms - 1).max() < 1e-3, f"{name}: not unit norm")
    check(cos_single.min() >= 0.999 and cos_plain.min() >= 0.999,
          f"{name}: CP vs single device {cos_single.min()}, vs plain f32 CP "
          f"{cos_plain.min()}")
    STATE[f"cp_{name}_engine"], STATE[f"cp_{name}_single"] = eng, single
    STATE[f"launches_{kernel}"] = counts[kernel]
    return dict(batch=[Bx, Lx], mesh={"data": dp, "seq": sp},
                shard=[Bx // dp, Lx // sp], forwards=n, wall_s=wall,
                launches=counts, routes=routes,
                single_device_launches=counts_single,
                k1_per_layer_per_shard=k1_layer,
                cp_vs_single_device_min_cos=float(cos_single.min()),
                cp_vs_plain_f32_cp_min_cos=float(cos_plain.min()),
                norm_min=float(norms.min()), norm_max=float(norms.max()))


def phase_cp_path():
    """Context parallelism through Engine(mesh=...).encode_batch at full
    width and depth, q4_0 packed + fused qkv, random weights from numpy
    seed 0: (a) bge-base-en-v1.5 on dp=2 x sp=2 at B=32, L=512 (every
    layer of every shard takes K8a; 4 K1 a layer a shard: qkv, o, up,
    down), (b) nomic-embed-text-v1 (RoPE, SwiGLU: 5 K1, gate and up apart)
    on dp=1 x sp=4 at B=4, L=2,048 (K8b: the gathered row is past the
    whole-row rule); then one TCP round trip through the bge CP Engine."""
    bge = _cp_case(
        "bge", _bge_base_engine, _bge_base_engine(batch_size=CP_BGE[0]),
        CP_BGE, CP_BGE_MESH, 4, "K8a", only(K1=4 * NL, K2=NL),
        [_joined(i * 60, 60) for i in range(CP_BGE[0])])
    nomic = _cp_case(
        "nomic", functools.partial(_family_engine, "nomic"),
        _family_engine("nomic", batch_size=CP_NOMIC[0]), CP_NOMIC,
        CP_NOMIC_MESH, 5, "K8b", only(K1=5 * NL, K6=NL),
        [_joined(i * 250, 250) for i in range(CP_NOMIC[0])])
    emit("cp_path", bge=dict(bge, model="bge-base-en-v1.5 (random init, "
                             "numpy seed 0, vocab 30528) q4_0 packed + "
                             "fused qkv"),
         nomic=dict(nomic, model="nomic-embed-text-v1 (random init, numpy "
                    "seed 0) q4_0 packed + fused qkv",
                    init_quantize_s=STATE["nomic_params"][2]))
    _check_tcp("cp_server", STATE["cp_bge_engine"])


# ---------------------------------------------------------------------------
# the encoder families on K1 and K2 alone: DistilBERT, RoBERTa, RoFormer,
# ALBERT (factorized embeddings, one shared layer), from HF-named weights
# ---------------------------------------------------------------------------

# each family's published config.json (as its HF repository holds it),
# its checkpoint's backbone prefix, and what a forward launches at
# ENC_SHAPE: (source, config, prefix, K1 a forward, K2 a forward)
ENC_CONFIGS = {
    "distilbert": ("distilbert-base-uncased", {
        "model_type": "distilbert", "activation": "gelu", "dim": 768,
        "hidden_dim": 3072, "max_position_embeddings": 512, "n_heads": 12,
        "n_layers": 6, "pad_token_id": 0, "sinusoidal_pos_embds": False,
        "vocab_size": 30522}, "distilbert.", 24, 6),
    "roberta": ("sentence-transformers/all-distilroberta-v1", {
        "model_type": "roberta", "bos_token_id": 0, "eos_token_id": 2,
        "hidden_act": "gelu", "hidden_size": 768,
        "intermediate_size": 3072, "layer_norm_eps": 1e-05,
        "max_position_embeddings": 514, "num_attention_heads": 12,
        "num_hidden_layers": 6, "pad_token_id": 1,
        "position_embedding_type": "absolute", "type_vocab_size": 1,
        "vocab_size": 50265}, "", 24, 6),
    "roformer": ("junnyu/roformer_chinese_base", {
        "model_type": "roformer", "embedding_size": 768,
        "hidden_act": "gelu", "hidden_size": 768,
        "intermediate_size": 3072, "layer_norm_eps": 1e-12,
        "max_position_embeddings": 1536, "num_attention_heads": 12,
        "num_hidden_layers": 12, "pad_token_id": 0, "rotary_value": False,
        "type_vocab_size": 2, "vocab_size": 50000}, "roformer.", 48, 12),
    # vocab 30,000 published; 30,522 here, so the STS fixture's WordPiece
    # ids (up to 30,521) index the table
    "albert": ("albert-base-v2", {
        "model_type": "albert", "bos_token_id": 2, "embedding_size": 128,
        "eos_token_id": 3, "hidden_act": "gelu_new", "hidden_size": 768,
        "inner_group_num": 1, "intermediate_size": 3072,
        "layer_norm_eps": 1e-12, "max_position_embeddings": 512,
        "num_attention_heads": 12, "num_hidden_groups": 1,
        "num_hidden_layers": 12, "pad_token_id": 0, "type_vocab_size": 2,
        "vocab_size": 30522}, "albert.", 48, 12),
    # the cross-encoder: XLM-R backbone, classifier.dense -> out_proj
    "xlmr_reranker": ("BAAI/bge-reranker-base", {
        "architectures": ["XLMRobertaForSequenceClassification"],
        "model_type": "xlm-roberta", "bos_token_id": 0, "eos_token_id": 2,
        "hidden_act": "gelu", "hidden_size": 768,
        "id2label": {"0": "LABEL_0"}, "intermediate_size": 3072,
        "label2id": {"LABEL_0": 0}, "layer_norm_eps": 1e-05,
        "max_position_embeddings": 514, "num_attention_heads": 12,
        "num_hidden_layers": 12, "pad_token_id": 1,
        "position_embedding_type": "absolute", "type_vocab_size": 1,
        "vocab_size": 250002}, "roberta.", 48, 12),
    # the mixture-of-experts encoder: the repo preset's values
    # (KNOWN_MODELS["nomic-embed-text-v2-moe"]) under nomic_bert's
    # config.json keys; its weights under nomic_bert's names
    "nomic_moe": ("nomic-ai/nomic-embed-text-v2-moe", {
        "model_type": "nomic_bert", "activation_function": "gelu",
        "n_embd": 768, "n_head": 12, "n_inner": 3072, "n_layer": 12,
        "n_positions": 2048, "num_experts": 8, "moe_top_k": 2,
        "moe_every_n_layers": 2, "moe_normalize_expert_weights": None,
        "prenorm": False, "rotary_emb_base": 1000.0,
        "rotary_emb_fraction": 1.0, "rotary_emb_interleaved": False,
        "type_vocab_size": 2, "vocab_size": 250048}, "", MOE_K1, MOE_NL),
}


def hf_state_dict(family: str, d: dict, rng) -> dict:
    """Random weights under the names and shapes the family's published
    checkpoint holds (behind its backbone prefix): std 0.02 from ``rng``,
    zero biases, unit LayerNorms; the pooler and RoFormer's sinusoidal
    table as the checkpoints carry them (the mapping drops both)."""
    sd: dict = {}

    def w(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    def lin(name, o, i):
        sd[name + ".weight"], sd[name + ".bias"] = w(o, i), np.zeros(
            o, np.float32)

    def ln(name, n):
        sd[name + ".weight"] = np.ones(n, np.float32)
        sd[name + ".bias"] = np.zeros(n, np.float32)

    V = d["vocab_size"]
    if family == "nomic_moe":
        # nomic_bert's names: a fused Wqkv, fc1 / fc2 at even layers, a
        # router [Ex, E] and the experts' w1 / w2 [Ex*I, E] with their
        # shared output bias at odd ones
        E, Fx, NLx, Ex = d["n_embd"], d["n_inner"], d["n_layer"], \
            d["num_experts"]
        sd["embeddings.word_embeddings.weight"] = w(V, E)
        sd["embeddings.token_type_embeddings.weight"] = w(
            d["type_vocab_size"], E)
        ln("emb_ln", E)
        for i in range(NLx):
            p = f"encoder.layers.{i}."
            lin(p + "attn.Wqkv", 3 * E, E)
            lin(p + "attn.out_proj", E, E)
            ln(p + "norm1", E)
            ln(p + "norm2", E)
            if i % 2 == 0:
                lin(p + "mlp.fc1", Fx, E)
                lin(p + "mlp.fc2", E, Fx)
            else:
                sd[p + "mlp.router.layer.weight"] = w(Ex, E)
                sd[p + "mlp.experts.mlp.w1"] = w(Ex * Fx, E)
                sd[p + "mlp.experts.mlp.w2"] = w(Ex * Fx, E)
                sd[p + "mlp.experts.bias"] = np.zeros(E, np.float32)
        return sd
    if family == "distilbert":
        E, Fx, NLx = d["dim"], d["hidden_dim"], d["n_layers"]
    else:
        E, Fx, NLx = (d["hidden_size"], d["intermediate_size"],
                      d["num_hidden_layers"])
    Ee = d.get("embedding_size", E)
    sd["embeddings.word_embeddings.weight"] = w(V, Ee)
    if family != "roformer":
        sd["embeddings.position_embeddings.weight"] = w(
            d["max_position_embeddings"], Ee)
    if family != "distilbert":
        sd["embeddings.token_type_embeddings.weight"] = w(
            d["type_vocab_size"], Ee)
    ln("embeddings.LayerNorm", Ee)
    if family == "distilbert":
        for i in range(NLx):
            p = f"transformer.layer.{i}."
            for n in ("q_lin", "k_lin", "v_lin", "out_lin"):
                lin(p + "attention." + n, E, E)
            ln(p + "sa_layer_norm", E)
            lin(p + "ffn.lin1", Fx, E)
            lin(p + "ffn.lin2", E, Fx)
            ln(p + "output_layer_norm", E)
    elif family == "albert":
        lin("encoder.embedding_hidden_mapping_in", E, Ee)
        p = "encoder.albert_layer_groups.0.albert_layers.0."
        for n in ("query", "key", "value", "dense"):
            lin(p + "attention." + n, E, E)
        ln(p + "attention.LayerNorm", E)
        lin(p + "ffn", Fx, E)
        lin(p + "ffn_output", E, Fx)
        ln(p + "full_layer_layer_norm", E)
        lin("pooler", E, E)
    else:
        for i in range(NLx):
            p = f"encoder.layer.{i}."
            for n in ("query", "key", "value"):
                lin(p + "attention.self." + n, E, E)
            lin(p + "attention.output.dense", E, E)
            ln(p + "attention.output.LayerNorm", E)
            lin(p + "intermediate.dense", Fx, E)
            lin(p + "output.dense", E, Fx)
            ln(p + "output.LayerNorm", E)
        if family == "roformer":
            sd["encoder.embed_positions.weight"] = w(
                d["max_position_embeddings"], E // d["num_attention_heads"])
        elif family != "xlmr_reranker":  # a classifier has no pooler
            lin("pooler.dense", E, E)
    out = {ENC_CONFIGS[family][2] + k: v for k, v in sd.items()}
    if family == "xlmr_reranker":
        # RobertaClassificationHead, outside the backbone prefix
        sd.clear()
        lin("classifier.dense", E, E)
        lin("classifier.out_proj", len(d["id2label"]), E)
        out.update(sd)
    return out


def _hf_engine(family: str, mesh=None, **ec):
    """The family at its published width and depth from HF-named random
    weights (numpy seed 0) through ``BertConfig.from_hf_dict`` and
    ``params.from_hf_state_dict``, q4_0 packed + fused qkv, mean pooling,
    the STS fixture's WordPiece tokenizer; on the card (or on a CP
    ``mesh`` of it). The tree is built once."""
    import torch
    from embeddings_tpu_torch import BertConfig, EngineConfig
    from embeddings_tpu_torch.models import params as P
    from embeddings_tpu_torch.runtime.engine import Engine
    from embeddings_tpu_torch.tokenizer import tokenizer_from_dir
    tok = tokenizer_from_dir(FIXTURE / "model")
    key = family + "_params"
    if key not in STATE:
        d = ENC_CONFIGS[family][1]
        t0 = time.perf_counter()
        cfg = BertConfig.from_hf_dict(d)
        sd = hf_state_dict(family, d, np.random.default_rng(0))
        params = P.fuse_qkv(P.pack_q4_params(P.quantize_params(
            P.from_hf_state_dict(sd, cfg), "q4_0")))
        cfg = dataclasses.replace(
            cfg, pooling="mean", cls_token_id=tok.cls_id,
            sep_token_id=tok.sep_id, unk_token_id=tok.unk_id,
            pad_token_id=tok.pad_id)
        STATE[key] = (cfg, params, time.perf_counter() - t0)
    cfg, params, _ = STATE[key]
    ec = {"batch_size": 128,
          "max_seq_len": cfg.max_position_embeddings - cfg.position_offset,
          **ec}
    return Engine(params, cfg, tok, EngineConfig(**ec),
                  device=None if mesh else torch.device("cuda"), mesh=mesh)


def _encoder_path(family: str) -> dict:
    """The family through Engine.encode_batch: STS sentences (8 repeated),
    K1 and K2 alone at the exact counts a forward makes, every K2 on the
    Hopper kernel; unit norms, identical sentences at cosine 1, cosine
    >= 0.999 to the plain f32 path; then one forward at ENC_SHAPE."""
    import torch
    from embeddings_tpu_torch.ops import attention as A
    from embeddings_tpu_torch.ops.qmatmul import qmatmul
    source, _, _, k1, k2 = ENC_CONFIGS[family]
    eng = _hf_engine(family)
    texts = _sts_sentences(300)
    texts += texts[:8]  # identical sentences: cosine 1.0
    (emb, counts, n, wall), k2_routes = _routed(
        A.fused_attention, lambda: _run_counted(eng, texts))
    STATE.setdefault("launches", {})[f"qmatmul_{family}"] = dict(
        qmatmul.shapes)
    plain = _hf_engine(family, use_pallas="never", compute_dtype="float32")
    cos = _row_cos(emb, plain.encode_batch(texts))
    norms = np.linalg.norm(emb, axis=1)
    dup = (emb[:8] * emb[-8:]).sum(-1)
    rng = np.random.default_rng(8)
    ids = rng.integers(1000, 30000, ENC_SHAPE).astype(np.int32)
    reset_counts()
    eng._forward(ids, np.ones(ENC_SHAPE, np.int32))
    torch.cuda.synchronize()
    one = read_counts()
    check(np.isfinite(emb).all() and emb.shape == (len(texts), E),
          f"{family}: output not finite / wrong shape")
    check(counts == only(K1=k1 * n, K2=k2 * n)
          and k2_routes == {"sm90": k2 * n},
          f"{family}: launches {counts} (K2 {k2_routes}) over {n} forwards")
    check(one == only(K1=k1, K2=k2), f"{family} at {ENC_SHAPE}: {one}")
    check(np.abs(norms - 1).max() < 1e-3, f"{family}: not unit norm")
    check(dup.min() >= 1 - 1e-6, f"{family}: identical sentences differ")
    check(cos.min() >= 0.999,
          f"{family}: kernel path vs plain f32 {cos.min()}")
    STATE[family + "_engine"] = eng
    return dict(model=f"{source} (HF-named random weights, numpy seed 0, "
                f"vocab {eng.config.vocab_size}) q4_0 packed + fused qkv",
                init_quantize_s=STATE[family + "_params"][2],
                sentences=len(texts), forwards=n, wall_s=wall,
                launches=counts, k2_routes=k2_routes,
                k1_per_forward=counts["K1"] / n,
                k2_per_forward=counts["K2"] / n,
                launches_at_B128_L256=one, norm_min=float(norms.min()),
                norm_max=float(norms.max()),
                identical_min_cos=float(dup.min()),
                kernel_vs_plain_f32_min_cos=float(cos.min()))


def phase_distilbert_path():
    """distilbert-base-uncased (6 layers): 24 K1 + 6 K2 a forward."""
    emit("distilbert_path", **_encoder_path("distilbert"))


def phase_roberta_path():
    """all-distilroberta-v1 (RoBERTa, 6 layers, positions offset by 2):
    24 K1 + 6 K2 a bucketed forward; token-packed rows of 128 (positions
    restarting at the offset per segment; 2,400 STS sentences in batches
    of 128 rows) 24 K1 + 6 K4 a packed forward, every K4 on the Hopper
    kernel, cosine >= 0.999 to bucketed; TCP."""
    import torch
    from embeddings_tpu_torch.ops import attention as A
    out = _encoder_path("roberta")
    eng = STATE["roberta_engine"]
    texts = _sts_sentences(2400)
    ref = eng.encode_batch(texts)
    # texts past the row go to the bucketed path
    long_txt = [t for t in texts if len(eng.tokenize(t)) > 128]
    n_long = n_bucketed_forwards(eng, long_txt) if long_txt else 0
    shapes = []
    run = eng._forward_packed

    def spy(ids, seg, pos, pool, attn_window=0):
        shapes.append(list(ids.shape))
        return run(ids, seg, pos, pool, attn_window)

    eng._forward_packed = spy
    try:
        reset_counts()
        t0 = time.perf_counter()
        emb = eng.encode_batch_packed(texts, row_len=128, batch_rows=128)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del eng._forward_packed  # back to the class method
    counts, n = read_counts(), len(shapes)
    routes = dict(A.fused_attention_segmented.routes)
    cos = _row_cos(emb, ref)
    check(n >= 1 and counts == only(K1=24 * (n + n_long), K2=6 * n_long,
                                    K4=6 * n)
          and routes == {"sm90": 6 * n},
          f"roberta packed: launches {counts} (K4 {routes}) over {n} "
          f"packed forwards")
    check(np.isfinite(emb).all() and cos.min() >= 0.999,
          f"roberta packed vs bucketed: {cos.min()}")
    out["packed_row128"] = dict(sentences=len(texts), packed_forwards=n,
                                bucketed_forwards=n_long,
                                shapes=shapes, launches=counts,
                                k4_routes=routes, wall_s=wall,
                                packed_vs_bucketed_min_cos=float(cos.min()))
    emit("roberta_path", **out)
    _check_tcp("roberta_server", eng)


def phase_roformer_path():
    """roformer_chinese_base (12 layers, interleaved RoPE, 1,536
    positions): 48 K1 + 12 K2 a forward at B=128, L=256 and at B=16,
    L=1,536 (whole rows: under the rule's 1,920 at E=768), ragged, against
    the plain f32 forward on the same ids."""
    import torch
    from embeddings_tpu_torch.ops import attention as A
    out = _encoder_path("roformer")
    eng = STATE["roformer_engine"]
    Bx, Lx = ROFORMER_LONG
    rng = np.random.default_rng(9)
    ids = rng.integers(1000, 30000, ROFORMER_LONG).astype(np.int32)
    lens = rng.integers(1, Lx + 1, Bx)
    lens[0] = Lx
    mask = (np.arange(Lx)[None] < lens[:, None]).astype(np.int32)
    reset_counts()
    got, routes = _routed(A.fused_attention,
                          lambda: eng.forward(ids, mask))
    counts = read_counts()
    plain = _hf_engine("roformer", use_pallas="never",
                       compute_dtype="float32")
    cos = _row_cos(got, plain.forward(ids, mask))
    check(counts == only(K1=48, K2=12) and routes == {"sm90": 12},
          f"roformer at {ROFORMER_LONG}: {counts} (K2 {routes})")
    check(np.isfinite(got).all() and cos.min() >= 0.999,
          f"roformer at L={Lx} vs plain f32: {cos.min()}")
    STATE.setdefault("launches", {})["K2_roformer_long"] = counts["K2"]
    out["long"] = dict(batch=list(ROFORMER_LONG), lengths=lens.tolist(),
                       launches=counts, k2_routes=routes,
                       kernel_vs_plain_f32_min_cos=float(cos.min()))
    emit("roformer_path", **out)


def phase_albert_path():
    """albert-base-v2 (E_emb 128 projected to 768, one layer applied 12
    times, gelu_new): bf16 48 K1 + 12 K2 a forward; int8_compute 48 K3
    (one kept int8 weight a matmul, for all 12 applications) + 48 row
    quantizations + 12 K2, cosine >= 0.99 to bf16; CP on data 2 x seq 2
    at B=32, L=512 (192 K1 + 48 K8a) against the single-device forward
    and the plain f32 CP forward; TCP."""
    from embeddings_tpu_torch.ops.qmatmul import qmatmul_int8
    from embeddings_tpu_torch.ops.quant import QuantizedTensor
    out = _encoder_path("albert")
    out["model"] += (" (vocab 30522 in place of the published 30000: the "
                     "STS fixture's WordPiece ids reach 30521)")
    eng = STATE["albert_engine"]
    check(eng.params["layers"]["mlp"]["up"]["w"].codes.shape[0] == 1
          and "proj" in eng.params["embeddings"],
          "albert: the tree is not one shared layer with a projection")
    eng8 = _hf_engine("albert", int8_compute=True)
    kept = [w.int8 for w in (eng8.params["layers"]["attn"]["qkv"]["w"],
                             eng8.params["layers"]["attn"]["o"]["w"],
                             eng8.params["layers"]["mlp"]["up"]["w"],
                             eng8.params["layers"]["mlp"]["down"]["w"])
            if isinstance(w, QuantizedTensor)]
    check(len(kept) == 4 and all(k is not None and k[0].shape[0] == 1
                                 for k in kept),
          "albert int8: not one kept int8 weight a matmul")
    texts = _sts_sentences(300)
    emb8, counts8, n8, wall8 = _run_counted(eng8, texts)
    k3_routes = dict(qmatmul_int8.routes)
    STATE["launches"]["qmatmul_int8_albert"] = dict(qmatmul_int8.shapes)
    cos8 = _row_cos(emb8, eng.encode_batch(texts))
    check(counts8 == only(K2=12 * n8, K3=48 * n8, K3_rows=48 * n8)
          and sum(k3_routes.values()) == 48 * n8,
          f"albert int8: launches {counts8} (K3 {k3_routes}) over {n8}")
    check(np.isfinite(emb8).all() and cos8.min() >= 0.99,
          f"albert int8 vs bf16: {cos8.min()}")
    STATE["albert_engine8"] = eng8
    out["int8"] = dict(sentences=len(texts), forwards=n8, wall_s=wall8,
                       launches=counts8, k3_routes=k3_routes,
                       int8_vs_bf16_min_cos=float(cos8.min()),
                       int8_vs_bf16_mean_cos=float(cos8.mean()))
    saved = STATE.get("launches_K8a")  # the kernel table's: bge's CP
    out["cp"] = _cp_case(
        "albert", functools.partial(_hf_engine, "albert"),
        _hf_engine("albert", batch_size=CP_ALBERT[0]), CP_ALBERT,
        CP_ALBERT_MESH, 4, "K8a", only(K1=48, K2=12),
        [_joined(i * 60, 60) for i in range(CP_ALBERT[0])])
    if saved is not None:
        STATE["launches_K8a"] = saved
    emit("albert_path", **out)
    _check_tcp("albert_server", eng)


# ---------------------------------------------------------------------------
# nomic-embed-text-v2-moe: the mixture-of-experts interleave
# ---------------------------------------------------------------------------

def _moe_engine(dispatch: str = "auto", mesh=None, **ec):
    """nomic-embed-text-v2-moe at full width and depth from HF-named
    random weights (numpy seed 0, ``hf_state_dict``) through
    ``from_hf_state_dict`` and ``_build_moe_layers``: q4_0 packed + fused
    qkv on the attention and the dense half, the router and the experts
    dense (f32, as loaded), mean pooling, the STS fixture's WordPiece
    tokenizer. The tree is built once, moved to the card once and shared
    by every engine (bf16, int8, the plain f32 path, dense dispatch);
    ``dispatch`` sets ``moe_dispatch``; on a ("data", "model") ``mesh``
    the Engine shards the host tree (q/k/v apart, experts split)."""
    import torch
    from embeddings_tpu_torch import BertConfig, EngineConfig
    from embeddings_tpu_torch.models import params as P
    from embeddings_tpu_torch.runtime.engine import Engine
    from embeddings_tpu_torch.tokenizer import tokenizer_from_dir
    dev = torch.device("cuda")
    tok = tokenizer_from_dir(FIXTURE / "model")
    if "moe_params" not in STATE:
        d = ENC_CONFIGS["nomic_moe"][1]
        t0 = time.perf_counter()
        cfg = BertConfig.from_hf_dict(d)
        sd = hf_state_dict("nomic_moe", d, np.random.default_rng(0))
        unfused = P.pack_q4_params(P.quantize_params(
            P.from_hf_state_dict(sd, cfg), "q4_0"))
        STATE["moe_params_unfused"] = unfused  # on the host, for TP
        params = P.to_device(P.fuse_qkv(unfused), dev)
        torch.cuda.synchronize()
        cfg = dataclasses.replace(
            cfg, pooling="mean", cls_token_id=tok.cls_id,
            sep_token_id=tok.sep_id, unk_token_id=tok.unk_id,
            pad_token_id=tok.pad_id)
        STATE["moe_params"] = (cfg, params, time.perf_counter() - t0)
    cfg, params, _ = STATE["moe_params"]
    ec = {"batch_size": MOE_SHORT[0], "max_seq_len": MOE_LONG[1], **ec}
    if mesh is not None:
        params, dev = STATE["moe_params_unfused"], None
    return Engine(params, dataclasses.replace(cfg, moe_dispatch=dispatch),
                  tok, EngineConfig(**ec), device=dev, mesh=mesh)


@contextlib.contextmanager
def routed_experts():
    """The top-k expert indices each MoE layer's ragged route picks inside
    the block, in call order ([T, k] tensors); yields the list."""
    from embeddings_tpu_torch.ops import moe as Mo
    seen, orig = [], Mo.topk_lower_first

    def spy(probs, k):
        out = orig(probs, k)
        seen.append(out[1])
        return out
    Mo.topk_lower_first = spy
    try:
        yield seen
    finally:
        Mo.topk_lower_first = orig


def moe_counts() -> tuple[int, int]:
    """(host reads, expert products) the ragged MoE route has made."""
    from embeddings_tpu_torch.ops.moe import moe_ffn_ragged
    return moe_ffn_ragged.host_reads, moe_ffn_ragged.expert_gemms


def _moe_forward(eng, ids, mask):
    """One forward's embeddings, launch counts, MoE host reads and expert
    products, the experts it routed to and its plain-version calls."""
    import torch
    reads, gemms = moe_counts()
    with plain_calls() as calls, routed_experts() as experts:
        reset_counts()
        emb = eng.forward(ids, mask)
        torch.cuda.synchronize()
    r2, g2 = moe_counts()
    return emb, read_counts(), r2 - reads, g2 - gemms, experts, dict(calls)


def _moe_counted(eng, texts):
    """encode_batch with its launch counts, MoE host reads and expert
    products, and its plain-version calls."""
    reads, gemms = moe_counts()
    with plain_calls() as calls:
        emb, counts, n, wall = _run_counted(eng, texts)
    r2, g2 = moe_counts()
    return emb, counts, n, wall, r2 - reads, g2 - gemms, dict(calls)


def phase_moe_path():
    """nomic-embed-text-v2-moe (12 layers, the 6 odd ones an MoE FFN of 8
    experts routed top-2) q4_0 packed + fused qkv through Engine: a
    bucketed forward runs 36 K1 (qkv and o everywhere, up and down on the
    dense half) + 12 K2 (K6 at B=4, L=2,048, past the whole-row rule; the
    int8 mode 36 K3 + 36 row quantizations), packed rows of 128 36 K1 +
    12 K4; every attention launch on "sm90", no plain-version call, one
    host read, at most 16 expert products (2 a non-empty expert) and one
    combine (``csrc/moe_combine.cu``) a MoE layer. Cosine >= 0.999 to
    the plain f32 path on the card (the same tree dequantized, experts in
    f32; its combine the kernel too: the card's tensors take it), of
    ragged to dense dispatch
    and of packed to bucketed; >= 0.99 of int8 to bf16; the trained
    ``tiny_trained_moe`` on the card against the port on the CPU; TCP."""
    import torch
    from embeddings_tpu_torch import KNOWN_MODELS, load_model
    from embeddings_tpu_torch.ops import attention as A, moe as Mo
    t0 = time.perf_counter()
    eng = _moe_engine()
    cfg = eng.config
    preset = KNOWN_MODELS["nomic-embed-text-v2-moe"]
    check(all(getattr(cfg, k) == v for k, v in preset.items()),
          "nomic_moe config differs from the repo preset: "
          + str({k: getattr(cfg, k) for k in preset}))
    plain = _moe_engine(use_pallas="never", compute_dtype="float32")
    dense = _moe_engine("dense")
    eng8 = _moe_engine(int8_compute=True)
    n_moe = MOE_NL // 2
    out = {"model": f"{ENC_CONFIGS['nomic_moe'][0]} (HF-named random "
           f"weights, numpy seed 0, vocab {cfg.vocab_size}) q4_0 packed + "
           f"fused qkv, experts and router dense",
           "init_quantize_s": STATE["moe_params"][2]}

    # (a) STS sentences through encode_batch
    texts = _sts_sentences(300)
    texts += texts[:8]  # identical sentences: cosine 1.0
    (emb, counts, n, wall, reads, gemms, calls), k2_routes = _routed(
        A.fused_attention, lambda: _moe_counted(eng, texts))
    ref = plain.encode_batch(texts)
    cos = _row_cos(emb, ref)
    cos_dense = _row_cos(emb, dense.encode_batch(texts))
    norms = np.linalg.norm(emb, axis=1)
    dup = (emb[:8] * emb[-8:]).sum(-1)
    check(np.isfinite(emb).all() and emb.shape == (len(texts), E),
          "moe: output not finite / wrong shape")
    check(counts == only(K1=MOE_K1 * n, K2=MOE_NL * n)
          and k2_routes == {"sm90": MOE_NL * n},
          f"moe: launches {counts} (K2 {k2_routes}) over {n} forwards")
    check(not any(calls.values()), f"moe: plain-version calls {calls}")
    check(reads == n_moe * n and 2 * n_moe * n <= gemms <= 16 * n_moe * n,
          f"moe: {reads} host reads, {gemms} expert products over {n} "
          f"forwards")
    check(np.abs(norms - 1).max() < 1e-3, "moe: not unit norm")
    # not bit for bit: a batch's routing (its pad slots too) sets each
    # expert's row count, and the library's product may take another
    # algorithm (another summation order) at another count
    check(dup.min() >= 0.999, f"moe: identical sentences at {dup.min()}")
    check(cos.min() >= 0.999, f"moe vs plain f32: {cos.min()}")
    check(cos_dense.min() >= 0.999, f"moe ragged vs dense: {cos_dense.min()}")
    out["sts"] = dict(sentences=len(texts), forwards=n, wall_s=wall,
                      launches=counts, k2_routes=k2_routes,
                      host_reads=reads, expert_gemms=gemms,
                      norm_min=float(norms.min()),
                      identical_min_cos=float(dup.min()),
                      kernel_vs_plain_f32_min_cos=float(cos.min()),
                      ragged_vs_dense_min_cos=float(cos_dense.min()))

    # (b) one forward at B=128, L=256: exact counts, routing against the
    # plain f32 path's
    rng = np.random.default_rng(8)
    ids = rng.integers(1000, 30000, MOE_SHORT).astype(np.int32)
    mask = np.ones(MOE_SHORT, np.int32)
    combines = Mo.moe_ffn_ragged.combines
    emb, one, reads, gemms, experts, calls = _moe_forward(eng, ids, mask)
    combines = Mo.moe_ffn_ragged.combines - combines
    check(combines == n_moe, f"moe at {MOE_SHORT}: {combines} combines, "
          f"want {n_moe}")
    STATE["combines_nomic"] = combines
    pemb, _, _, _, pexperts, _ = _moe_forward(plain, ids, mask)
    demb = dense.forward(ids, mask)
    check(one == only(K1=MOE_K1, K2=MOE_NL) and not any(calls.values()),
          f"moe at {MOE_SHORT}: {one}, plain calls {calls}")
    check(reads == n_moe and len(experts) == n_moe
          and 2 * n_moe <= gemms <= 16 * n_moe,
          f"moe at {MOE_SHORT}: {reads} host reads, {gemms} products")
    same = [float((a.sort(-1).values == b.sort(-1).values).all(-1)
                  .float().mean()) for a, b in zip(experts, pexperts)]
    hist = [torch.bincount(a.reshape(-1), minlength=MOE_EXPERTS).tolist()
            for a in experts]
    cos = _row_cos(emb, pemb)
    cos_dense = _row_cos(emb, demb)
    check(cos.min() >= 0.999 and cos_dense.min() >= 0.999,
          f"moe at {MOE_SHORT}: vs plain f32 {cos.min()}, vs dense "
          f"{cos_dense.min()}")
    out["forward"] = dict(batch=list(MOE_SHORT), launches=one,
                          combines_per_forward=combines,
                          host_reads_per_forward=reads,
                          expert_gemms_per_forward=gemms,
                          top2_same_as_f32_share=same,
                          tokens_per_expert=hist,
                          kernel_vs_plain_f32_min_cos=float(cos.min()),
                          ragged_vs_dense_min_cos=float(cos_dense.min()))

    # (c) the int8 mode at that shape: K3 on the kept int8 weights
    emb8, c8, reads8, _, _, calls8 = _moe_forward(eng8, ids, mask)
    cos8 = _row_cos(emb8, emb)
    check(c8 == only(K3=MOE_K1, K3_rows=MOE_K1, K2=MOE_NL)
          and not any(calls8.values()) and reads8 == n_moe,
          f"moe int8: {c8}, plain calls {calls8}, {reads8} host reads")
    check(cos8.min() >= 0.99, f"moe int8 vs bf16: {cos8.min()}")
    out["int8"] = dict(batch=list(MOE_SHORT), launches=c8,
                       int8_vs_bf16_min_cos=float(cos8.min()),
                       int8_vs_bf16_mean_cos=float(cos8.mean()))

    # (d) rows of 2,048: K6 past the whole-row rule
    long_eng = _moe_engine(batch_size=MOE_LONG[0])
    long_plain = _moe_engine(batch_size=MOE_LONG[0], use_pallas="never",
                             compute_dtype="float32")
    long_txt = [_joined(i * 250, 250) for i in range(MOE_LONG[0])]
    check(all(len(long_eng.tokenize(t)) == MOE_LONG[1] for t in long_txt),
          f"long texts do not fill L={MOE_LONG[1]}")
    (lemb, lc, ln_, lwall, lreads, lgemms, lcalls), k6_routes = _routed(
        A.fused_attention_stream, lambda: _moe_counted(long_eng, long_txt))
    lcos = _row_cos(lemb, long_plain.encode_batch(long_txt))
    check(ln_ == 1 and lc == only(K1=MOE_K1, K6=MOE_NL)
          and k6_routes == {"sm90": MOE_NL} and not any(lcalls.values()),
          f"moe long: {lc} (K6 {k6_routes}) over {ln_} forwards, plain "
          f"calls {lcalls}")
    check(lcos.min() >= 0.999, f"moe long vs plain f32: {lcos.min()}")
    out["long"] = dict(batch=list(MOE_LONG), launches=lc,
                       k6_routes=k6_routes, wall_s=lwall, host_reads=lreads,
                       expert_gemms=lgemms,
                       kernel_vs_plain_f32_min_cos=float(lcos.min()))

    # (e) token-packed rows of 128, 256 rows a batch (pad slots routed too)
    ptexts = _sts_sentences(2400)
    pref = eng.encode_batch(ptexts)
    over = [t for t in ptexts if len(eng.tokenize(t)) > MOE_PACK[1]]
    n_over = n_bucketed_forwards(eng, over) if over else 0
    shapes, run = [], eng._forward_packed

    def spy(pids, seg, pos, pool, attn_window=0):
        shapes.append(list(pids.shape))
        return run(pids, seg, pos, pool, attn_window)

    eng._forward_packed = spy
    try:
        with plain_calls() as pcalls:
            reset_counts()
            pemb = eng.encode_batch_packed(ptexts, row_len=MOE_PACK[1],
                                           batch_rows=MOE_PACK[0])
            torch.cuda.synchronize()
        pc = read_counts()
    finally:
        del eng._forward_packed  # back to the class method
    k4_routes = dict(A.fused_attention_segmented.routes)
    np_ = len(shapes)
    pcos = _row_cos(pemb, pref)
    check(np_ >= 1 and pc == only(K1=MOE_K1 * (np_ + n_over),
                                  K2=MOE_NL * n_over, K4=MOE_NL * np_)
          and k4_routes == {"sm90": MOE_NL * np_}
          and not any(pcalls.values()),
          f"moe packed: {pc} (K4 {k4_routes}) over {np_} packed forwards, "
          f"plain calls {dict(pcalls)}")
    check(np.isfinite(pemb).all() and pcos.min() >= 0.999,
          f"moe packed vs bucketed: {pcos.min()}")
    out["packed"] = dict(sentences=len(ptexts), packed_forwards=np_,
                         bucketed_forwards=n_over, shapes=shapes,
                         launches=pc, k4_routes=k4_routes,
                         packed_vs_bucketed_min_cos=float(pcos.min()))

    # (f) the trained fixture: the card against the port on the CPU
    ttexts = _sts_sentences(200)
    card = load_model(MOE_FIXTURE / "model", dtype="q4_0",
                      device=torch.device("cuda"))
    cpu = load_model(MOE_FIXTURE / "model", dtype="q4_0", device="cpu")
    tcos = _row_cos(card.encode_batch(ttexts), cpu.encode_batch(ttexts))
    check(tcos.min() >= 0.999, f"tiny_trained_moe card vs CPU: {tcos.min()}")
    out["trained"] = dict(model=str(MOE_FIXTURE.relative_to(ROOT) / "model"),
                          sentences=len(ttexts),
                          card_vs_cpu_min_cos=float(tcos.min()))
    out["phase_s"] = time.perf_counter() - t0
    STATE.update(moe_engine=eng, moe_engine8=eng8, moe_long_engine=long_eng)
    emit("moe_path", **out)
    _check_tcp("moe_server", eng)


def layout_name(layout) -> str:
    kind, packed = layout
    return f"{kind} {'packed' if packed else 'int8 codes'}"


def _k1_file_layouts() -> dict:
    """K1 against its plain version at bge's four shapes (M = 32,768) on
    each weight layout a file gives it beyond q4_0 packed: q4_0 and q8_0
    int8 codes (a quantized file at the default dtype), q4_1 packed."""
    import torch
    from embeddings_tpu_torch.ops.qmatmul import qmatmul, qmatmul_ref
    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    out = {}
    for layout in FILE_LAYOUTS:
        rows = out[layout_name(layout)] = {}
        for name, (K, N, epi) in K1_SHAPES.items():
            args, kw, _ = k1_inputs(rng, M, K, N, *layout, epi, dev)
            got = qmatmul(*args.values(), **kw)
            ref = qmatmul_ref(*args.values(), **kw)
            torch.cuda.synchronize()
            rows[name] = compare(got, ref, K1_RTOL, K1_ATOL_RMS)
            check(rows[name]["ok"], f"K1 {name} on {layout_name(layout)} "
                  f"disagrees: {rows[name]}")
            del got, ref
    RESULTS["k1_file_layouts"] = out
    return {k: max(r["max_abs_err"] for r in v.values())
            for k, v in out.items()}


def _bge_f32():
    """bge-base's f32 tree from numpy seed 0 (the tree ``_bge_base_engine``
    quantizes), its config and a WordPiece vocabulary of the table's
    size: the STS fixture's tokens, padded."""
    from embeddings_tpu_torch import BertConfig, KNOWN_MODELS
    from embeddings_tpu_torch.models import params as P
    if "bge_f32" not in STATE:
        cfg = BertConfig(**{**KNOWN_MODELS["bge-base-en-v1.5"],
                            "vocab_size": 30528})
        vocab = (FIXTURE / "model" / "vocab.txt").read_text(
            encoding="utf-8").splitlines()
        vocab += [f"[pad{i}]" for i in range(cfg.vocab_size - len(vocab))]
        STATE["bge_f32"] = (cfg, P.init_params(
            cfg, np.random.default_rng(0)), vocab)
    return STATE["bge_f32"]


def _file_engine(path, dtype: str = "f32", **ec):
    """load_model(path) on the card, CLS pooling (bge's), batches of 128."""
    import torch
    from embeddings_tpu_torch import EngineConfig, load_model
    return load_model(path, dtype=dtype, pooling="cls",
                      device=torch.device("cuda"),
                      engine_config=EngineConfig(**{"batch_size": 128,
                                                    **ec}))


def _file_case(name: str, path, dtype: str, texts) -> dict:
    """One file through load_model(path, dtype=) and encode_batch: every
    matmul a K1 launch on the QuantizedTensor the file (or the load's
    quantization) gave, every attention a K2 on the Hopper kernel: 48 K1
    + 12 K2 a forward, and again at B=128, L=256; cosine >= 0.999 to the
    plain f32 path on the same loaded params. The engine is kept for
    ``timing``."""
    import torch
    from embeddings_tpu_torch import EngineConfig
    from embeddings_tpu_torch.ops import attention as A
    from embeddings_tpu_torch.ops.qmatmul import qmatmul
    from embeddings_tpu_torch.ops.quant import QuantizedTensor
    from embeddings_tpu_torch.runtime.engine import Engine
    t0 = time.perf_counter()
    eng = _file_engine(path, dtype)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    w = eng.params["layers"]["mlp"]["up"]["w"]
    check(isinstance(w, QuantizedTensor), f"{name}: dense weights")
    (emb, counts, n, wall), routes = _routed(
        A.fused_attention, lambda: _run_counted(eng, texts))
    STATE.setdefault("launches", {})["qmatmul_" + name] = dict(
        qmatmul.shapes)
    ids = np.random.default_rng(8).integers(1000, 30000, (B, L)).astype(
        np.int32)
    reset_counts()
    eng._forward(ids, np.ones((B, L), np.int32))
    torch.cuda.synchronize()
    one = read_counts()
    plain = Engine(eng.params, eng.config, eng.tokenizer,
                   EngineConfig(batch_size=128, use_pallas="never",
                                compute_dtype="float32"),
                   device=torch.device("cuda"))
    cos = _row_cos(emb, plain.encode_batch(texts))
    check(np.isfinite(emb).all() and emb.shape == (len(texts), E),
          f"{name}: output not finite / wrong shape")
    check(counts == only(K1=4 * NL * n, K2=NL * n)
          and routes == {"sm90": NL * n},
          f"{name}: launches {counts} (K2 {routes}) over {n} forwards")
    check(one == only(K1=4 * NL, K2=NL), f"{name} at {(B, L)}: {one}")
    check(cos.min() >= 0.999, f"{name}: kernel path vs plain f32 "
          f"{cos.min()}")
    STATE[name + "_engine"] = eng
    return dict(load_dtype=dtype, weights=f"{w.kind}"
                + (" packed" if w.packed else " int8 codes"),
                load_s=load_s, forwards=n, wall_s=wall,
                launches=nonzero(counts), k2_routes=routes,
                launches_at_B128_L256=nonzero(one),
                kernel_vs_plain_f32_min_cos=float(cos.min()), emb=emb)


def _dense_tables_diff(name: str, params, texts, ref) -> float:
    """The file engine ``name`` with its position and token-type tables
    (2-D '.weight' tensors, so q4_0 in the file, dequantized on load;
    ``quantize_params`` keeps them dense) put back to the f32 tree's:
    max abs difference of its embeddings from ``_bge_base_engine``'s."""
    import torch
    from embeddings_tpu_torch import EngineConfig
    from embeddings_tpu_torch.runtime.engine import Engine
    eng = STATE[name + "_engine"]
    tree = {**eng.params, "embeddings": {
        **eng.params["embeddings"],
        **{k: params["embeddings"][k].to(eng.device)
           for k in ("position", "token_type")}}}
    emb = Engine(tree, eng.config, eng.tokenizer,
                 EngineConfig(batch_size=128),
                 device=torch.device("cuda")).encode_batch(texts)
    return float(np.abs(emb - ref).max())


def _file_path(fmt: str, files: dict) -> dict:
    """bge-base's f32 tree through the port's writer of ``fmt`` in each
    kind of ``files``, then each file through ``_file_case`` with each of
    its load dtypes; the q4_0 file loaded q4_0 against
    ``_bge_base_engine``'s embeddings (the same quantize_q4_0 codes)."""
    import tempfile
    from embeddings_tpu_torch.models import ggml_io, gguf_io
    write = ggml_io.write_ggml if fmt == "bin" else gguf_io.write_gguf
    cfg, params, vocab = _bge_f32()
    texts = _sts_sentences(120)
    texts += texts[:8]  # identical sentences: cosine 1.0
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for kind, dtypes in files.items():
            path = Path(tmp) / f"bge-base-{kind}.{fmt}"
            t0 = time.perf_counter()
            write(path, params, cfg, vocab, dtype=kind)
            row = {"write_s": time.perf_counter() - t0,
                   "bytes": path.stat().st_size}
            for dtype in dtypes:
                name = file_engine_name(fmt, kind, dtype)
                row[name] = case = _file_case(name, path, dtype, texts)
                emb = case.pop("emb")
                dup = (emb[:8] * emb[-8:]).sum(-1)
                check(dup.min() >= 1 - 1e-6, f"{name}: identical sentences "
                      f"differ")
                if kind == "q4_0" and dtype == "q4_0":
                    if "bge_q4_0_emb" not in STATE:
                        STATE["bge_q4_0_emb"] = \
                            _bge_base_engine().encode_batch(texts)
                    ref = STATE["bge_q4_0_emb"]
                    case["vs_bge_base_engine"] = dict(
                        max_abs_diff=float(np.abs(emb - ref).max()),
                        min_cos=float(_row_cos(emb, ref).min()),
                        dense_tables_max_abs_diff=_dense_tables_diff(
                            name, params, texts, ref))
            out[kind] = row
    return out


def phase_ggml_path():
    """bge-base (E=768, 12 layers, CLS) through the port's write_ggml in
    q4_0 and q4_1 and load_model(.bin): unpacked int8 codes (default
    dtype) and packed (the file's q4 kind), 48 K1 + 12 K2 a forward,
    cosine >= 0.999 to the plain f32 path; the q4_0 file against
    ``_bge_base_engine``; the reference's own ggml-model-f32.bin
    against its HF directory on the card; K1 at bge's shapes on each
    weight layout the files give it (``_k1_file_layouts``)."""
    out = {"k1_layouts_max_abs_err": _k1_file_layouts(),
           **_file_path("bin", GGML_FILES)}
    texts = _sts_sentences(64)
    a = _file_engine(REF_PARITY / "ggml-model-f32.bin").encode_batch(texts)
    ref = _file_engine(REF_PARITY).encode_batch(texts)
    diff = float(np.abs(a - ref).max())
    check(np.isfinite(a).all() and diff <= 1e-6,
          f"reference .bin vs its HF directory: {diff}")
    out["reference_f32_bin_vs_hf_dir"] = dict(texts=len(texts),
                                              max_abs_diff=diff)
    emit("ggml_path", model="bge-base-en-v1.5 shape (random init, numpy "
         "seed 0, vocab 30528) via write_ggml -> load_model", **out)


def phase_gguf_path():
    """The same tree through the port's write_gguf in q4_0 (loaded packed
    and as int8 codes), q8_0 (as it is), f16 and q4_K (both quantized to
    q4_0 on load; the K-quants decode to f32 first, as in JAX): 48 K1 +
    12 K2 a forward, cosine >= 0.999 to the plain f32 path; each file's
    write and load seconds."""
    emit("gguf_path", model="bge-base-en-v1.5 shape (random init, numpy "
         "seed 0, vocab 30528) via write_gguf -> load_model, every file "
         "at full depth", **_file_path("gguf", GGUF_FILES))


def _pair_tokenizer():
    """An XLM-R-style Unigram tokenizer (<s> <pad> </s> <unk> = 0-3, pairs
    as <s> a </s></s> b </s>, one token type) from (piece, score) pairs,
    as a GGUF's "t5" vocabulary builds one: the STS fixture's words as
    pieces scored by their log frequency, and its characters."""
    import math
    from collections import Counter
    from embeddings_tpu_torch.tokenizer import UnigramTokenizer
    words = Counter(w for t in _sts_sentences(2400) for w in t.split())
    total = sum(words.values())
    chars = sorted({c for w in words for c in w})
    pieces = [("<s>", 0.0), ("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0),
              ("▁", -8.0)]
    pieces += [("▁" + w, math.log(n / total))
               for w, n in words.most_common()]
    pieces += [(c, -20.0) for c in chars]
    return UnigramTokenizer(pieces, unk_id=3)


def _reranker_engine(**ec):
    """bge-reranker-base at its published config (XLM-R, vocab 250,002,
    classifier.dense -> out_proj) from HF-named random weights (numpy seed
    0) through ``from_hf_state_dict``, q4_0 packed + fused qkv, with
    ``_pair_tokenizer``; on the card. The tree is built once."""
    import torch
    from embeddings_tpu_torch import BertConfig, EngineConfig
    from embeddings_tpu_torch.models import params as P
    from embeddings_tpu_torch.runtime.engine import Engine
    if "reranker_params" not in STATE:
        d = ENC_CONFIGS["xlmr_reranker"][1]
        t0 = time.perf_counter()
        cfg = BertConfig.from_hf_dict(d)
        tok = _pair_tokenizer()
        params = P.fuse_qkv(P.pack_q4_params(P.quantize_params(
            P.from_hf_state_dict(hf_state_dict(
                "xlmr_reranker", d, np.random.default_rng(0)), cfg),
            "q4_0")))
        STATE["reranker_params"] = (cfg, tok, params,
                                    time.perf_counter() - t0)
    cfg, tok, params, _ = STATE["reranker_params"]
    return Engine(params, cfg, tok, EngineConfig(**{
        "batch_size": 128, "max_seq_len": 512, **ec}),
        device=torch.device("cuda"))


def _cls_rows(eng, pairs):
    """The CLS rows (the head's input) of the pairs, one padded batch,
    through the engine's path."""
    import torch
    from embeddings_tpu_torch.models import bert
    from embeddings_tpu_torch.runtime.batching import pad_batch
    ids, mask = pad_batch([p[0] for p in pairs], len(pairs),
                          max(len(p[0]) for p in pairs),
                          eng.tokenizer.pad_id)

    def dev(a):
        return torch.from_numpy(a).to(eng.device)

    with torch.inference_mode():
        h = bert.encode_tokens(
            eng.params, eng.config, dev(ids), dev(mask),
            type_ids=dev(np.zeros_like(ids)), return_hidden=True,
            compute_dtype=eng._compute_dtype, use_kernels=eng._use_kernels)
    return h[:, 0].cpu().numpy()


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def phase_rerank_path():
    """bge-reranker-base q4_0 through Engine.rerank(query, 128 STS
    documents): 48 K1 + 12 K2 a forward (every K2 on the Hopper kernel),
    and again at B=128, L=256; against the plain f32 path of the same
    tree: the CLS rows at cosine >= 0.999, the logits (score_pairs) at
    Pearson >= RERANK_PEARSON, their max abs error reported."""
    import torch
    from embeddings_tpu_torch.ops import attention as A
    from embeddings_tpu_torch.runtime.batching import extend_buckets, \
        plan_batches
    eng = _reranker_engine()
    check("dense" in eng.params["cls_head"]
          and eng.params["layers"]["mlp"]["up"]["w"].packed,
          "reranker: no RoBERTa-style head or unpacked weights")
    sts = _sts_sentences(RERANK_DOCS + 1)
    query, docs = sts[0], sts[1:]
    pairs = [eng.tokenizer.encode_pair(query, doc, max_len=eng.max_seq_len)
             for doc in docs]
    ec = eng.engine_config
    n = len(plan_batches([len(p[0]) for p in pairs], ec.batch_size,
                         eng._seq_buckets(),
                         extend_buckets(ec.batch_buckets, ec.batch_size)))
    reset_counts()
    t0 = time.perf_counter()
    scores, routes = _routed(A.fused_attention,
                             lambda: eng.rerank(query, docs))
    wall = time.perf_counter() - t0
    counts = read_counts()
    ids = np.random.default_rng(8).integers(
        5, eng.config.vocab_size, (B, L)).astype(np.int32)
    reset_counts()
    eng._forward_pairs(ids, np.zeros_like(ids), np.ones_like(ids))
    torch.cuda.synchronize()
    one = read_counts()
    plain = _reranker_engine(use_pallas="never", compute_dtype="float32")
    ref = plain.rerank(query, docs)
    cls_cos = _row_cos(_cls_rows(eng, pairs), _cls_rows(plain, pairs))
    err = float(np.abs(scores - ref).max())
    std = float(ref.std())
    pearson = float(np.corrcoef(scores, ref)[0, 1])
    check(np.isfinite(scores).all() and scores.shape == (RERANK_DOCS,),
          "reranker: logits not finite / wrong shape")
    check(counts == only(K1=4 * NL * n, K2=NL * n)
          and routes == {"sm90": NL * n},
          f"reranker: launches {counts} (K2 {routes}) over {n} forwards")
    check(one == only(K1=4 * NL, K2=NL), f"reranker at {(B, L)}: {one}")
    check(cls_cos.min() >= 0.999,
          f"reranker CLS rows vs plain f32: {cls_cos.min()}")
    check(pearson >= RERANK_PEARSON,
          f"reranker vs plain f32: Pearson {pearson}, max abs {err} "
          f"(std {std})")
    STATE["reranker_engine"] = eng
    emit("rerank_path", model=f"{ENC_CONFIGS['xlmr_reranker'][0]} "
         "(XLMRobertaForSequenceClassification, HF-named random weights, "
         "numpy seed 0, vocab 250002) q4_0 packed + fused qkv, Unigram "
         "pairs from (piece, score)", init_quantize_s=STATE[
             "reranker_params"][3], documents=len(docs),
         pair_tokens=[min(len(p[0]) for p in pairs),
                      max(len(p[0]) for p in pairs)],
         forwards=n, wall_s=wall, launches=nonzero(counts),
         k2_routes=routes, launches_at_B128_L256=nonzero(one),
         cls_rows_min_cos=float(cls_cos.min()), max_abs_err=err,
         plain_logits_std=std, plain_logits_mean=float(ref.mean()),
         pearson=pearson, tolerance=f"CLS rows cosine >= 0.999; logits "
         f"Pearson >= {RERANK_PEARSON} (max abs err reported)")


def _first_positions_cos(engines, text: str) -> float:
    """Min cosine between the causal and the bidirectional hidden states
    of one text's first 64 positions, through the kernels (the row padded
    to L=512: K6c and K2)."""
    import torch
    from embeddings_tpu_torch.models import bert
    from embeddings_tpu_torch.runtime.batching import pad_batch
    eng = engines["causal"]
    ids, mask = pad_batch([eng.tokenize(text)], 1, QW_SHORT[1],
                          eng.tokenizer.pad_id)
    h = {}
    with torch.inference_mode():
        for form, e in engines.items():
            h[form] = bert.encode_tokens(
                e.params, e.config, torch.from_numpy(ids).to(e.device),
                torch.from_numpy(mask).to(e.device),
                compute_dtype=e._compute_dtype, return_hidden=True)[0, :64]
    cos = torch.nn.functional.cosine_similarity(h["causal"],
                                                h["bidirectional"], dim=-1)
    return float(cos.min())


def phase_timing():
    import torch
    from embeddings_tpu_torch.ops import attention as A
    from embeddings_tpu_torch.ops.qmatmul import keep_int8_weight, \
        qmatmul_int8, qmatmul_int8_ref, quantize_rows
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    saved = read_counts()  # timing launches are not main-path launches
    launches = STATE.get("launches", {})
    ids = rng.integers(1000, 30000, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    # forward -> (call, the kernels one forward launches): the forwards
    # and kernel rows of the phases that ran (every one by default; e.g.
    # --phases device,build,k6w,modernbert_path,timing times ModernBERT's
    # forwards and K6w's rows alone)
    bge = {0: NL}  # K2 on every layer
    runs = {}
    if "engine" in STATE:
        eng = STATE["engine"]
        runs["bf16"] = (lambda: eng._forward(ids, mask),
                        launches_want(4 * NL, bge))
    if "engine8" in STATE:
        # K3 on int8 operands, each matmul's rows quantized first; no
        # requantization (the Engine keeps the int8 weights)
        runs["int8"] = (lambda: STATE["engine8"]._forward(ids, mask),
                        launches_want(4 * NL, bge,
                                      quant_rows_kernel=4 * NL))

        def scores_on():
            with A.int8_scores_mode("on"):
                return STATE["engine8"]._forward(ids, mask)
        # the same forward with int8 scores (no links): K2i8 in K2's place
        runs["int8_scores"] = (scores_on, launches_want(
            4 * NL, {("i8s", "no"): NL}, quant_rows_kernel=4 * NL))
    for name, mode in (("K4", 1), ("K5", 2)):
        if name in STATE:
            arrays, W = STATE[name][2], STATE[name][3]
            runs[name] = (lambda a=arrays, w=W: eng._forward_packed(*a, w),
                          launches_want(4 * NL, {mode: NL}))
    # the families' forwards: name -> (engine, shape, K1 launches a
    # forward, {attention mode: launches a forward}, head dim)
    mb_k1 = 5 * MB_NL
    families = {"mpnet": ("mpnet_engine", MPNET_SHAPE, 4 * NL, {3: NL}, D),
                "jina_long": ("jina_engine", JINA_LONG, 5 * NL, {5: NL}, D),
                "jina_short": ("jina_engine", JINA_SHORT, 5 * NL, {3: NL},
                               D),
                "jina_causal_long": ("jina_causal_engine", JINA_LONG,
                                     5 * NL, {8: NL}, D),
                "bert_long": ("bert_long_engine", BERT_LONG, 4 * NL,
                              {4: NL}, D),
                "modernbert_long": ("modernbert_engine", MB_LONG, mb_k1,
                                    {4: MB_GLOBAL, 6: MB_LOCAL}, D),
                "modernbert_short": ("modernbert_engine", MB_SHORT, mb_k1,
                                     {0: MB_GLOBAL, 6: MB_LOCAL}, D),
                "qwen2_causal_short": ("qwen2_causal_engine", QW_SHORT,
                                       QW_K1, {7: QW_NL}, QW_D),
                "qwen2_causal_long": ("qwen2_causal_engine", QW_LONG,
                                      QW_K1, {7: QW_NL}, QW_D),
                "qwen2_bidir_short": ("qwen2_bidir_engine", QW_SHORT,
                                      QW_K1, {0: QW_NL}, QW_D),
                "qwen2_bidir_long": ("qwen2_bidir_engine", QW_LONG,
                                     QW_K1, {4: QW_NL}, QW_D),
                # CP forwards (K8a / K8b are mode 4 of the Hopper kernel
                # in the CP layout) and the single-device forwards at
                # their shapes (K2; K6 plain)
                "cp_bge": ("cp_bge_engine", CP_BGE, 4 * NL * 4,
                           {cp_kernel(CP_BGE, CP_BGE_MESH): NL * 4}, D),
                "cp_bge_single": ("cp_bge_single", CP_BGE, 4 * NL, {0: NL},
                                  D),
                "cp_nomic": ("cp_nomic_engine", CP_NOMIC, 5 * NL * 4,
                             {cp_kernel(CP_NOMIC, CP_NOMIC_MESH): NL * 4},
                             D),
                "cp_nomic_single": ("cp_nomic_single", CP_NOMIC, 5 * NL,
                                    {4: NL}, D),
                # data x model meshes (q, k, v, o, up, down a layer a
                # shard; K2 on the shard's heads) and the single-device
                # forward at their shape
                **{f"tp_bge_{dp}x{tp}": (f"tp_bge_{dp}x{tp}_engine",
                                         TP_SHAPE, 6 * NL * dp * tp,
                                         {0: NL * dp * tp}, D)
                   for dp, tp in TP_MESHES},
                "tp_bge_single": ("tp_bge_single", TP_SHAPE, 4 * NL,
                                  {0: NL}, D),
                # the encoder families on K1 and K2 alone
                "distilbert": ("distilbert_engine", ENC_SHAPE, 24, {0: 6},
                               D),
                "distilroberta": ("roberta_engine", ENC_SHAPE, 24, {0: 6},
                                  D),
                "roformer": ("roformer_engine", ENC_SHAPE, 4 * NL,
                             {0: NL}, D),
                "roformer_long": ("roformer_engine", ROFORMER_LONG, 4 * NL,
                                  {0: NL}, D),
                "albert": ("albert_engine", ENC_SHAPE, 4 * NL, {0: NL}, D),
                # nomic-embed-text-v2-moe: K2 at B=128, L=256, K6 at
                # B=4, L=2,048; the experts' products torch's
                "nomic_moe": ("moe_engine", MOE_SHORT, MOE_K1, {0: MOE_NL},
                              D),
                "nomic_moe_long": ("moe_long_engine", MOE_LONG, MOE_K1,
                                   {4: MOE_NL}, D),
                # bge-base loaded from the port's .bin and .gguf files
                **{name: (name + "_engine", ENC_SHAPE, 4 * NL, {0: NL}, D)
                   for name in FILE_ENGINES}}
    for name, (key, shape, k1, attn, dh) in families.items():
        if key in STATE:
            fids = rng.integers(1000, 30000, shape).astype(np.int32)
            runs[name] = (lambda e=STATE[key], i=fids: e._forward(
                i, np.ones_like(i)),
                launches_want(k1, attn, dh, shape[1],
                              weights=weights_spec(STATE[key]),
                              **(MOE_COMBINE_WANT
                                 if name.startswith("nomic_moe") else {})))
    if "albert_engine8" in STATE:
        # ALBERT's int8 forward: K3 on its one kept weight a matmul
        aids = rng.integers(1000, 30000, ENC_SHAPE).astype(np.int32)
        runs["albert_int8"] = (
            lambda: STATE["albert_engine8"]._forward(aids,
                                                     np.ones_like(aids)),
            launches_want(4 * NL, {0: NL}, quant_rows_kernel=4 * NL))
    if "moe_engine8" in STATE:
        # the MoE model's int8 forward: K3 on the attention and the
        # dense half, the experts in bf16
        mids = rng.integers(1000, 30000, MOE_SHORT).astype(np.int32)
        runs["nomic_moe_int8"] = (
            lambda: STATE["moe_engine8"]._forward(mids, np.ones_like(mids)),
            launches_want(MOE_K1, {0: MOE_NL}, quant_rows_kernel=MOE_K1,
                          **MOE_COMBINE_WANT))
    if "reranker_engine" in STATE:
        # the cross-encoder's forward: the backbone, then the head's two
        # f32 products on the CLS rows
        rids = rng.integers(5, STATE["reranker_engine"].config.vocab_size,
                            ENC_SHAPE).astype(np.int32)
        runs["rerank"] = (
            lambda: STATE["reranker_engine"]._forward_pairs(
                rids, np.zeros_like(rids), np.ones_like(rids)),
            launches_want(4 * NL, {0: NL}, D, ENC_SHAPE[1]))
    fwd = {k: cuda_ms(r[0], iters=5) for k, r in runs.items()}
    # the mesh forwards against the single-device one at their shape, in
    # alternating rounds (host-bound forwards drift between calls)
    tp_alt = alternating_ms({k: r[0] for k, r in runs.items()
                             if k.startswith("tp_bge_")}, rounds=3)
    profiles = {k: device_profile(k, *r) for k, r in runs.items()}
    chain_fwd = {}
    if "int8_chain_path" in RESULTS:
        chain_fwd, chain_prof = chain_timing(ids, mask)
        profiles.update(chain_prof)
    packed_fwd = {}
    for name in ("K4", "K5"):
        if name in fwd:
            arrays, W = STATE[name][2], STATE[name][3]
            tokens = int((arrays[1] >= 0).sum())
            packed_fwd[name] = {"shape": list(arrays[0].shape), "window": W,
                                "tokens": tokens, "forward_ms": fwd[name],
                                "tokens_per_s": tokens / fwd[name] * 1e3}
    family_fwd = {}
    fwd_shapes = {**{k: v[1] for k, v in families.items()},
                  "albert_int8": ENC_SHAPE, "rerank": ENC_SHAPE,
                  "nomic_moe_int8": MOE_SHORT}
    for name, (Bx, Lx) in fwd_shapes.items():
        if name in fwd:
            family_fwd[name] = {"shape": [Bx, Lx], "forward_ms": fwd[name],
                                "sentences_per_s": Bx / fwd[name] * 1e3,
                                "tokens_per_s": Bx * Lx / fwd[name] * 1e3}

    kernels = []
    if "k1_parity" in RESULTS and "k2_parity" in RESULTS:
        kernels += [k1_row(rng, dev, name, shape,
                           launches.get("qmatmul", {}))
                    for name, shape in K1_SHAPES.items()]
        kernels.append(k2_row(rng, dev, (B, L), (H, D),
                              launches.get("fused_attention", 0), "L256"))
    # ModernBERT's global layers at L=1024
    if "modernbert_path" in RESULTS and "k2_parity" in RESULTS:
        kernels.append(k2_row(rng, dev, MB_SHORT, (H, D),
                              STATE.get("launches_K2_modernbert", 0),
                              "L1024"))
    # RoFormer's whole rows at L=1,536 and ALBERT's FFN-up (tanh GELU)
    if "roformer_path" in RESULTS and "k2_parity" in RESULTS:
        kernels.append(k2_row(rng, dev, ROFORMER_LONG, (H, D),
                              launches.get("K2_roformer_long", 0), "L1536"))
    albert = "albert_path" in RESULTS
    if albert and "k1_parity" in RESULTS:
        kernels.append(k1_row(rng, dev, "albert_up", ALBERT_UP,
                              launches.get("qmatmul_albert", {})))
    if "k1_file_layouts" in RESULTS:
        # K1 on the weight layouts the files give it, where their
        # engines ran
        kernels += [k1_row(rng, dev, name, shape,
                           launches.get("qmatmul_" + eng_name, {}),
                           layout=layout)
                    for layout, eng_name in FILE_LAYOUTS.items()
                    for name, shape in K1_SHAPES.items()]
    if "k3_parity" in RESULTS:
        k3_shapes = {name: (shape, launches.get("qmatmul_int8", {}))
                     for name, shape in K1_SHAPES.items()}
        if albert:
            k3_shapes["albert_up"] = (
                ALBERT_UP, launches.get("qmatmul_int8_albert", {}))
        for name, ((K, N, epi), k3_launches) in k3_shapes.items():
            args, kw, qt = k1_inputs(rng, M, K, N, "q4_0", True, epi, dev)
            a = list(args.values())
            kept = keep_int8_weight(qt).int8
            # the library yardstick: cuBLAS s8 x s8 -> s32 on operands
            # quantized beforehand (no rescale, no epilogue)
            q8, _ = quantize_rows(a[0])
            w8t = kept[0]
            bms, by = bound_ms(*k3_cost(M, K, N, epi), peak=PEAK_INT8_OPS)

            def call():  # as the forward calls it: rows, then the product
                return qmatmul_int8(*a, int8_weight=kept, **kw)
            parts = profiled_ms(call, ("qmm_wgmma_kernel",
                                       "quant_rows_kernel"))
            kernels.append({
                "name": f"qmatmul_int8[{name} {K}x{N} {epi}]",
                "route": "cuda",
                "source": "embeddings_tpu_torch/csrc/qmatmul.cu",
                "replaces": K3_REPLACES,
                "launches": k3_launches.get((K, N, epi), 0),
                "max_abs_err":
                    RESULTS["k3_parity"]["main"][name]["max_abs_err"],
                "ms": cuda_ms(call),
                "plain_ms": cuda_ms(lambda: qmatmul_int8_ref(*a, **kw),
                                    iters=3),
                "bound_ms": bms, "bound_by": by,
                "library_ms": cuda_ms(lambda: torch._int_mm(q8, w8t.t())),
                "kernel_ms": parts["qmm_wgmma_kernel"],
                "rows_ms": parts["quant_rows_kernel"],
                "shape": [M, K, N]})
    for name, fn, replaces in (
            ("K4", "fused_attention_segmented", K4_REPLACES),
            ("K5", "fused_attention_segmented_blockskip", K5_REPLACES)):
        if name not in STATE:
            continue
        qkv, seg, arrays, W = STATE[name]
        Bx, Lx = seg.shape
        kw = dict(B=Bx, L=Lx, H=H, D=D)
        kernel_kw = kw
        if name == "K5":
            kw["window"] = W
            # as the forward calls it: ranges computed once, outside
            kernel_kw = dict(kw, ranges=A.block_ranges(seg, Lx))
        kernel, plain = getattr(A, fn), getattr(A, fn + "_ref")
        same = (seg[:, :, None] == seg[:, None, :]) & (seg >= 0)[:, None, :]
        bms, by = bound_ms(seg_flops(arrays[1]),
                           Bx * Lx * (3 * E * 2 + E * 2 + 4))
        row = {
            "name": f"{fn}[B{Bx} L{Lx} H{H} D{D}"
                    + (f" W{W}]" if name == "K5" else "]"),
            "route": "cuda",
            "source": ATTN90_SOURCE,
            "replaces": replaces,
            "launches": launches.get(name, 0),
            "max_abs_err": RESULTS["k4k5_parity"][name]["max_abs_err"],
            "plain_ms": cuda_ms(lambda: plain(qkv, seg, **kw), iters=3),
            "bound_ms": bms, "bound_by": by,
            "shape": [Bx, Lx, H, D]}
        # the kernel and its SDPA yardstick in alternating rounds: the
        # median of 5 and the range
        t = alternating_ms({
            "kernel": lambda: kernel(qkv, seg, **kernel_kw),
            "library": sdpa_call(qkv, Bx, Lx, same[:, None])})
        row.update(ms=t["kernel"][0], ms_range=t["kernel"][1],
                   library_ms=t["library"][0],
                   library_ms_range=t["library"][1])
        kernels.append(row)
    if "k6k7_parity" in RESULTS:
        kernels += bias_stream_rows(rng, dev)
    if "k1_parity" in RESULTS:
        kernels += [k1_row(rng, dev, name, shape,
                           launches.get("qmatmul_modernbert", {}))
                    for name, shape in MB_K1_SHAPES.items()]
    if "k6w_parity" in RESULTS:
        kernels += window_rows(rng, dev)
    if "qwen2_path" in RESULTS:
        kernels += [k1_row(rng, dev, name, shape,
                           launches.get("qmatmul_qwen2", {}), QW_M)
                    for name, shape in QW_K1_SHAPES.items()]
        kernels += qwen2_attention_rows(rng, dev)
    if "emit_parity" in RESULTS and "attn_emit_parity" in RESULTS:
        kernels += chain_rows(rng, dev)
    if "k8_parity" in RESULTS:
        kernels += cp_rows(rng, dev)
    if "k6ca_parity" in RESULTS:
        kernels.append(causal_alibi_row(rng, dev))
    if "mla_path" in RESULTS:
        kernels += mla_rows(rng, dev)
    if "moe_combine" in RESULTS:
        kernels += combine_rows(rng, dev)
    if "k1_parity" in RESULTS:
        # K1 at a TP shard's shapes, with the launches of the 1 x 2 and
        # 1 x 4 forwards (tp_path)
        for name, shape in TP_K1_SHAPES.items():
            tp = name[2]
            kernels.append(k1_row(rng, dev, name, shape, launches.get(
                f"qmatmul_tp_1x{tp}", {}), TP_M))
    cp_fwd = {name: {"forward_ms": fwd[name],
                     "single_device_ms": fwd[name + "_single"],
                     "cp_over_single": fwd[name] / fwd[name + "_single"]}
              for name in ("cp_bge", "cp_nomic") if name in fwd}
    set_counts(saved)
    # one bge layer's K1 and K2 rows (the first five), where they ran
    bge_rows = kernels[:5] if "k1_parity" in RESULTS else []
    emit("timing", batch=[B, L], forward_ms=fwd.get("bf16"),
         sentences_per_s=(B / fwd["bf16"] * 1e3 if "bf16" in fwd else None),
         int8_forward_ms=fwd.get("int8"),
         int8_sentences_per_s=(B / fwd["int8"] * 1e3 if "int8" in fwd
                               else None),
         int8_scores_forward_ms=fwd.get("int8_scores"),
         int8_scores_sentences_per_s=(
             B / fwd["int8_scores"] * 1e3 if "int8_scores" in fwd
             else None),
         packed_forward=packed_fwd, family_forward=family_fwd,
         forward_bound_ms=NL * sum(kk["bound_ms"] for kk in bge_rows),
         kernel_ms_per_forward=NL * sum(kk["ms"] for kk in bge_rows),
         int8_chain_forward_ms=chain_fwd, cp_forward=cp_fwd,
         tp_forward={name: {"forward_ms": fwd[name],
                            "alternating_median_ms": tp_alt[name][0],
                            "alternating_range_ms": tp_alt[name][1],
                            "tp_over_single": tp_alt[name][0]
                            / tp_alt["tp_bge_single"][0]}
                     for name in tp_alt},
         c_abi_sentences_per_s=STATE.get("capi_rates"),
         moe_breakdown={k: moe_breakdown(profiles[k]) for k in profiles
                        if k.startswith("nomic_moe")},
         profile=profiles)
    RESULTS["kernels"] = kernels


def k2_row(rng, dev, shape, heads, launches: int, parity: str) -> dict:
    """K2's row of the kernel table at (B, L) and (H, D), every row full:
    the bound counts the B*H*L^2 pairs' two products against reading qkv
    and writing the context once; the library yardstick is SDPA with the
    boolean key-prefix mask."""
    import torch
    from embeddings_tpu_torch.ops import attention as A
    (Bx, Lx), (Hx, Dx) = shape, heads
    Ex = Hx * Dx
    qkv, lens = _attn_qkv(rng, Bx, Lx, dev, ragged=False, Ex=Ex)
    keymask = (torch.arange(Lx, device=dev)[None, :]
               < lens[:, None])[:, None, None, :]
    bms, by = bound_ms(4.0 * Bx * Hx * Lx * Lx * Dx,
                       Bx * Lx * (3 * Ex * 2 + Ex * 2) + Bx * 4)
    kw = dict(B=Bx, L=Lx, H=Hx, D=Dx)
    return {
        "name": f"fused_attention[B{Bx} L{Lx} H{Hx} D{Dx}]", "route": "cuda",
        "source": ATTN90_SOURCE, "replaces": K2_REPLACES,
        "launches": launches,
        "max_abs_err": RESULTS["k2_parity"][parity]["max_abs_err"],
        "ms": cuda_ms(lambda: A.fused_attention(qkv, lens, **kw)),
        "plain_ms": cuda_ms(lambda: A.fused_attention_ref(qkv, lens, **kw),
                            iters=3),
        "bound_ms": bms, "bound_by": by,
        "library_ms": sdpa_ms(qkv, Bx, Lx, keymask, Hx, Dx),
        "shape": [Bx, Lx, Hx, Dx]}


def launches_want(matmuls: int, attn: dict, dh: int = D, Lx: int = L,
                  **others) -> dict:
    """The launches one forward makes, by the profiler's kernel names:
    ``matmuls`` matmul launches in all (``device_profile`` names their
    kernels from the routes the wrappers counted), of each attention mode
    in the fused layout the count {mode: count} gives (a key (mode,
    emit) names an emitting mode, "both" or "only"; ("i8s", emit) K2i8),
    on the kernel its route names (``attention_kernel``):
    attn_sm90_kernel<dh, mode, warpgroups at row length Lx, emit mode, 0>
    or attn90_i8_kernel<dh, warpgroups, emit mode>; a key
    that is a string names the kernel itself (the CP layout's mode 4:
    ``cp_kernel``); ``others``: the counts of the other kernels by name
    (quant_rows_kernel, emit_rows_kernel)."""
    from embeddings_tpu_torch.ops.attention import attention_kernel, \
        sm90_warpgroups
    from embeddings_tpu_torch.ops.quant import EMITS

    def name(m):
        if isinstance(m, str):
            return m
        m, how = m if isinstance(m, tuple) else (m, "no")
        if m == "i8s":
            check(attention_kernel(0, dh, how, i8s=True) == "sm90",
                  "K2i8 off the Hopper library")
            return (f"attn90_i8_kernel<{dh}, {sm90_warpgroups(Lx)}, "
                    f"{EMITS.index(how)}>")
        check(attention_kernel(m, dh, how) == "sm90",
              f"mode {m} off the Hopper library")
        return (f"attn_sm90_kernel<{dh}, {m}, {sm90_warpgroups(Lx)}, "
                f"{EMITS.index(how)}, 0>")

    return {"matmuls": matmuls, **{name(m): n for m, n in attn.items()},
            **others}


def cp_kernel(shape, mesh_shape) -> str:
    """The kernel a CP forward's K8a / K8b launches run, as the profile
    names it: attn_sm90_kernel<D, 4, warpgroups at Lc, 0, 1> (the CP
    layout) at the shard's Lc = L / sp."""
    from embeddings_tpu_torch.ops.attention import sm90_warpgroups
    Lx, sp = shape[1], mesh_shape[1]
    return f"attn_sm90_kernel<{D}, 4, {sm90_warpgroups(Lx // sp)}, 0, 1>"


def matmul_kernel(route: str, int8: bool, weights: str = "0, true") -> str:
    """The kernel a K1 or K3 launch of tile route ``route`` (``k1_route``
    / ``k3_route``) runs, as the profile names it:
    qmm_wgmma_kernel<kind, packed, BM, LN>, K3 being kind 4 (S8) on int8
    operands; K1's ``weights`` "kind, packed" (q4_0 packed, "0, true",
    on every path but the file-loaded ones: ``weights_spec``)."""
    bm = route.split("_")[0][2:]
    ln = "true" if "cluster" in route else "false"
    return f"qmm_wgmma_kernel<{'4, false' if int8 else weights}, {bm}, " \
        f"{ln}>"


def weights_spec(eng) -> str:
    """"kind, packed" of an engine's matmul weights, as K1's template
    arguments name them."""
    from embeddings_tpu_torch.ops.qmatmul import _KIND_ID
    layers = eng.params["layers"]
    w = layers.get("dense", layers)["mlp"]["up"]["w"]  # an MoE tree's
    return f"{_KIND_ID[w.kind]}, {'true' if w.packed else 'false'}"


def chain_timing(ids, mask, rounds: int = 5):
    """The int8 forward at B=128, L=256 under each link subset with int8
    scores off, and with them on under no links and all links: CUDA
    events over 5 forwards, in ``rounds`` rounds that walk the settings
    in turn (every other round backwards), so slow drift of the card
    lands on all of them; the median of the rounds, and their range. Then
    the device profile of the all-links forward: 48 K3, 12 emit_rows
    (FFN-up "only"), 12 K2e ("only", the Hopper kernel), no row
    quantization and no weight requantization; and of the packed int8
    forward (256 rows of 128) with the "attn" link: 48 K3 (36 of them
    after a row quantization), 12 K4e ("only", the Hopper kernel)."""
    from embeddings_tpu_torch.ops.attention import int8_scores_mode
    from embeddings_tpu_torch.ops.linear import chain_links
    e8 = STATE["engine8"]
    settings = [(links, scores) for links in LINK_SUBSETS
                for scores in (False, True)
                if not scores or links in ((), LINK_SUBSETS[-1])]
    samples = {s: [] for s in settings}
    for r in range(rounds):
        for links, scores in settings[::-1] if r % 2 else settings:
            with chain_links(links), \
                    int8_scores_mode("on" if scores else "off"):
                samples[links, scores].append(
                    cuda_ms(lambda: e8._forward(ids, mask), iters=5))
    out = {("+".join(links) or "none") + ("/scores_on" if scores else ""):
           {"median_ms": float(np.median(v)), "min_ms": min(v),
            "max_ms": max(v)}
           for (links, scores), v in samples.items()}
    # every K3 reads int8 rows (no row quantization), FFN-up's "only"
    # emission takes a second launch, the attention emits (K2e "only")
    want = launches_want(4 * NL, {(0, "only"): NL}, emit_rows_kernel=NL)
    with chain_links(LINK_SUBSETS[-1]):
        prof = {"int8_chain_all": device_profile(
            "int8_chain_all", lambda: e8._forward(ids, mask), want)}
    if "K4" in STATE:
        # the packed forward's attention emits for the o-projection (K4e
        # "only"); the other three matmuls quantize their rows first
        arrays, W = STATE["K4"][2], STATE["K4"][3]
        want = launches_want(4 * NL, {(1, "only"): NL}, Lx=PACK_SHORT[1],
                             quant_rows_kernel=3 * NL)
        with chain_links(("attn",)):
            prof["int8_packed_attn"] = device_profile(
                "int8_packed_attn",
                lambda: e8._forward_packed(*arrays, W), want)
    return out, prof


def k3_cost(Mx, K, N, epilogue, emit="no", x8=False) -> tuple[float, float]:
    """(ops, bytes) of one K3 call as the forward makes it: x read once
    (bf16, or an int8 x at one byte an element plus its f32 row scales),
    the kept int8 weight (K*N bytes) and its f32 column scales, the bias,
    the output written once (bf16, and with emission M*N codes and M f32
    scales; no bf16 output with "only"), with residual + LayerNorm the
    residual and the LayerNorm parameters; 2*M*K*N int8 operations."""
    nbytes = (Mx * K * (1 if x8 else 2) + (4 * Mx if x8 else 0) + K * N
              + 4 * N + 4 * N + (0 if emit == "only" else Mx * N * 2))
    if epilogue == "bias_residual_ln":
        nbytes += Mx * N * 2 + 2 * N * 4
    if emit != "no":
        nbytes += Mx * N + 4 * Mx
    return 2.0 * Mx * K * N, float(nbytes)


def profiled_ms(fn, parts, calls: int = 5) -> dict:
    """Device ms per call of fn() spent in kernels whose names hold each
    of ``parts`` (torch.profiler over ``calls`` calls after a warm-up,
    with idle gaps at both edges as in ``device_profile``, or the tracer
    drops kernels at the window's start)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    ms = dict.fromkeys(parts, 0.0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for part in parts:
            if part in e.name:
                ms[part] += e.time_range.elapsed_us() / 1e3 / calls
    return ms


def chain_rows(rng, dev) -> list:
    """The kernel table's rows of the chained-int8 modes at bge's shapes,
    as the all-links forward calls them, with the launches a forward that
    its scores-off run in int8_chain_path counted: K3x + K3e on o-proj and
    down ("both") and up ("only"), K3x alone on qkv; K1e (bf16 compute, the
    emission where int8 does not engage: no launch on this path); K2e and
    K4e ("only"); K2i8 at B=128, L=256 and B=16, L=1,024. The K3 rows
    time the call as the forward makes it (the kept int8 weight, the int8
    x as given: one launch, two with FFN-up's "only"), with the product
    kernel's own profiled time beside it. Library yardsticks:
    torch._int_mm on operands quantized beforehand (K3), a bf16 matmul
    on the dequantized weight (K1e), SDPA with the boolean mask, writing
    bf16 (K2e, K4e); none computes K2i8's int8 softmax."""
    import torch
    from embeddings_tpu_torch.ops import attention as A
    from embeddings_tpu_torch.ops.qmatmul import dequantize_bf16, \
        keep_int8_weight, qmatmul, qmatmul_int8_ref, qmatmul_ref, \
        quantize_rows
    counts, modes = STATE.get("chain_all", ({}, {}))
    par = RESULTS["emit_parity"]
    out = []
    for name, (K, N, epi, how) in (
            ("qkv", (E, 3 * E, "bias", "no")),
            ("o_proj", (E, E, "bias_residual_ln", "both")),
            ("ffn_up", (E, F, "bias_gelu", "only")),
            ("ffn_down", (F, E, "bias_residual_ln", "both"))):
        args, kw, qt = k1_inputs(rng, M, K, N, "q4_0", True, epi, dev)
        a = list(args.values())
        q8, sx = quantize_rows(a[0])
        x8 = [q8] + a[1:]
        kept = keep_int8_weight(qt).int8
        w8t = kept[0]
        bms, by = bound_ms(*k3_cost(M, K, N, epi, how, True),
                           peak=PEAK_INT8_OPS)

        def call():
            return qmatmul(*x8, int8_compute=True, x_scale=sx.reshape(M),
                           emit_quantized=how, int8_weight=kept, **kw)
        emit_key = f"{name}_{how}" if how != "no" else None
        err = (par[f"K3x_{name}"]["max_abs_err"] if emit_key is None
               else par[emit_key]["K3x_K3e"]["max_abs_err"])
        out.append({
            "name": f"qmatmul_int8[{name} {K}x{N} {epi} int8 x"
                    + (f", emit {how}]" if how != "no" else "]"),
            "route": "cuda", "source": "embeddings_tpu_torch/csrc/qmatmul.cu",
            "replaces": EMIT_REPLACES if how != "no" else K3X_REPLACES,
            "launches": modes.get((K, N, epi, how, True), 0),
            "max_abs_err": err,
            "ms": cuda_ms(call),
            "plain_ms": cuda_ms(lambda: qmatmul_int8_ref(
                *x8, x_scale=sx, emit_quantized=how, **kw), iters=3),
            "bound_ms": bms, "bound_by": by,
            "library_ms": cuda_ms(lambda: torch._int_mm(q8, w8t.t())),
            "kernel_ms": profiled_ms(call, ("qmm_wgmma_kernel",))[
                "qmm_wgmma_kernel"],
            "shape": [M, K, N]})
    # K1e: FFN-up's "only" in bf16 compute
    K, N, epi, how = EMIT_SHAPES["ffn_up_only"]
    args, kw, qt = k1_inputs(rng, M, K, N, "q4_0", True, epi, dev)
    a = list(args.values())
    w_bf16 = dequantize_bf16(qt.codes, qt.scales, qt.mins, "q4_0", True)
    ops, nbytes = k1_cost(M, K, N, epi)  # + the codes and scales, no out
    bms, by = bound_ms(ops, nbytes + M * N + 4 * M - M * N * 2)
    out.append({
        "name": f"qmatmul[ffn_up {K}x{N} {epi}, emit {how}]", "route": "cuda",
        "source": "embeddings_tpu_torch/csrc/qmatmul.cu",
        "replaces": EMIT_REPLACES, "launches": 0,
        "max_abs_err": par["ffn_up_only"]["K1e"]["max_abs_err"],
        "ms": cuda_ms(lambda: qmatmul(*a, emit_quantized=how, **kw)),
        "plain_ms": cuda_ms(lambda: qmatmul_ref(*a, emit_quantized=how,
                                                **kw), iters=3),
        "bound_ms": bms, "bound_by": by,
        "library_ms": cuda_ms(lambda: torch.matmul(a[0], w_bf16)),
        "shape": [M, K, N]})
    apar = RESULTS["attn_emit_parity"]
    qkv, lens = _attn_qkv(rng, B, L, dev, ragged=False, Ex=E)
    keymask = torch.ones((1, 1, 1, L), dtype=torch.bool, device=dev)
    flops = 4.0 * B * H * L * L * D
    kw = dict(B=B, L=L, H=H, D=D)
    rows = [("K2e", "fused_attention", K2E_REPLACES, dict(emit_quantized=
                                                          "only"),
             M * 3 * E * 2 + M * E + 4 * M + B * 4, PEAK_BF16_FLOPS,
             counts.get("K2e_only", 0), apar["K2e_only"]["max_abs_err"]),
            ("K2i8", "fused_attention", K2I8_REPLACES,
             dict(int8_scores=True), M * 3 * E * 2 + M * E * 2 + B * 4,
             PEAK_INT8_OPS, STATE.get("launches_K2i8", 0),
             apar["K2i8_L256"]["max_abs_err"])]
    for kname, fn, replaces, opt, nbytes, peak, launches, err in rows:
        bms, by = bound_ms(flops, nbytes, peak=peak)
        t = alternating_ms({"kernel": lambda: A.fused_attention(
            qkv, lens, **opt, **kw)})["kernel"]
        out.append({
            "name": f"{fn}[{kname} B{B} L{L} H{H} D{D} "
                    + ("emit only]" if kname == "K2e" else "int8 scores]"),
            "route": "cuda", "source": ATTN90_SOURCE,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t[0], "ms_range": t[1],
            "plain_ms": cuda_ms(lambda: A.fused_attention_ref(
                qkv, lens, **opt, **kw), iters=3),
            "bound_ms": bms, "bound_by": by,
            "library_ms": (sdpa_ms(qkv, B, L, keymask, H, D) if kname == "K2e"
                           else None),
            "shape": [B, L, H, D]})
    Bx, Lx = I8S_LONG
    q2, l2 = _attn_qkv(rng, Bx, Lx, dev, ragged=False, Ex=E)
    k2 = dict(B=Bx, L=Lx, H=H, D=D, int8_scores=True)
    bms, by = bound_ms(4.0 * Bx * H * Lx * Lx * D,
                       Bx * Lx * (3 * E * 2 + E * 2) + Bx * 4,
                       peak=PEAK_INT8_OPS)
    t = alternating_ms({"kernel": lambda: A.fused_attention(q2, l2, **k2)})[
        "kernel"]
    out.append({
        "name": f"fused_attention[K2i8 B{Bx} L{Lx} H{H} D{D}]",
        "route": "cuda", "source": ATTN90_SOURCE,
        "replaces": K2I8_REPLACES, "launches": 0,
        "max_abs_err": apar["K2i8_L1024"]["max_abs_err"],
        "ms": t[0], "ms_range": t[1],
        "plain_ms": cuda_ms(lambda: A.fused_attention_ref(q2, l2, **k2),
                            iters=2, warmup=1),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "bf16_kernel_ms": cuda_ms(lambda: A.fused_attention(
            q2, l2, B=Bx, L=Lx, H=H, D=D), iters=5),
        "shape": [Bx, Lx, H, D]})
    if "K4" in STATE:
        pqkv, seg, arrays, _ = STATE["K4"]
        Bx, Lx = seg.shape
        kw = dict(B=Bx, L=Lx, H=H, D=D, emit_quantized="only")
        same = (seg[:, :, None] == seg[:, None, :]) & (seg >= 0)[:, None, :]
        bms, by = bound_ms(seg_flops(arrays[1]),
                           Bx * Lx * (3 * E * 2 + E + 4 + 4))
        out.append({
            "name": f"fused_attention_segmented[K4e B{Bx} L{Lx} H{H} D{D} "
                    f"emit only]", "route": "cuda",
            "source": ATTN90_SOURCE,
            "replaces": K4E_REPLACES,
            "launches": STATE.get("launches_K4e", 0),
            "max_abs_err": apar["K4e_only"]["max_abs_err"],
            "ms": cuda_ms(lambda: A.fused_attention_segmented(pqkv, seg,
                                                              **kw)),
            "plain_ms": cuda_ms(lambda: A.fused_attention_segmented_ref(
                pqkv, seg, **kw), iters=3),
            "bound_ms": bms, "bound_by": by,
            "library_ms": sdpa_ms(pqkv, Bx, Lx, same[:, None], H, D),
            "shape": [Bx, Lx, H, D]})
    return out


def k1_row(rng, dev, name: str, shape, launches: dict, Mx: int = M,
           layout=("q4_0", True)) -> dict:
    """K1's row of the kernel table at Mx tokens (32,768; Qwen2's
    forwards 16,384) and one (K, N, epilogue) of a main path, on weights
    of ``layout`` (kind, packed; a file's layouts are held in phase
    ``ggml_path``); ``launches``: that path's counts by shape. The
    library yardstick is a bf16 matmul on the dequantized weight."""
    import torch
    from embeddings_tpu_torch.ops.qmatmul import dequantize_bf16, qmatmul, \
        qmatmul_ref
    K, N, epi = shape
    kind, packed = layout
    args, kw, qt = k1_inputs(rng, Mx, K, N, kind, packed, epi, dev)
    a = list(args.values())
    w_bf16 = dequantize_bf16(qt.codes, qt.scales, qt.mins, kind, packed)
    bms, by = bound_ms(*k1_cost(Mx, K, N, epi, kind, packed))
    if layout == ("q4_0", True):
        parity = (RESULTS["k1_parity"]["main"].get(name)
                  or RESULTS["k1_parity"]["extra"][name])
        label = ""
    else:
        label = f" {layout_name(layout)}"
        parity = RESULTS["k1_file_layouts"][label[1:]][name]
    return {
        "name": f"qmatmul[{name} {K}x{N} {epi}{label}]", "route": "cuda",
        "source": "embeddings_tpu_torch/csrc/qmatmul.cu",
        "replaces": K1_REPLACES, "launches": launches.get(shape, 0),
        "max_abs_err": parity["max_abs_err"],
        "ms": cuda_ms(lambda: qmatmul(*a, **kw)),
        "plain_ms": cuda_ms(lambda: qmatmul_ref(*a, **kw), iters=3),
        "bound_ms": bms, "bound_by": by,
        "library_ms": cuda_ms(lambda: torch.matmul(a[0], w_bf16)),
        "shape": [Mx, K, N]}


def window_rows(rng, dev) -> list:
    """K6w's rows of the kernel table at ModernBERT's two shapes, every row
    full. The bound counts the band's (query, key) pairs, not the tiles
    the kernel walks (``tiles_walked`` a head); the library yardstick is
    SDPA with the boolean band mask (prefix and band in one [L, L] mask,
    as the rows are full). Kernel and SDPA in alternating rounds: the
    median of 5 and the range."""
    import torch
    from embeddings_tpu_torch.ops import attention as A
    out = []
    for name, (Bx, Lx) in (("short", MB_SHORT), ("long", MB_LONG)):
        qkv, lens = _attn_qkv(rng, Bx, Lx, dev, ragged=False)
        kw = dict(B=Bx, L=Lx, H=H, D=D, window=MB_WINDOW)
        pairs = band_pairs(lens.tolist(), Lx, MB_WINDOW)
        bms, by = bound_ms(4.0 * H * D * pairs,
                           Bx * Lx * (3 * E * 2 + E * 2) + Bx * 4)
        i = torch.arange(Lx, device=dev)
        band = ((i[:, None] - i[None, :]).abs() <= MB_WINDOW // 2)
        t = alternating_ms({
            "kernel": lambda: A.fused_attention_window(qkv, lens, **kw),
            "library": sdpa_call(qkv, Bx, Lx, band[None, None])})
        out.append({
            "name": f"fused_attention_window[B{Bx} L{Lx} H{H} D{D} "
                    f"w{MB_WINDOW}]", "route": "cuda",
            "source": ATTN90_SOURCE,
            "replaces": K6W_REPLACES,
            "launches": STATE.get(f"launches_K6w_modernbert_{name}", 0),
            "max_abs_err": RESULTS["k6w_parity"][name]["max_abs_err"],
            "ms": t["kernel"][0], "ms_range": t["kernel"][1],
            "plain_ms": cuda_ms(lambda: A.fused_attention_window_ref(
                qkv, lens, **kw), iters=3),
            "bound_ms": bms, "bound_by": by,
            "library_ms": t["library"][0],
            "library_ms_range": t["library"][1],
            "band_pairs": pairs,
            "tiles_walked": band_tiles_walked(lens.tolist(), Lx, MB_WINDOW),
            "shape": [Bx, Lx, H, D]})
        del band
    return out


def device_profile(name: str, fn, want: dict) -> dict:
    """Device time by kernel over one forward (torch.profiler, CUDA
    activity). The idle share is the gaps between the forward's first
    kernel start and last kernel end (the profiler slows the host, so its
    wall time says nothing of idleness). Checks that the trace holds the
    launches ``want`` names (``launches_want``): its matmul kernels are
    the ones the routes counted during the profiled calls name
    (``matmul_kernel``), ``want["matmuls"]`` of them; and no matmul,
    attention, requantization, row or MoE combine kernel it does not
    name, and no ``index_add_`` under ``moe_dispatch``. The torch
    ops' kernels are also split by the span (``record_function``) that
    launched them: ``ops.moe``'s ``moe_dispatch``, ``moe_expert_gemm``
    and ``moe_expert_ops``, and "rotation" (``apply_rotary_qkv``, wrapped
    here); each expert product (``moe_ffn_ragged.expert_gemms``) must
    show as one GEMM kernel under ``moe_expert_gemm`` (a split-K one with
    its reduction beside it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, \
        schedule
    from embeddings_tpu_torch.models import bert as Bm
    from embeddings_tpu_torch.ops import qmatmul as Q
    rotate = Bm.apply_rotary_qkv

    def rotation(*a, **kw):
        with record_function("rotation"):
            return rotate(*a, **kw)
    Bm.apply_rotary_qkv = rotation
    gemms = moe_counts()[1]
    Q.qmatmul.routes.clear()
    Q.qmatmul_int8.routes.clear()
    # one warm-up step: without it the tracer can miss the first kernels.
    # The tracer keeps a kernel only if its device timestamp lies inside
    # the recorded step's window on the host clock, and the two clocks
    # can disagree by a fraction of a millisecond: kernels started just
    # after the window opens were then dropped (a prefix of the forward).
    # Idle gaps at both edges keep every kernel of the step inside it.
    gap_s = 0.02
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                time.sleep(gap_s)
                fn()
                torch.cuda.synchronize()
                time.sleep(gap_s)
                prof.step()
    finally:
        Bm.apply_rotary_qkv = rotate
    gemm_calls = (moe_counts()[1] - gemms) // 2  # of one forward
    # the matmul kernels of one forward (two ran: the warm-up's, the step's)
    want = dict(want)
    n_mm = want.pop("matmuls")
    weights = want.pop("weights", "0, true")
    for int8, routes in ((False, Q.qmatmul.routes),
                         (True, Q.qmatmul_int8.routes)):
        for route, n in routes.items():
            k = matmul_kernel(route, int8, weights)
            want[k] = want.get(k, 0) + n // 2
    check(sum(n for k, n in want.items() if k.startswith("qmm_")) == n_mm,
          f"profile {name}: matmul routes {want}, want {n_mm} matmuls")
    kinds = ("requant_kernel", "quant_rows_kernel", "emit_rows_kernel",
             "qmm_wgmma_kernel", "attn90_i8_kernel", "attn_sm90_kernel",
             *MOE_COMBINE_WANT)
    by_kind: dict = {}
    torch_ops: dict = {}  # the library's own kernels, by name
    by_span: dict = {}    # ... by the span that launched them
    gemm_names: dict = {}
    spans = []
    events = prof.events()
    # a device event shares its id (the CUDA correlation id) with the
    # runtime call that launched it (cudaLaunchKernel, cuLaunchKernelEx,
    # cudaMemcpyAsync, ...), whose parent on the host is the torch op
    runtime = {e.id: e for e in events
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.name.startswith("cu")}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.name.startswith("ProfilerStep") or e.name in SPANS:
            continue  # the step's range, a span's range on the device
        kind = next((k for k in kinds if k in e.name), "torch ops")
        if kind.startswith(("attn", "qmm_")):  # attn_sm90_kernel<D, ...>
            kind += "<" + e.name.split(kind + "<")[-1].split(">")[0] + ">"
        ms = e.time_range.elapsed_us() / 1e3
        tally(by_kind, kind, ms)
        if kind == "torch ops":
            tally(torch_ops, e.name[:80], ms)
            launch = runtime.get(e.id)
            span = launching_span(launch.cpu_parent if launch else None)
            if span:
                tally(by_span, span, ms)
                check(not (span == "moe_dispatch"
                           and "indexFuncLargeIndex" in e.name),
                      f"profile {name}: an index_add_ under moe_dispatch")
                if span == "moe_expert_gemm" and not e.name.startswith(
                        ("Memcpy", "Memset")):
                    tally(gemm_names, e.name[:120], ms)
        spans.append((e.time_range.start, e.time_range.end))
    busy = sum(v[0] for v in by_kind.values())
    span = (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e3 \
        if spans else 0.0
    seen = {k: v[1] for k, v in by_kind.items()}
    # every kernel of the port the forward launched is one it should have
    stray = [k for k in seen if k != "torch ops" and k not in want]
    check(busy > 0 and not stray
          and all(seen.get(k) == n for k, n in want.items()),
          f"profile {name}: launches {seen}, want {want}")
    # a split-K product adds a reduction kernel (cuBLASLt's
    # splitKreduce_kernel) to its GEMM kernel
    n_gemm = sum(v[1] for k, v in gemm_names.items()
                 if "splitKreduce" not in k)
    check(n_gemm == gemm_calls, f"profile {name}: {n_gemm} GEMM kernels "
          f"under moe_expert_gemm for {gemm_calls} expert products: "
          f"{gemm_names}")
    return {
        "device_busy_ms": busy, "device_span_ms": span,
        "idle_share": 1 - busy / span,
        "by_kernel": {k: {"ms": v[0], "launches": v[1], "share": v[0] / busy}
                      for k, v in sorted(by_kind.items(),
                                         key=lambda kv: -kv[1][0])},
        "torch_ops_top": [[k, v[0], v[1]] for k, v in sorted(
            torch_ops.items(), key=lambda kv: -kv[1][0])[:6]],
        "torch_ops_by_span": {k: {"ms": v[0], "launches": v[1]}
                              for k, v in by_span.items()},
        "expert_gemm_kernels": {k: {"ms": v[0], "launches": v[1]}
                                for k, v in gemm_names.items()}}


SPANS = ("moe_dispatch", "moe_expert_gemm", "moe_expert_ops", "rotation")


def launching_span(op) -> str | None:
    """The innermost span of ``SPANS`` around the torch op that launched a
    kernel (the op's parents on the host), or None."""
    while op is not None:
        if op.name in SPANS:
            return op.name
        op = op.cpu_parent
    return None


def moe_span_kernels(fn) -> dict:
    """The device kernels one call of fn launches, by the span of
    ``SPANS`` that launched them ("none" outside them): span -> {kernel
    name: [ms, launches]}. Recorded as ``device_profile`` records: one
    warm-up step, idle gaps at both edges."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            time.sleep(0.02)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
            prof.step()
    events = prof.events()
    runtime = {e.id: e for e in events
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.name.startswith("cu")}
    out: dict = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.name.startswith("ProfilerStep") or e.name in SPANS:
            continue
        launch = runtime.get(e.id)
        span = launching_span(launch.cpu_parent if launch else None)
        name = e.name.replace("(anonymous namespace)::", "")
        tally(out.setdefault(span or "none", {}),
              name.split("(")[0].removeprefix("void ")[:100],
              e.time_range.elapsed_us() / 1e3)
    return out


def moe_breakdown(prof: dict) -> dict:
    """An MoE forward's device ms by column: K1 / K3, attention, the
    combine's two kernels, the experts' products, dispatch's torch ops
    (router, top-k, sort, gather), the experts' casts, bias and
    activation, rotation, the other torch ops; and the idle share."""
    col = {"matmul_K1_K3": 0.0, "attention": 0.0, "combine": 0.0}
    for k, v in prof["by_kernel"].items():
        if k.startswith("qmm_") or k.startswith("quant_rows"):
            col["matmul_K1_K3"] += v["ms"]
        elif k.startswith("attn"):
            col["attention"] += v["ms"]
        elif k in MOE_COMBINE_WANT:
            col["combine"] += v["ms"]
    span = {k: v["ms"] for k, v in prof["torch_ops_by_span"].items()}
    for k in SPANS:
        col[k] = span.get(k, 0.0)
    torch_ms = prof["by_kernel"].get("torch ops", {"ms": 0.0})["ms"]
    col["other_torch_ops"] = torch_ms - sum(span.values())
    col["busy"] = prof["device_busy_ms"]
    col["idle_share"] = prof["idle_share"]
    return col


def tally(table: dict, key: str, ms: float) -> None:
    """Add one kernel's ms (and one launch) under key."""
    t = table.setdefault(key, [0.0, 0])
    t[0] += ms
    t[1] += 1


def sdpa_call(qkv, Bx: int, Lx: int, mask, Hx: int = H, Dx: int = D,
              is_causal: bool = False):
    """The library yardstick for the attention kernels, as a call:
    F.scaled_dot_product_attention on [B, H, L, D] copies of q, k, v with
    the equivalent mask (boolean for K2/K4/K5; the family bias as a bf16
    float mask for K6/K7, None for K6 plain on full rows, is_causal for
    K6c on full rows)."""
    import torch.nn.functional as Fn
    q, k, v = (qkv.reshape(Bx, Lx, 3, Hx, Dx)[:, :, i].transpose(1, 2)
               .contiguous() for i in range(3))
    return lambda: Fn.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=is_causal)


def sdpa_ms(qkv, Bx: int, Lx: int, mask, Hx: int = H, Dx: int = D,
            is_causal: bool = False) -> float:
    """``sdpa_call``'s time (CUDA events)."""
    return cuda_ms(sdpa_call(qkv, Bx, Lx, mask, Hx, Dx, is_causal))


def alternating_ms(calls: dict, rounds: int = 5) -> dict:
    """Each call's time (``cuda_ms``) in ``rounds`` rounds that walk the
    calls in turn, every other round backwards, so a slow drift of the
    card lands on all of them: name -> (median of the rounds, [min,
    max])."""
    times = {k: [] for k in calls}
    for i in range(rounds):
        for k in (list(calls) if i % 2 == 0 else list(calls)[::-1]):
            times[k].append(cuda_ms(calls[k]))
    return {k: (float(np.median(t)), [min(t), max(t)])
            for k, t in times.items()}


def qwen2_attention_rows(rng, dev) -> list:
    """Qwen2's attention rows of the kernel table (D=128, every row full):
    K6c at both shapes, K2 at B=32, L=512 and K6 plain at B=4, L=4096
    (the bidirectional form). K6c's bound counts the causal pairs (L(L+1)/2
    a row), not the tiles it walks; its library yardstick is SDPA with
    is_causal=True (the rows are full, so the length mask is empty), and
    ``library_bool_mask_ms`` SDPA with the causal and length mask as one
    boolean [B, 1, L, L] mask."""
    import torch
    from embeddings_tpu_torch.ops import attention as A
    out = []
    Ex = QW_H * QW_D
    for kname, (Bx, Lx) in (("K6c", QW_SHORT), ("K6c", QW_LONG),
                            ("K2", QW_SHORT), ("K6", QW_LONG)):
        qkv, lens = _attn_qkv(rng, Bx, Lx, dev, ragged=False, Ex=Ex)
        kw = dict(B=Bx, L=Lx, H=QW_H, D=QW_D)
        pairs = Bx * Lx * Lx if kname != "K6c" else Bx * Lx * (Lx + 1) // 2
        bms, by = bound_ms(4.0 * QW_H * QW_D * pairs,
                           Bx * Lx * (3 * Ex * 2 + Ex * 2) + Bx * 4)
        extra = {}
        if kname == "K2":
            kernel = functools.partial(A.fused_attention, qkv, lens, **kw)
            plain = functools.partial(A.fused_attention_ref, qkv, lens, **kw)
            fn, replaces = "fused_attention", K2_REPLACES
            parity = RESULTS["k2_parity"]["L512_D128"]
            lib = sdpa_ms(qkv, Bx, Lx, None, QW_H, QW_D)
            key = "launches_K2_qwen2_short"
        else:
            kw.update(BK=A.pick_bk(Lx), causal=kname == "K6c")
            kernel = functools.partial(A.fused_attention_stream, qkv, lens,
                                       **kw)
            plain = functools.partial(A.fused_attention_stream_ref, qkv,
                                      lens, **kw)
            if kname == "K6c":
                fn, replaces = "fused_attention_stream causal", K6C_REPLACES
                parity = RESULTS["k6c_parity"][
                    "qwen2_short" if Lx == QW_SHORT[1] else "qwen2_long"]
                lib = sdpa_ms(qkv, Bx, Lx, None, QW_H, QW_D, is_causal=True)
                i = torch.arange(Lx, device=dev)
                mask = ((i[None, :] <= i[:, None])[None]
                        & (i[None, None, :] < lens[:, None, None]))[:, None]
                extra["library_bool_mask_ms"] = sdpa_ms(qkv, Bx, Lx, mask,
                                                        QW_H, QW_D)
                extra["causal_pairs"] = pairs
                del mask
                key = ("launches_K6c_qwen2_short" if Lx == QW_SHORT[1]
                       else "launches_K6c_qwen2_long")
            else:
                fn, replaces = "fused_attention_stream plain", K6_REPLACES
                parity = RESULTS["k6k7_parity"]["K6_plain_D128"]
                lib = sdpa_ms(qkv, Bx, Lx, None, QW_H, QW_D)
                key = "launches_K6_qwen2_long"
        out.append({
            "name": f"{fn}[B{Bx} L{Lx} H{QW_H} D{QW_D}]", "route": "cuda",
            "source": ATTN90_SOURCE,
            "replaces": replaces, "launches": STATE.get(key, 0),
            "max_abs_err": parity["max_abs_err"],
            "ms": cuda_ms(kernel, iters=5),
            "plain_ms": cuda_ms(plain, iters=2, warmup=1),
            "bound_ms": bms, "bound_by": by, "library_ms": lib,
            **extra, "shape": [Bx, Lx, QW_H, QW_D]})
    return out


def bias_stream_rows(rng, dev) -> list:
    """K7 and K6 rows of the kernel table at the families' shapes, every
    row full (so the library's float mask broadcasts over the batch).
    ``exp2_floor_ms``: the B*H*L^2 exp2 alone at 16 a clock per SM on 132
    SMs at the card's maximum SM clock, a second floor beside the
    tensor-core one."""
    import torch
    from embeddings_tpu_torch.ops import attention as A
    out = []
    for kname, family, (Bx, Lx), parity, launch_key in (
            ("K7", "mpnet", MPNET_SHAPE, "K7_mpnet", "launches_K7_mpnet"),
            ("K7", "jina", JINA_SHORT, "K7_alibi", "launches_K7_jina"),
            ("K6", None, BERT_LONG, "K6_plain", "launches_K6_plain"),
            ("K6", "jina", JINA_LONG, "K6_alibi", "launches_K6_jina")):
        qkv, lens = _attn_qkv(rng, Bx, Lx, dev, ragged=False)
        kw = dict(B=Bx, L=Lx, H=H, D=D)
        bias = _family_bias(family, Lx, dev) if family else None
        nbytes = Bx * Lx * 4 * E * 2 + Bx * 4
        if kname == "K7":
            op = A.prepare_attention_bias(bias, Lx)
            kernel = functools.partial(A.fused_attention_bias, qkv, lens, op,
                                       **kw)
            plain = functools.partial(A.fused_attention_bias_ref, qkv, lens,
                                      op, **kw)
            nbytes += H * Lx * Lx * 4
            fn, what = "fused_attention_bias", f"{family} bias"
        else:
            kw.update(BK=A.pick_bk(Lx),
                      alibi_slopes=_slopes(dev) if family else None)
            kernel = functools.partial(A.fused_attention_stream, qkv, lens,
                                       **kw)
            plain = functools.partial(A.fused_attention_stream_ref, qkv,
                                      lens, **kw)
            fn, what = "fused_attention_stream", \
                "ALiBi" if family else "plain"
        flops = 4.0 * Bx * H * Lx * Lx * D
        bms, by = bound_ms(flops, nbytes)
        clock = STATE.get("sm_clock_mhz")
        mask = None if bias is None else bias.to(torch.bfloat16)
        out.append({
            "name": f"{fn}[{what} B{Bx} L{Lx} H{H} D{D}]", "route": "cuda",
            "source": ATTN90_SOURCE,
            "replaces": K7_REPLACES if kname == "K7" else K6_REPLACES,
            "launches": STATE.get(launch_key, 0),
            "max_abs_err": RESULTS["k6k7_parity"][parity]["max_abs_err"],
            "ms": cuda_ms(kernel, iters=5),
            "plain_ms": cuda_ms(plain, iters=2, warmup=1),
            "bound_ms": bms, "bound_by": by,
            "library_ms": sdpa_ms(qkv, Bx, Lx, mask),
            "exp2_floor_ms": (Bx * H * Lx * Lx / (16 * 132 * clock * 1e6)
                              * 1e3 if clock else None),
            "shape": [Bx, Lx, H, D]})
        del mask, bias
    return out


def causal_alibi_row(rng, dev) -> dict:
    """K6ca's row of the kernel table at the jina causal path's shape
    (B=4, L=8,192, every row full). The bound counts the causal pairs
    (L(L+1)/2 a row); the library yardstick is SDPA with the equivalent
    additive mask: the ALiBi bias with -inf above the diagonal, bf16 [1, H,
    L, L]."""
    import torch
    from embeddings_tpu_torch.ops import attention as A
    Bx, Lx = JINA_LONG
    qkv, lens = _attn_qkv(rng, Bx, Lx, dev, ragged=False)
    kw = dict(B=Bx, L=Lx, H=H, D=D, BK=A.pick_bk(Lx), causal=True,
              alibi_slopes=_slopes(dev))
    pairs = Bx * Lx * (Lx + 1) // 2
    bms, by = bound_ms(4.0 * H * D * pairs,
                       Bx * Lx * 4 * E * 2 + Bx * 4)
    i = torch.arange(Lx, device=dev)
    mask = _family_bias("jina", Lx, dev).masked_fill(
        i[None, :] > i[:, None], float("-inf")).to(torch.bfloat16)
    row = {
        "name": f"fused_attention_stream[causal ALiBi B{Bx} L{Lx} H{H} "
                f"D{D}]", "route": "cuda",
        "source": ATTN90_SOURCE,
        "replaces": K6CA_REPLACES,
        "launches": STATE.get("launches_K6ca_jina", 0),
        "max_abs_err": RESULTS["k6ca_parity"]["jina_long"]["max_abs_err"],
        "ms": cuda_ms(functools.partial(A.fused_attention_stream, qkv, lens,
                                        **kw), iters=5),
        "plain_ms": cuda_ms(functools.partial(
            A.fused_attention_stream_ref, qkv, lens, **kw), iters=2,
            warmup=1),
        "bound_ms": bms, "bound_by": by,
        "library_ms": sdpa_ms(qkv, Bx, Lx, mask),
        "causal_pairs": pairs, "shape": [Bx, Lx, H, D]}
    del mask
    return row


def cp_rows(rng, dev) -> list:
    """K8a and K8b rows of the kernel table at the CP paths' shard shapes
    (bge: B=16, Lc=256, L=512, q read in place at row stride 3E; nomic:
    B=4, Lc=512, L=2,048), every row full. The bound: 4*B*H*Lc*L*D
    products at the bf16 peak, or the bytes 2*(2*B*Lc*E + 2*B*L*E) (q in,
    context out, gathered k and v in), whichever is larger. The library
    yardstick: SDPA on [B, H, Lc, D] and [B, H, L, D] copies of q, k, v
    with the boolean key-prefix mask [B, 1, 1, L]. The kernel and SDPA
    run in alternating rounds (``alternating_ms``): the median of 5 and
    the range."""
    import torch
    import torch.nn.functional as Fn
    from embeddings_tpu_torch.ops import attention as A
    out = []
    for kname, (Bx, Lx), (dp, sp) in (("K8a", CP_BGE, CP_BGE_MESH),
                                      ("K8b", CP_NOMIC, CP_NOMIC_MESH)):
        Bs, Lc = Bx // dp, Lx // sp
        q, kv, lens = _cp_attn_inputs(rng, Bs, Lc, Lx, dev, ragged=False,
                                      fused_q=kname == "K8a")
        kw = dict(B=Bs, Lc=Lc, L=Lx, H=H, D=D)
        if kname == "K8a":
            fn, replaces = "fused_attention_cp", K8A_REPLACES
        else:
            kw["BK"] = A.pick_bk(Lx)
            fn, replaces = "fused_attention_cp_stream", K8B_REPLACES
        kernel = functools.partial(getattr(A, fn), q, kv, lens, **kw)
        plain = functools.partial(getattr(A, fn + "_ref"), q, kv, lens, **kw)
        bms, by = bound_ms(4.0 * Bs * H * Lc * Lx * D,
                           2 * (2 * Bs * Lc * E + 2 * Bs * Lx * E) + Bs * 4)
        qh = q.reshape(Bs, Lc, H, D).transpose(1, 2).contiguous()
        kh, vh = (kv.reshape(Bs, Lx, 2, H, D)[:, :, i].transpose(1, 2)
                  .contiguous() for i in range(2))
        mask = (torch.arange(Lx, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        t = alternating_ms({
            "kernel": kernel,
            "library": lambda: Fn.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask)})
        out.append({
            "name": f"{fn}[B{Bs} Lc{Lc} L{Lx} H{H} D{D}]", "route": "cuda",
            "source": ATTN90_SOURCE,
            "replaces": replaces,
            "launches": STATE.get(f"launches_{kname}", 0),
            "max_abs_err": RESULTS["k8_parity"][
                f"{kname}_B{Bs}_Lc{Lc}_L{Lx}"]["max_abs_err"],
            "ms": t["kernel"][0], "ms_range": t["kernel"][1],
            "plain_ms": cuda_ms(plain, iters=3),
            "bound_ms": bms, "bound_by": by,
            "library_ms": t["library"][0],
            "library_ms_range": t["library"][1],
            "shape": [Bs, Lc, Lx, H, D]})
    return out


# ---------------------------------------------------------------------------
# the serving surface: the native tokenizer, HTTP and TCP, the CLI
# ---------------------------------------------------------------------------

# accented, CJK and mixed-script text for the native tokenizer's check
NATIVE_EXTRA = ["café naïve Ünïcödé ÀÉÎÕÜ façade", "你好世界，欢迎光临",
                "東京タワー テキスト", "ΛΟΓΟΣ σοφία", "Привет, мир!",
                "emoji 🤖 test\ttab\nnewline", "\xa0nbsp\x85nel ls",
                "don't 'LL 123 abc under_score-dash.dot"]


def phase_native_tok():
    """The port's native WordPiece (built in phase ``build``, or here) on
    the bge engine's tokenizer: its ids equal the Python tokenizer's on
    the STS sentences plus accented and CJK text; the Engine tokenizes
    through it; tokens/s both ways on the host."""
    from embeddings_tpu_torch.tokenizer import native, tokenizer_from_dir
    t0 = time.perf_counter()
    path = native.build()  # raises if the compiler fails
    build_s = time.perf_counter() - t0
    check(native.available(), f"native tokenizer: {native._lib_error}")
    py = tokenizer_from_dir(FIXTURE / "model")
    fast = native.wrap_fast(py)
    check(isinstance(fast, native.NativeWordPieceTokenizer),
          f"native tokenizer not taken for WordPiece: {fast}")
    texts = _sts_sentences(2400) + NATIVE_EXTRA * 4
    rates = {}
    for name, tok in (("python", py), ("native", fast)):
        t0 = time.perf_counter()
        ids = [tok.encode(t, max_len=512) for t in texts]
        s = time.perf_counter() - t0
        rates[name] = (ids, sum(len(i) for i in ids) / s)
    bad = [t for t, a, b in zip(texts, rates["python"][0],
                                rates["native"][0]) if a != b]
    check(not bad, f"native ids differ from Python's on {bad[:3]}")
    eng = STATE.get("engine")
    check(eng is None or isinstance(eng._fast_tokenizer,
                                    native.NativeWordPieceTokenizer),
          "the bge engine does not tokenize natively")
    emit("native_tok", card=STATE.get("nvidia_smi"),
         library=str(path.relative_to(ROOT)), build_s=build_s,
         phase_build_s=STATE.get("native_build_s"), texts=len(texts),
         tokens=sum(len(i) for i in rates["native"][0]),
         ids_equal=True, python_tokens_per_s=rates["python"][1],
         native_tokens_per_s=rates["native"][1],
         speedup=rates["native"][1] / rates["python"][1],
         engine_tokenizes_natively=eng is not None)


def _http(base: str, path: str, body=None):
    """(status, JSON) of one request through urllib."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@contextlib.contextmanager
def plain_calls():
    """Count the calls of K1's, K3's, K2's, K8a's, K8b's and the MoE
    combine's plain versions inside the block (the wrappers call them
    only for CPU tensors); yields the counts."""
    from embeddings_tpu_torch.ops import attention as A, moe as Mo, \
        qmatmul as Q
    calls, saved = {}, []
    for mod, name in ((Q, "qmatmul_ref"), (Q, "qmatmul_int8_ref"),
                      (A, "fused_attention_ref"),
                      (A, "fused_attention_cp_ref"),
                      (A, "fused_attention_cp_stream_ref"),
                      (Mo, "_combine_plain")):
        fn = getattr(mod, name)
        calls[name] = 0

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        setattr(mod, name, counted)
        saved.append((mod, name, fn))
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_http_path():
    """One BatchingService over the bge engine behind serve_tcp and
    serve_http on ephemeral ports (``start_serving``, as serve_forever
    composes them), and serve_http over the reranker; through the port's
    clients and urllib: TCP v1 and v2 (one text above 32 KiB), /embed in
    float32 then int8 and binary, /v1/embeddings in float then base64
    with dimensions=256, /healthz, /stats, /rerank. One-text requests
    equal Engine.encode within _check_tcp's bound; batched ones at
    cosine >= 0.999; the quantized precisions are quantize_embeddings of
    the same request's floats; /rerank's order is Engine.rerank's. K1 and
    K2 launch (48 : 12), on the Hopper routes, and no plain version
    runs."""
    from embeddings_tpu_torch.ops import attention as A
    from embeddings_tpu_torch.runtime.client import HttpClient, TcpClient
    from embeddings_tpu_torch.runtime.server import serve_http, \
        start_serving
    from embeddings_tpu_torch.utils.embedding_quant import \
        quantize_embeddings
    eng = STATE.get("engine") or _bge_base_engine()
    rer = STATE.get("reranker_engine") or _reranker_engine()
    texts = _sts_sentences(40)
    one, batch = texts[:4], texts[8:24]
    big = " ".join(_sts_sentences(800))
    check(len(big.encode()) > 32 * 1024, "the big text is not > 32 KiB")
    query, docs = texts[0], texts[1:33]

    async def run():
        service, servers = await start_serving(
            eng, host="127.0.0.1", tcp_port=0, http_port=0, max_batch=128)
        rsrv, rsvc = await serve_http(rer, "127.0.0.1", 0)
        tcp = servers[0].sockets[0].getsockname()[1]
        url = f"http://127.0.0.1:{servers[1].sockets[0].getsockname()[1]}"
        rurl = f"http://127.0.0.1:{rsrv.sockets[0].getsockname()[1]}"

        def client():
            out = {}
            with TcpClient("127.0.0.1", tcp, timeout=120) as c:
                out["tcp_v1"] = [c.embed(t) for t in one]
            with TcpClient("127.0.0.1", tcp, timeout=120,
                           framing="v2") as c:
                out["tcp_v2"] = [c.embed(t) for t in one + [big]]
            h = HttpClient(url, timeout=120)
            out["healthz"] = h.healthz()
            out["embed_one"] = [h.embed(t) for t in one]
            out["embed_batch"] = _http(url, "/embed", {"texts": batch})
            for p in ("int8", "binary"):
                out[p] = _http(url, "/embed", {"texts": batch,
                                               "precision": p})
            out["v1_one"] = [_http(url, "/v1/embeddings", {"input": t})
                             for t in one]
            out["v1_b64"] = _http(url, "/v1/embeddings", {
                "input": batch, "encoding_format": "base64",
                "dimensions": 256})
            out["stats"] = _http(url, "/stats")
            out["rerank"] = _http(rurl, "/rerank", {
                "query": query, "documents": docs, "top_n": 10,
                "return_documents": True})
            out["rerank_no_head"] = _http(url, "/rerank", {
                "query": query, "documents": docs[:2]})
            return out

        try:
            return await asyncio.to_thread(client)
        finally:
            for s in (*servers, rsrv):
                s.close()
            await service.stop()
            await rsvc.stop()

    reset_counts()
    with plain_calls() as plain:
        t0 = time.perf_counter()
        out, routes = _routed(A.fused_attention, lambda: asyncio.run(run()))
        wall = time.perf_counter() - t0
    counts = read_counts()
    diffs = {}
    for key, sent in (("tcp_v1", one), ("tcp_v2", one + [big]),
                      ("embed_one", one)):
        diffs[key] = max(float(np.abs(a - eng.encode(t)).max())
                         for a, t in zip(out[key], sent))
    diffs["v1_one"] = max(float(np.abs(np.asarray(
        r[1]["data"][0]["embedding"], np.float32) - eng.encode(t)).max())
        for r, t in zip(out["v1_one"], one))
    direct = eng.encode(batch)
    st, body = out["embed_batch"]
    floats = np.asarray(body["embeddings"], np.float32)
    batch_cos = float(_row_cos(floats, direct).min())
    quant_equal = {}
    for p in ("int8", "binary"):
        qst, qbody = out[p]
        quant_equal[p] = bool(qst == 200 and qbody["precision"] == p
                              and np.array_equal(
                                  np.asarray(qbody["embeddings"]),
                                  quantize_embeddings(floats, p)))
    vst, vbody = out["v1_b64"]
    import base64
    v = np.stack([np.frombuffer(base64.b64decode(d["embedding"]), "<f4")
                  for d in vbody["data"]])
    trunc = direct[:, :256] / np.linalg.norm(direct[:, :256], axis=-1,
                                             keepdims=True)
    b64_cos = float(_row_cos(v, trunc).min())
    usage = vbody["usage"]["prompt_tokens"]
    rst, rbody = out["rerank"]
    scores = rer.rerank(query, docs)
    want_order = sorted(range(len(docs)), key=lambda i: -scores[i])[:10]
    got_order = [r["index"] for r in rbody["results"]]
    stats = out["stats"][1]
    bound = 1e-6  # _check_tcp's
    check(max(diffs.values()) <= bound,
          f"http_path: one-text answers differ from Engine.encode: {diffs}")
    check(st == 200 and floats.shape == (len(batch), E)
          and batch_cos >= 0.999, f"http_path: /embed batch cos {batch_cos}")
    check(all(quant_equal.values()), f"http_path: precisions {quant_equal}")
    check(vst == 200 and v.shape == (len(batch), 256) and b64_cos >= 0.999
          and usage == sum(len(eng.tokenize(t)) for t in batch),
          f"http_path: /v1/embeddings base64 cos {b64_cos}, usage {usage}")
    check(out["healthz"] == {"status": "ok", "n_embd": E},
          f"http_path: healthz {out['healthz']}")
    check(rst == 200 and got_order == want_order
          and all(r["document"] == docs[r["index"]]
                  for r in rbody["results"]),
          f"http_path: rerank order {got_order}, want {want_order}")
    check(out["rerank_no_head"][0] == 400, "http_path: /rerank on an "
          "embedding model is not refused")
    check(counts["K1"] > 0 and counts["K2"] > 0
          and counts["K1"] == 4 * counts["K2"]
          and counts == only(K1=counts["K1"], K2=counts["K2"])
          and routes == {"sm90": counts["K2"]}
          and not any(plain.values()),
          f"http_path: launches {counts}, K2 routes {routes}, plain "
          f"calls {plain}")
    emit("http_path", card=STATE.get("nvidia_smi"),
         model="bge-base-en-v1.5 (as phase main) and bge-reranker-base "
         "(as phase rerank_path), q4_0 packed + fused qkv", wall_s=wall,
         max_abs_diff_vs_encode=diffs, bound=bound,
         embed_batch_min_cos=batch_cos, precisions_equal=quant_equal,
         v1_base64_dims256_min_cos=b64_cos, usage_tokens=usage,
         big_text_bytes=len(big.encode()), rerank_top10=got_order,
         stats={k: stats[k] for k in ("requests", "batches", "errors",
                                      "avg_batch")},
         launches=nonzero(counts), k2_routes=routes, plain_calls=plain,
         tolerance="one-text requests <= 1e-6 of Engine.encode; batched "
         "cosine >= 0.999; precisions exact; rerank order equal")


def load_client(tcp_port: str, http_port: str, texts_file: str,
                conns: str = "64") -> None:
    """The load of phase ``serve_latency``, in a process of its own: conns
    connections at once, half TCP v2 (the port's TcpClient), half HTTP
    keep-alive to /v1/embeddings (http.client), each sending its share of
    the texts one request at a time. Prints one JSON line."""
    import http.client
    import threading
    from embeddings_tpu_torch.runtime.client import TcpClient
    texts = json.loads(Path(texts_file).read_text())
    n = int(conns)
    half = len(texts) // 2
    shares = ([texts[i:half:n // 2] for i in range(n // 2)]
              + [texts[half + i::n - n // 2] for i in range(n - n // 2)])
    lat = [[] for _ in range(n)]
    errors = [0] * n
    go = threading.Barrier(n + 1)

    def tcp(i):
        with TcpClient("127.0.0.1", int(tcp_port), timeout=300,
                       framing="v2") as c:
            go.wait()
            for t in shares[i]:
                t0 = time.perf_counter()
                e = c.embed(t)
                lat[i].append(time.perf_counter() - t0)
                errors[i] += not (e.shape == (c.n_embd,)
                                  and np.isfinite(e).all())

    def web(i):
        conn = http.client.HTTPConnection("127.0.0.1", int(http_port),
                                          timeout=300)
        go.wait()
        for t in shares[i]:
            t0 = time.perf_counter()
            conn.request("POST", "/v1/embeddings",
                         json.dumps({"input": t}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = resp.read()
            lat[i].append(time.perf_counter() - t0)
            errors[i] += resp.status != 200 or len(json.loads(body)[
                "data"][0]["embedding"]) == 0
        conn.close()

    threads = [threading.Thread(target=tcp if i < n // 2 else web, args=(i,))
               for i in range(n)]
    for t in threads:
        t.start()
    go.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    xs = np.sort(np.concatenate([np.asarray(x) for x in lat]))
    print(json.dumps({
        "requests": int(xs.size), "errors": int(sum(errors)),
        "wall_s": wall, "requests_per_s": xs.size / wall,
        "client_ms": {p: float(np.percentile(xs, q) * 1e3)
                      for p, q in (("p50", 50), ("p90", 90), ("p99", 99))},
        "tcp_requests": sum(len(x) for x in lat[:n // 2]),
        "http_requests": sum(len(x) for x in lat[n // 2:])}))


SERVE_TEXTS, SERVE_CONNS, SERVE_MAX_BATCH = 2000, 64, 128


def _serve_load(eng, texts_file: str, profiled: bool) -> dict:
    """One service (max_batch 128) behind TCP and HTTP, loaded by
    ``load_client`` in a child process, each device step's host time
    recorded; with ``profiled`` the device's kernels are traced over the
    load (torch.profiler, CUDA activity)."""
    import torch
    from embeddings_tpu_torch.runtime.server import start_serving

    steps = []  # host seconds of each device step (worker thread)

    async def run():
        service, servers = await start_serving(
            eng, host="127.0.0.1", tcp_port=0, http_port=0,
            max_batch=SERVE_MAX_BATCH)
        step = service._encode_batch_counted

        def timed(texts):
            t0 = time.perf_counter()
            try:
                return step(texts)
            finally:
                steps.append(time.perf_counter() - t0)
        service._encode_batch_counted = timed
        ports = [str(s.sockets[0].getsockname()[1]) for s in servers]
        try:
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-c", "import sys, chip_smoke; "
                "chip_smoke.load_client(*sys.argv[1:])", *ports, texts_file,
                str(SERVE_CONNS), cwd=ROOT, stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.PIPE)
            out, err = await asyncio.wait_for(proc.communicate(), 600)
            check(proc.returncode == 0, f"serve_latency client failed: "
                  f"{err.decode()[-2000:]}")
            return json.loads(out.decode().strip().splitlines()[-1]), \
                service.stats.as_dict()
        finally:
            for s in servers:
                s.close()
            await service.stop()

    if profiled:
        from torch.profiler import ProfilerActivity, profile
        trace = profile(activities=[ProfilerActivity.CUDA])
    else:
        trace = contextlib.nullcontext()
    with trace as prof:
        (client, stats) = asyncio.run(run())
        torch.cuda.synchronize()
    row = {"client": client, "service": stats,
           # the worker thread's tokenize + forward + read-back, whose
           # Python holds the GIL the event loop needs
           "step_ms_mean": float(np.mean(steps)) * 1e3,
           "step_ms_p90": float(np.percentile(steps, 90)) * 1e3,
           "step_share_of_wall": sum(steps) / client["wall_s"]}
    if profiled:
        spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(b - a for a, b in spans) / 1e3
        row.update(device_busy_ms=busy, kernels=len(spans),
                   busy_share_of_load_wall=busy / (client["wall_s"] * 1e3),
                   busy_share_of_kernel_span=busy / (
                       (max(b for _, b in spans) - min(a for a, _ in spans))
                       / 1e3) if spans else 0.0)
    return row


def phase_serve_latency():
    """2,000 STS sentences from 64 connections at once (a child process:
    32 TCP v2, 32 HTTP keep-alive to /v1/embeddings) through one service
    with max_batch=128 over the bge engine: requests/s, ServiceStats'
    p50 / p90 / p99 and average batch, the clients' own latencies, each
    device step's host time under the load and alone (a batch of 16);
    then the same load again under torch.profiler for the device's busy
    share over the load's wall time. Recorded, not held to a limit."""
    import tempfile
    eng = STATE.get("engine") or _bge_base_engine()
    texts = _sts_sentences(SERVE_TEXTS)
    check(len(texts) == SERVE_TEXTS, "not enough STS sentences")
    eng.encode(texts[:8])  # warm
    # one device step (tokenize, forward, read-back) of a batch of 16 STS
    # sentences, the load's average batch, with nothing else running
    from embeddings_tpu_torch.runtime.server import BatchingService
    probe = BatchingService(eng)
    alone = []
    for _ in range(10):
        t0 = time.perf_counter()
        probe._encode_batch_counted(texts[:16])
        alone.append(time.perf_counter() - t0)
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(texts, f)
    try:
        reset_counts()
        plain = _serve_load(eng, f.name, profiled=False)
        counts = read_counts()
        traced = _serve_load(eng, f.name, profiled=True)
    finally:
        Path(f.name).unlink()
    for r in (plain, traced):
        check(r["client"]["requests"] == SERVE_TEXTS
              and r["client"]["errors"] == 0
              and r["service"]["errors"] == 0
              and r["service"]["requests"] == SERVE_TEXTS,
              f"serve_latency: {r['client']}, {r['service']}")
    check(counts["K1"] == 4 * counts["K2"] > 0
          and counts == only(K1=counts["K1"], K2=counts["K2"]),
          f"serve_latency: launches {counts}")
    lat = plain["service"]["latency_ms"]
    emit("serve_latency", card=STATE.get("nvidia_smi"),
         model="bge-base-en-v1.5 q4_0 packed + fused qkv (phase main's "
         "engine)", texts=SERVE_TEXTS, connections=SERVE_CONNS,
         max_batch=SERVE_MAX_BATCH, max_wait_ms=2.0,
         requests_per_s=plain["client"]["requests_per_s"],
         wall_s=plain["client"]["wall_s"], p50_ms=lat["p50"],
         p90_ms=lat["p90"], p99_ms=lat["p99"], mean_ms=lat["mean"],
         avg_batch=plain["service"]["avg_batch"],
         batches=plain["service"]["batches"],
         client_ms=plain["client"]["client_ms"],
         step_ms_alone_b16=float(np.median(alone)) * 1e3,
         step_ms_mean=plain["step_ms_mean"],
         step_ms_p90=plain["step_ms_p90"],
         step_share_of_wall=plain["step_share_of_wall"],
         launches=nonzero(counts),
         device_busy_share=traced["busy_share_of_load_wall"],
         profiled_run=traced)


def _cli(*args) -> subprocess.Popen:
    """``python -m embeddings_tpu_torch.cli args`` from the checkout."""
    return subprocess.Popen(
        [sys.executable, "-m", "embeddings_tpu_torch.cli", *map(str, args)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _cli_wait(procs: dict, timeout: float = 600) -> dict:
    """Each process's stdout (and its seconds); fails on any exit code."""
    out = {}
    for name, (proc, t0) in procs.items():
        so, se = proc.communicate(timeout=timeout)
        check(proc.returncode == 0, f"cli {name} exited {proc.returncode}: "
              f"{se[-2000:]}")
        out[name] = (so, time.perf_counter() - t0)
    return out


def phase_cli_path():
    """bge-base's f32 tree (numpy seed 0) saved as a native .npz with a
    vocab.txt of the table's size; then ``python -m
    embeddings_tpu_torch.cli``: convert to .bin and .gguf (q4_0) and
    quantize to q4_0, together; encode from each file (q4_0 packed on
    the card), each equal to Engine.encode of the same file within
    _check_tcp's bound; tokenize; bench --batch 128 --seq 256, whose
    sentences/s must come within 5% of device_time_us of the bge engine's
    forward at the same shape in this process (both the slope method);
    phase ``timing``'s bge bf16 rate (a wall time per forward, host idle
    included) is printed beside them."""
    import tempfile
    import torch
    from embeddings_tpu_torch import EngineConfig, load_model
    from embeddings_tpu_torch.models import params as P
    from embeddings_tpu_torch.tokenizer import tokenizer_from_dir
    cfg, params, vocab = _bge_f32()
    texts = _sts_sentences(6)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        src = tmp / "bge-base.npz"
        t0 = time.perf_counter()
        P.save_native(src, params, cfg)
        (tmp / "vocab.txt").write_text("\n".join(vocab) + "\n",
                                       encoding="utf-8")
        save_s = time.perf_counter() - t0
        files = {"bin": tmp / "bge-q4_0.bin", "gguf": tmp / "bge-q4_0.gguf",
                 "npz": tmp / "bge-q4_0.npz"}
        t0 = time.perf_counter()
        made = _cli_wait({
            "convert_bin": (_cli("convert", src, files["bin"], "--dtype",
                                 "q4_0"), t0),
            "convert_gguf": (_cli("convert", src, files["gguf"], "--dtype",
                                  "q4_0"), t0),
            "quantize": (_cli("quantize", src, files["npz"], "--dtype",
                              "q4_0"), t0)})
        hist = made["quantize"][0].splitlines()[0]
        check(hist.startswith("nibble histogram:"), f"quantize: {hist}")
        prompts = [a for t in texts for a in ("-p", t)]
        t0 = time.perf_counter()
        enc = _cli_wait({name: (_cli("encode", "-m", path, "--dtype", "q4_0",
                                     "--format", "json", *prompts), t0)
                         for name, path in files.items()})
        diffs = {}
        for name, path in files.items():
            got = np.asarray(json.loads(enc[name][0])["embeddings"],
                             np.float32)
            eng = load_model(path, dtype="q4_0", device=torch.device("cuda"),
                             engine_config=EngineConfig(max_seq_len=512,
                                                        batch_size=32))
            want = eng.encode(texts)
            check(got.shape == want.shape == (len(texts), E),
                  f"cli encode {name}: shape {got.shape}")
            diffs[name] = float(np.abs(got - want).max())
            del eng
        t0 = time.perf_counter()
        tok = _cli_wait({
            "tokenize": (_cli("tokenize", "-m", files["npz"], "-p",
                              texts[0]), t0),
            # a short profiled bench: Engine.profile's Chrome trace
            "bench_profile": (_cli("bench", "-m", files["npz"], "--dtype",
                                   "q4_0", "--batch", 8, "--seq", 64,
                                   "--profile", tmp / "trace"), t0)})
        traces = list((tmp / "trace").glob("*.pt.trace.json"))
        check(len(traces) == 1, f"cli bench --profile wrote {traces}")
        trace_kernels = sorted({
            k for e in json.loads(traces[0].read_text())["traceEvents"]
            if e.get("cat", "").lower() == "kernel"
            for k in ("qmm_wgmma_kernel", "attn_sm90_kernel")
            if k in e.get("name", "")})
        ids = json.loads(tok["tokenize"][0].splitlines()[0])
        py_ids = tokenizer_from_dir(tmp).encode(texts[0], max_len=512)
        bench = _cli_wait({"bench": (_cli(
            "bench", "-m", files["npz"], "--dtype", "q4_0", "--batch", B,
            "--seq", L), time.perf_counter())})
        line = json.loads(bench["bench"][0].strip().splitlines()[-1])
    timing = RESULTS.get("timing", {}).get("sentences_per_s")
    # the timing utilities in this process, on the bge engine's forward:
    # the slope on CUDA events, and K1's device time from a profile
    from embeddings_tpu_torch.utils.benchmarking import device_time_us, \
        profiled_device_time_us
    eng = STATE.get("engine") or _bge_base_engine()
    fids = torch.from_numpy(np.random.default_rng(0).integers(
        1000, 30000, (B, L)).astype(np.int32)).cuda()
    fmask = torch.ones_like(fids)
    fwd_us = device_time_us(lambda i, m: eng._forward(i, m), (fids, fmask),
                            lo=5, hi=20)
    k1_us = profiled_device_time_us(lambda i, m: eng._forward(i, m),
                                    (fids, fmask), reps=3,
                                    name_prefix="qmm_wgmma_kernel")
    in_process = B / (fwd_us * 1e-6)
    ratio = line["value"] / in_process
    bound = 1e-6  # _check_tcp's
    check(max(diffs.values()) <= bound,
          f"cli encode vs Engine.encode on the same file: {diffs}")
    check(ids == py_ids, f"cli tokenize {ids} != {py_ids}")
    check(line["unit"] == "sentences/s" and line["value"] > 0,
          f"cli bench: {line}")
    check(abs(ratio - 1) <= 0.05,
          f"cli bench {line['value']} sentences/s vs {in_process} in "
          f"process")
    check(trace_kernels == ["attn_sm90_kernel", "qmm_wgmma_kernel"],
          f"cli bench --profile: the trace's kernels {trace_kernels}")
    check(0 < k1_us < fwd_us, f"device_time_us {fwd_us} us a forward, "
          f"of it K1 {k1_us} us")
    emit("cli_path", card=STATE.get("nvidia_smi"),
         model="bge-base-en-v1.5 shape (random init, numpy seed 0, vocab "
         "30528) saved f32 .npz, converted / quantized to q4_0",
         save_npz_s=save_s,
         seconds={k: v[1] for k, v in {**made, **enc, **tok,
                                       **bench}.items()},
         nibble_histogram=hist, encode_max_abs_diff_vs_engine=diffs,
         bound=bound, tokenize_ids=ids, bench=line,
         in_process_sentences_per_s=in_process,
         bench_over_in_process=ratio,
         timing_bf16_sentences_per_s=timing,
         bench_over_timing=line["value"] / timing if timing else None,
         profile_trace_kernels=trace_kernels,
         device_time_us_forward=fwd_us,
         profiled_k1_us_per_forward=k1_us)


# ---------------------------------------------------------------------------
# the C ABI host: the reference's bert.h surface served by the port
# ---------------------------------------------------------------------------

CAPI_SENTENCES = 256


def _capi_bind(lib):
    import ctypes as C
    f32p, i32p = C.POINTER(C.c_float), C.POINTER(C.c_int32)
    sig = {"et_load_from_file": (C.c_void_p, [C.c_char_p, C.c_char_p]),
           "et_last_error": (C.c_char_p, []),
           "et_free": (None, [C.c_void_p]),
           "et_n_embd": (C.c_int32, [C.c_void_p]),
           "et_encode": (C.c_int, [C.c_void_p, C.c_char_p, f32p]),
           "et_encode_batch": (C.c_int, [C.c_void_p, C.c_int32, C.c_int32,
                                         C.POINTER(C.c_char_p),
                                         C.POINTER(f32p)]),
           "et_tokenize": (C.c_int, [C.c_void_p, C.c_char_p, i32p, i32p,
                                     C.c_int32]),
           "et_forward": (C.c_int, [C.c_void_p, i32p, C.c_int32, f32p])}
    for name, (res, args) in sig.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def _capi_encode_batch(lib, ctx, texts, n_embd: int, batch: int):
    import ctypes as C
    out = np.zeros((len(texts), n_embd), np.float32)
    arr = (C.c_char_p * len(texts))(*[t.encode() for t in texts])
    rows = (C.POINTER(C.c_float) * len(texts))(
        *[out[i].ctypes.data_as(C.POINTER(C.c_float))
          for i in range(len(texts))])
    check(lib.et_encode_batch(ctx, batch, len(texts), arr, rows) == 0,
          f"et_encode_batch: {lib.et_last_error()}")
    return out


def phase_capi_path():
    """The C ABI host (``csrc/capi.cpp``: the ABI of
    ``native/embeddings_c.h``, the reference's ``bert.h`` surface): build
    it and the reference's dlopen demo (``examples/capi_demo.cpp``) with
    g++; write bge-base q4_0 packed at full width and depth with the
    port's ``save_native`` beside the STS fixture's vocab; load it in this
    process through ctypes (``et_load_from_file``, the card by default)
    and run ``et_encode_batch`` over 256 STS sentences: equal to
    ``Engine.encode_batch`` on the same engine configuration, 48 K1 + 12
    K2 a forward and nothing else (this process's counters); the same
    from a thread that did not load the model; ``et_forward`` on
    ``et_tokenize``'s ids equal to ``Engine.forward`` on the same ids and
    mask made in Python (max abs 0), and against ``et_encode`` (cosine >=
    0.999: bf16 forwards at the text's own length, the einsum path, and
    at its bucket, K2); the tokenize capacity edges of
    ``tests/test_capi.py``; then the demo binary in a subprocess (exit 0,
    unit norms). Prints sentences/s through the ABI beside
    ``Engine.encode_batch``'s."""
    import ctypes as C
    import os
    import shutil
    import tempfile
    import threading
    import torch
    from embeddings_tpu_torch import capi, load_model
    from embeddings_tpu_torch.models import params as P
    t0 = time.perf_counter()
    lib_path, demo = capi.build(), capi.build_demo()
    build_s = time.perf_counter() - t0
    _bge_base_engine()  # the tree, built once
    cfg, unfused = STATE["params"][0], STATE["params_unfused"]
    tmp = Path(tempfile.mkdtemp(prefix="capi_"))
    try:
        model = tmp / "bge-base-q4_0.npz"
        t0 = time.perf_counter()
        P.save_native(model, unfused, cfg)
        shutil.copyfile(FIXTURE / "model" / "vocab.txt", tmp / "vocab.txt")
        write_s = time.perf_counter() - t0
        os.environ.pop(capi.DEVICE_VAR, None)  # the default: cuda
        lib = _capi_bind(C.CDLL(str(lib_path)))
        ctx = lib.et_load_from_file(str(model).encode(), b"q4_0")
        check(bool(ctx), f"et_load_from_file: {lib.et_last_error()}")
        n_embd = lib.et_n_embd(ctx)
        texts = _sts_sentences(CAPI_SENTENCES)
        eng = load_model(model, dtype="q4_0", device=torch.device("cuda"))
        bs = eng.engine_config.batch_size
        n = n_bucketed_forwards(eng, texts)
        ref = eng.encode_batch(texts, batch_size=bs)
        with plain_calls() as calls:
            reset_counts()
            got = _capi_encode_batch(lib, ctx, texts, n_embd, bs)
            counts = read_counts()
        err = float(np.abs(got - ref).max())
        check(got.shape == (CAPI_SENTENCES, E) and err <= 1e-6,
              f"C ABI vs Engine.encode_batch: max abs {err}")
        check(counts == only(K1=48 * n, K2=12 * n)
              and not any(calls.values()),
              f"C ABI launches {counts} over {n} forwards, plain {calls}")
        box = {}
        th = threading.Thread(target=lambda: box.setdefault(
            "emb", _capi_encode_batch(lib, ctx, texts[:8], n_embd, 8)))
        th.start()
        th.join()
        one = eng.encode_batch(texts[:8], batch_size=8)
        thread_err = float(np.abs(box["emb"] - one).max())
        check(thread_err <= 1e-6, f"C ABI from another thread: {thread_err}")
        # et_forward on et_tokenize's ids against et_encode
        ids = (C.c_int32 * 512)()
        n_ids = C.c_int32(0)
        check(lib.et_tokenize(ctx, texts[0].encode(), ids, C.byref(n_ids),
                              512) == 0, "et_tokenize failed")
        e_enc = np.zeros(n_embd, np.float32)
        e_fwd = np.zeros(n_embd, np.float32)
        fp = C.POINTER(C.c_float)
        check(lib.et_encode(ctx, texts[0].encode(),
                            e_enc.ctypes.data_as(fp)) == 0, "et_encode")
        check(lib.et_forward(ctx, ids, n_ids, e_fwd.ctypes.data_as(fp)) == 0,
              "et_forward")
        # et_forward against Engine.forward on the same ids and mask made
        # here: the ABI's marshalling (ids, order, mask) bit for bit
        ids_np = np.frombuffer(ids, np.int32)[:n_ids.value][None].copy()
        e_py = eng.forward(ids_np, np.ones_like(ids_np))[0]
        fwd_py_err = float(np.abs(e_fwd - e_py).max())
        # et_forward runs at the text's own length (not a multiple of 8:
        # the einsum path), et_encode at its bucket (K2): bf16 paths apart
        fwd_err = float(np.abs(e_fwd - e_enc).max())
        fwd_cos = float(_row_cos(e_fwd[None], e_enc[None])[0])
        check(fwd_py_err == 0.0, f"et_forward vs Engine.forward on the "
              f"same ids and mask: max abs {fwd_py_err}")
        tiny = (C.c_int32 * 4)(-9, -9, -9, -9)
        n_tiny = C.c_int32(0)
        rc0 = lib.et_tokenize(ctx, texts[0].encode(), tiny, C.byref(n_tiny),
                              0)
        rc4 = lib.et_tokenize(ctx, texts[0].encode(), tiny, C.byref(n_tiny),
                              4)
        check(fwd_cos >= 0.999 and rc0 == -1 and rc4 == 0
              and 0 < n_tiny.value <= 4,
              f"et_forward vs et_encode cos {fwd_cos}, tokenize caps rc "
              f"{rc0}/{rc4} n={n_tiny.value}")
        # sentences/s: the ABI against Engine.encode_batch, one warm pass
        # each, then the median of 3
        rates = {}
        for name, fn in (("c_abi", lambda: _capi_encode_batch(
                lib, ctx, texts, n_embd, bs)),
                ("engine", lambda: eng.encode_batch(texts, batch_size=bs))):
            fn()
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            rates[name] = CAPI_SENTENCES / float(np.median(walls))
        lib.et_free(ctx)
        # the reference's dlopen demo, in its own process, on the card
        env = {k: v for k, v in os.environ.items() if k != capi.DEVICE_VAR}
        t0 = time.perf_counter()
        proc = subprocess.run([str(demo), str(lib_path), str(model), "q4_0",
                               "hello world", "the quick brown fox"],
                              capture_output=True, text=True, timeout=300,
                              env=env)
        demo_s = time.perf_counter() - t0
        check(proc.returncode == 0 and proc.stdout.count("|x|=1.0000") == 2,
              f"capi_demo: rc {proc.returncode}\n{proc.stdout[-1500:]}\n"
              f"{proc.stderr[-1500:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    STATE["capi_rates"] = rates
    emit("capi_path", model="bge-base-en-v1.5 (random init, numpy seed 0, "
         "vocab 30528) q4_0 packed, save_native", library=str(
             lib_path.relative_to(ROOT)), build_s=build_s, write_s=write_s,
         sentences=CAPI_SENTENCES, forwards=n, batch_size=bs,
         launches=counts, plain_calls=calls,
         c_abi_vs_engine_max_abs=err, other_thread_max_abs=thread_err,
         forward_vs_engine_forward_max_abs=fwd_py_err,
         forward_tokens=n_ids.value,
         forward_vs_encode_max_abs=fwd_err, forward_vs_encode_cos=fwd_cos,
         tokenize_caps={"rc_cap0": rc0, "rc_cap4": rc4,
                        "n_cap4": n_tiny.value},
         sentences_per_s_c_abi=rates["c_abi"],
         sentences_per_s_engine=rates["engine"], demo_s=demo_s,
         demo_stdout=proc.stdout.splitlines()[:3])


# ---------------------------------------------------------------------------
# data x model meshes: Megatron TP (and MoE's expert split) on the card
# ---------------------------------------------------------------------------

def _tp_check(name: str, eng, single, texts, want: dict,
              attn: str) -> dict:
    """One TP engine: encode_batch with exact launch counts, every
    attention launch on "sm90", no plain-version call; cosine >= 0.999
    to the single-device Engine on the same weights."""
    import torch
    from embeddings_tpu_torch.ops import attention as A
    wrappers = {"K2": A.fused_attention, "K7": A.fused_attention_bias}
    reset_counts()  # clears K7's routes (not K2's): count the difference
    with plain_calls() as calls:
        (emb, counts, n, wall), routes = _routed(
            wrappers[attn], lambda: _run_counted(eng, texts))
    check(n == 1 and counts == want and not any(calls.values()),
          f"tp {name}: launches {counts} over {n} forwards, want {want}, "
          f"plain {calls}")
    check(routes == {"sm90": want[attn]},
          f"tp {name}: {attn} launches by route {routes}")
    ref = single.encode_batch(texts)
    cos = _row_cos(emb, ref)
    norms = np.linalg.norm(emb, axis=1)
    check(np.isfinite(emb).all() and np.abs(norms - 1).max() < 1e-3
          and cos.min() >= 0.999,
          f"tp {name}: vs the single-device Engine min cos {cos.min()}")
    torch.cuda.synchronize()
    return dict(launches={k: v for k, v in counts.items() if v},
                attention_routes=routes, forwards=n, wall_s=wall,
                tp_vs_single_device_min_cos=float(cos.min()),
                norm_min=float(norms.min()), norm_max=float(norms.max()))


def phase_tp_path():
    """Data x model meshes through Engine(mesh=make_mesh(dp, tp, [cuda] *
    dp*tp)).encode_batch, q4_0 packed, random weights from numpy seed 0,
    q/k/v apart (shard_params cuts each weight once): bge-base at B=32,
    L=512 on (1, 2), (2, 2) and (1, 4): 6 K1 a layer a shard (q, k, v, o,
    up, down; o and down with no epilogue on K/tp rows, then the sum, the
    bias, the residual and the LayerNorm) and one K2 on the shard's H/tp
    heads (3 at tp = 4), all on "sm90"; int8 at (1, 2) (every matmul on
    K3, each shard's own requantized slices) and at (1, 4) (q, k and v at
    N = 192 stay on K1 with the JAX package's warning, the rest K3);
    packed rows at (2, 2) (K4); all-mpnet-base-v2 at (1, 2) (K7 on 6
    local heads with its half of the table) at B=32, L=256;
    nomic-embed-text-v2-moe at (1, 2) at B=4, L=256 (the MoE halves'
    experts split 4 a shard, every local expert on every token, one sum);
    each against the single-device Engine, cosine >= 0.999. Then a mesh
    that cannot shard (tp = 5) raises the JAX package's message."""
    import torch
    from embeddings_tpu_torch.ops import attention as A
    from embeddings_tpu_torch.ops.qmatmul import qmatmul
    from embeddings_tpu_torch.parallel import make_mesh
    cuda = torch.device("cuda")
    Bx, Lx = TP_SHAPE
    texts = [_joined(i * 60, 60) for i in range(Bx)]
    ec = dict(batch_size=Bx, max_seq_len=Lx)
    single = _bge_base_engine(**ec)
    single8 = _bge_base_engine(int8_compute=True, **ec)
    out = {"model": "bge-base-en-v1.5 (random init, numpy seed 0, vocab "
                    "30528) q4_0 packed, q/k/v apart", "batch": [Bx, Lx]}
    for dp, tp in TP_MESHES:
        mesh = make_mesh(dp, tp, [cuda] * (dp * tp))
        t0 = time.perf_counter()
        eng = _bge_base_engine(mesh=mesh, **ec)
        build_s = time.perf_counter() - t0
        check(all(len(eng.tokenize(t)) == Lx for t in texts),
              f"tp texts do not fill L={Lx}")
        shards = dp * tp
        row = _tp_check(f"bge {dp}x{tp}", eng, single, texts,
                        only(K1=6 * NL * shards, K2=NL * shards), "K2")
        STATE.setdefault("launches", {})[f"qmatmul_tp_{dp}x{tp}"] = dict(
            qmatmul.shapes)
        out[f"bge_{dp}x{tp}"] = dict(row, engine_build_s=build_s,
                                     local_heads=H // tp)
        STATE[f"tp_bge_{dp}x{tp}_engine"] = eng
    STATE["tp_bge_single"] = single
    for tp, want in ((2, only(K3=6 * NL * 2, K3_rows=6 * NL * 2,
                              K2=NL * 2)),
                     (4, only(K1=3 * NL * 4, K3=3 * NL * 4,
                              K3_rows=3 * NL * 4, K2=NL * 4))):
        eng8 = _bge_base_engine(mesh=make_mesh(1, tp, [cuda] * tp),
                                int8_compute=True, **ec)
        out[f"bge_int8_1x{tp}"] = _tp_check(f"bge int8 1x{tp}", eng8,
                                            single8, texts, want, "K2")
    # token-packed rows on (2, 2): K4 on every shard's 6 heads
    eng = STATE["tp_bge_2x2_engine"]
    short = _sts_sentences(600)
    seen = []
    run = eng._forward_packed

    def spy(*a, **kw):
        seen.append(a[0].shape)
        return run(*a, **kw)
    eng._forward_packed = spy
    try:
        reset_counts()
        with plain_calls() as calls:
            emb = eng.encode_batch_packed(short, row_len=128)
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        del eng._forward_packed
    n = len(seen)
    want = only(K1=6 * NL * 4 * n, K4=NL * 4 * n)
    routes = dict(A.fused_attention_segmented.routes)
    check(n >= 1 and counts == want and not any(calls.values())
          and routes == {"sm90": NL * 4 * n},
          f"tp packed 2x2: launches {counts} over {n} packed forwards, "
          f"want {want}, routes {routes}, plain {calls}")
    cos = _row_cos(emb, single.encode_batch_packed(short, row_len=128))
    check(cos.min() >= 0.999, f"tp packed 2x2 vs single: {cos.min()}")
    out["bge_packed_2x2"] = dict(packed_forwards=n, shapes=[list(s) for s
                                                             in seen],
                                 launches={k: v for k, v in counts.items()
                                           if v}, attention_routes=routes,
                                 tp_vs_single_device_min_cos=float(cos.min()))
    # MPNet: K7 with each shard's half of the relative-position table
    Bm, Lm = TP_MPNET
    mtexts = [_joined(i * 60, 60) for i in range(Bm)]
    mec = dict(batch_size=Bm, max_seq_len=Lm)
    meng = _family_engine("mpnet", mesh=make_mesh(1, 2, [cuda] * 2), **mec)
    check(all(len(meng.tokenize(t)) == Lm for t in mtexts),
          f"mpnet texts do not fill L={Lm}")
    out["mpnet_1x2"] = dict(_tp_check(
        "mpnet 1x2", meng, _family_engine("mpnet", **mec), mtexts,
        only(K1=6 * NL * 2, K7=NL * 2), "K7"), batch=[Bm, Lm],
        model="all-mpnet-base-v2 (random init, numpy seed 0) q4_0 packed",
        local_heads=H // 2)
    # nomic-embed-text-v2-moe: the MoE halves' experts split over "model"
    Bo, Lo = TP_MOE
    otexts = [_joined(i * 60, 60) for i in range(Bo)]
    oec = dict(batch_size=Bo, max_seq_len=Lo)
    oeng = _moe_engine(mesh=make_mesh(1, 2, [cuda] * 2), **oec)
    dense_k1 = 6 * (MOE_NL // 2) + 4 * (MOE_NL // 2)
    out["nomic_moe_1x2"] = dict(_tp_check(
        "nomic_moe 1x2", oeng, _moe_engine(**oec), otexts,
        only(K1=dense_k1 * 2, K2=MOE_NL * 2), "K2"), batch=[Bo, Lo],
        experts_per_shard=MOE_EXPERTS // 2,
        model="nomic-embed-text-v2-moe (HF-named random weights, numpy "
              "seed 0) q4_0 packed, experts dense")
    # a mesh that cannot shard: the JAX package's words
    bad = _bge_base_engine(mesh=make_mesh(1, 5, [cuda] * 5), **ec)
    try:
        bad.encode_batch(texts[:5])
        fail("tp=5 ran: bge's 768 columns do not split in 5")
    except ValueError as exc:
        msg = str(exc)
    check(msg == "tp=5 cannot shard attn.q for this model (dimension not "
                 "divisible); lower tp or use spmd='gspmd'",
          f"tp=5 refusal: {msg}")
    out["refusal_tp5"] = msg
    emit("tp_path", **out)



# ---------------------------------------------------------------------------
# two processes on torch.distributed, both on the one card
# ---------------------------------------------------------------------------

MH_PROCS, MH_SENTENCES = 2, 256
MH_TIMEOUT_S = 600   # the two workers together, spawn to exit


@contextlib.contextmanager
def collective_ms():
    """The host ms of every ``mesh.Collective`` call inside the block, one
    entry a call; yields the list."""
    from embeddings_tpu_torch.parallel import mesh as Me
    calls, saved = [], {n: getattr(Me.Collective, n)
                        for n in ("all_reduce", "all_gather")}

    def timed(fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                calls.append((time.perf_counter() - t0) * 1e3)
        return call
    for n, fn in saved.items():
        setattr(Me.Collective, n, timed(fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(Me.Collective, n, fn)


def _mh_forward_ms(eng, shape, rounds: int = 3) -> dict:
    """Engine._forward on random ids of ``shape`` (every process the
    same): ms a forward (CUDA events over ``rounds`` forwards after one
    warm-up), and the host ms spent in the mesh's collectives a
    forward."""
    ids, mask = _random_batch(shape)
    with collective_ms() as calls:
        ms = cuda_ms(lambda: eng._forward(ids, mask), iters=rounds, warmup=1)
    per = len(calls) // (rounds + 1)
    return dict(forward_ms=ms, collectives_a_forward=per,
                collective_ms_a_forward=sum(calls[-per * rounds:]) / rounds
                if per else 0.0)


def _one_at_a_time(fn):
    """fn() in each process in turn (the others wait at a barrier), so a
    single-device timing has the card to itself."""
    import torch.distributed as dist
    got = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            got = fn()
        dist.barrier()
    return got


def multihost_worker(rank: str, nproc: str, port: str, out: str) -> None:
    """One of phase ``multihost_path``'s processes: torch.distributed over
    a localhost coordinator (``auto_initialize`` with explicit settings),
    every process on the card (cuda:0), bge-base-en-v1.5 q4_0 packed from
    numpy seed 0 at full width and depth. (a) ``distributed_encode_batch``
    on 256 STS sentences: 48 K1 + 12 K2 a forward on "sm90", no plain
    call, both processes' halves bit for bit each Engine's encode of that
    half; (b) a global (data=2, model=2) mesh, data across the processes
    (each runs its one data row at B=16: 144 K1 + 24 K2); (c) a (data=1,
    model=2) mesh, one shard a process (72 K1 + 12 K2), then a (data=1,
    seq=2) mesh (48 K1 + 12 K8a); each mesh cosine >= 0.999 to the
    single-device Engine, and timed against it. Writes one JSON line to
    ``out``."""
    import hashlib
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    from embeddings_tpu_torch.ops import _cuda, attention as A
    from embeddings_tpu_torch.parallel import (auto_initialize,
                                               distributed_encode_batch,
                                               global_devices, make_mesh,
                                               make_mesh_cp, process_shard)
    rank, nproc = int(rank), int(nproc)
    check(auto_initialize(f"127.0.0.1:{port}", nproc, rank)
          and dist.get_rank() == rank, "torch.distributed is not up")
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    res = {"rank": rank, "nvidia_smi": smi[0] if smi else None,
           "loaded_prebuilt": all(_cuda._target(n).exists()
                                  for n in SOURCES)}
    # (a) the distributed encode
    eng = _bge_base_engine()
    texts = _sts_sentences(MH_SENTENCES)
    mine = texts[process_shard(len(texts))]
    n = n_bucketed_forwards(eng, mine)
    reset_counts()
    with plain_calls() as calls:
        t0 = time.perf_counter()
        emb, routes = _routed(A.fused_attention,
                              lambda: distributed_encode_batch(eng, texts))
        wall = time.perf_counter() - t0
    counts = read_counts()
    check(counts == only(K1=48 * n, K2=12 * n) and not any(calls.values())
          and routes == {"sm90": 12 * n},
          f"rank {rank} distributed encode: launches {counts} over {n} "
          f"forwards, K2 routes {routes}, plain {calls}")
    halves = np.concatenate([eng.encode_batch(texts[process_shard(
        len(texts), count=nproc, index=p)]) for p in range(nproc)])
    whole = eng.encode_batch(texts)
    check(emb.shape == (len(texts), E) and np.array_equal(emb, halves),
          f"rank {rank}: the gathered halves differ from this process's "
          f"encode of them (max abs {np.abs(emb - halves).max()})")
    cos = _row_cos(emb, whole)
    check(cos.min() >= 0.99999, f"rank {rank}: distributed vs one "
          f"Engine's encode_batch, min cos {cos.min()}")
    res["encode"] = dict(
        sentences=len(texts), own=len(mine), forwards=n,
        launches={k: v for k, v in counts.items() if v},
        k2_routes=routes, wall_s=wall,
        max_abs_vs_local_halves=float(np.abs(emb - halves).max()),
        max_abs_vs_local_encode_batch=float(np.abs(emb - whole).max()),
        min_cos_vs_local_encode_batch=float(cos.min()),
        sha256=hashlib.sha256(emb.tobytes()).hexdigest())
    # (b), (c): meshes whose axes cross the processes
    Bx, Lx = TP_SHAPE
    mtexts = [_joined(i * 60, 60) for i in range(Bx)]
    ec = dict(batch_size=Bx, max_seq_len=Lx)
    single = _bge_base_engine(**ec)
    single_ms = _one_at_a_time(lambda: _mh_forward_ms(single, TP_SHAPE))
    res["single_device"] = single_ms
    cases = {"global_2x2": (make_mesh, (2, 2), [cuda, cuda],
                            only(K1=6 * NL * 2, K2=NL * 2), "K2"),
             "model_1x2": (make_mesh, (1, 2), [cuda],
                           only(K1=6 * NL, K2=NL), "K2"),
             "seq_1x2": (make_mesh_cp, (1, 2), [cuda],
                         only(K1=4 * NL, K8a=NL), "K8a")}
    for name, (make, (dp, ax), local, want, attn) in cases.items():
        mesh = make(dp, ax, global_devices(local))
        eng = _bge_base_engine(mesh=mesh, **ec)
        check(all(len(eng.tokenize(t)) == Lx for t in mtexts),
              f"{name}: texts do not fill L={Lx}")
        if attn == "K2":
            row = _tp_check(f"{name} rank {rank}", eng, single, mtexts,
                            want, "K2")
        else:
            reset_counts()
            with plain_calls() as calls:
                emb, counts, nf, wall = _run_counted(eng, mtexts)
            routes = dict(A.fused_attention_cp.routes)
            check(nf == 1 and counts == want and not any(calls.values())
                  and routes == {"sm90": want["K8a"]},
                  f"{name} rank {rank}: launches {counts} over {nf} "
                  f"forwards, want {want}, K8a routes {routes}, plain "
                  f"{calls}")
            cos = _row_cos(emb, single.encode_batch(mtexts))
            check(cos.min() >= 0.999, f"{name} rank {rank}: vs the "
                  f"single-device Engine min cos {cos.min()}")
            row = dict(launches={k: v for k, v in counts.items() if v},
                       attention_routes=routes, forwards=nf, wall_s=wall,
                       mesh_vs_single_device_min_cos=float(cos.min()))
        res[name] = dict(row, mesh=dict(mesh.shape),
                         ranks=mesh.ranks.tolist(), backend=mesh.backend,
                         **_mh_forward_ms(eng, TP_SHAPE))
    Path(out).write_text(json.dumps(res))
    print(json.dumps({"multihost_worker": res}), flush=True)
    dist.destroy_process_group()


def _spawn_workers(tag: str, n: int, call: str, args_of, env_of=None,
                   timeout: float = MH_TIMEOUT_S) -> tuple[list, float]:
    """Run ``n`` workers in fresh interpreters (``chip_smoke.<call>(*
    args_of(rank))``, with ``env_of(rank)`` as their environment), each
    log in ``OUT_DIR/<tag>_<rank>.log``; a worker that fails, or not
    ending in ``timeout`` seconds, fails the phase (all are killed).
    Returns their JSON outputs (``OUT_DIR/<tag>_<rank>.json``, the
    last of each worker's arguments) and the wall seconds."""
    OUT_DIR.mkdir(exist_ok=True)
    outs = [OUT_DIR / f"{tag}_{r}.json" for r in range(n)]
    logs = [OUT_DIR / f"{tag}_{r}.log" for r in range(n)]
    for f in outs:
        f.unlink(missing_ok=True)
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(n):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", "import sys, chip_smoke; "
                     f"chip_smoke.{call}(*sys.argv[1:])",
                     *map(str, args_of(r)), str(outs[r])], cwd=ROOT,
                    stdout=log, stderr=subprocess.STDOUT,
                    env=None if env_of is None else env_of(r)))
        while True:
            codes = [p.poll() for p in procs]
            if None not in codes or any(codes) or \
                    time.perf_counter() - t0 > timeout:
                break  # all ended, one failed, or too long: kill the rest
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    tails = {r: logs[r].read_text()[-3000:] for r in range(n)}
    check(len(procs) == n and all(p.returncode == 0 for p in procs),
          f"{tag} workers exited {[p.returncode for p in procs]} after "
          f"{wall:.1f} s: {tails}")
    return [json.loads(f.read_text()) for f in outs], wall


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _prebuild() -> None:
    """Build the kernels and the native tokenizer here, so that the
    workers only load them."""
    from embeddings_tpu_torch.ops import _cuda
    from embeddings_tpu_torch.tokenizer import native
    _cuda.build(*SOURCES)
    native.build()


def phase_multihost_path():
    """Two processes on the one card (``multihost_worker``), spawned in
    fresh interpreters after the kernels and the native tokenizer are
    built here (the workers only load them), on a localhost coordinator;
    each worker's output goes to a file, and a worker that fails or does
    not end in ``MH_TIMEOUT_S`` fails the phase (both are killed). Both
    must return the same distributed encode, and print their backend
    ("gloo+host": two processes on one card)."""
    _prebuild()
    port = _free_port()
    res, wall = _spawn_workers("multihost", MH_PROCS, "multihost_worker",
                               lambda r: (r, MH_PROCS, port))
    check(len({r["encode"]["sha256"] for r in res}) == 1,
          "the processes' distributed encodes differ")
    for r in res:
        print(json.dumps({"multihost_worker": r["rank"],
                          "nvidia_smi": r["nvidia_smi"],
                          **{k: {"backend": r[k]["backend"],
                                 "forward_ms": r[k]["forward_ms"]}
                             for k in ("global_2x2", "model_1x2",
                                       "seq_1x2")},
                          "single_device_ms":
                              r["single_device"]["forward_ms"]}),
              flush=True)
    emit("multihost_path", processes=MH_PROCS,
         coordinator=f"tcp://127.0.0.1:{port}", wall_s=wall,
         model="bge-base-en-v1.5 (random init, numpy seed 0, vocab 30528) "
               "q4_0 packed", workers=res)


# ---------------------------------------------------------------------------
# four cards of one host: one process driving all four (multicard_path,
# the JAX package's single-host mesh over every device) and four processes
# over NCCL, one card each (nccl_path)
# ---------------------------------------------------------------------------

MC_CARDS = 4
EXPLICIT_PHASES: set = set()  # the phases --phases named
# data parallelism over the four cards at the timing shape (a card: B=32)
MC_DP_SHAPE = (B, L)
MC_ROUNDS = 3  # alternating timing rounds a mesh


def _four_cards(phase: str) -> bool:
    """True where four cards are visible. With fewer, a phase of the
    default list prints one "not run" line and the script goes on; one
    that --phases named fails."""
    import torch
    n = torch.cuda.device_count()
    if n >= MC_CARDS:
        return True
    check(phase not in EXPLICIT_PHASES,
          f"{phase} needs {MC_CARDS} cards; {n} visible")
    note = f"not run: {n} card{'' if n == 1 else 's'} visible"
    RESULTS[phase] = {"phase": phase, "not_run": note}
    print(json.dumps({phase: note}), flush=True)
    return False


def _smi_lines() -> list:
    """nvidia-smi's name and power limit, one line a card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()


def _card_kernels(dev, rng) -> dict:
    """K1 and K3 at bge's four shapes, K2 at B=128, L=256 (ragged) and
    K8a at bge's CP shard, launched on ``dev`` while cuda:0 is current,
    each against its plain version on ``dev`` at its tolerance; every one
    launched (its counter rose)."""
    import torch
    from embeddings_tpu_torch.ops import attention as A, qmatmul as Q
    before = read_counts()
    out = {}
    for name, (K, N, epi) in K1_SHAPES.items():
        args, kw, qt = k1_inputs(rng, M, K, N, "q4_0", True, epi, dev)
        out[f"K1_{name}"] = compare(Q.qmatmul(*args.values(), **kw),
                                    Q.qmatmul_ref(*args.values(), **kw),
                                    K1_RTOL, K1_ATOL_RMS)
        kept = Q.keep_int8_weight(qt).int8
        out[f"K3_{name}"] = compare(
            Q.qmatmul(*args.values(), int8_compute=True, int8_weight=kept,
                      **kw),
            Q.qmatmul_int8_ref(*args.values(), **kw), K3_RTOL, K3_ATOL_RMS)
        del args, kw, qt, kept
    lens = rng.integers(1, L + 1, B)
    lens[0], lens[1] = 0, L
    out["K2"] = _k2_case(rng, B, L, lens.tolist(), dev)
    Bx, Lc, Lx = K8A_CASES[0]
    q, kv, lens = _cp_attn_inputs(rng, Bx, Lc, Lx, dev, fused_q=True)
    kw = dict(B=Bx, Lc=Lc, L=Lx, H=H, D=D)
    out["K8a"] = compare(A.fused_attention_cp(q, kv, lens, **kw),
                         A.fused_attention_cp_ref(q, kv, lens, **kw),
                         K2_RTOL, K2_ATOL_RMS)
    torch.cuda.synchronize(dev)
    added = {k: read_counts()[k] - n for k, n in before.items()}
    for key, r in out.items():
        check(r["ok"] and r.get("zero_rows_exact", True),
              f"{key} on {dev} disagrees: {r}")
    check(added == only(K1=4, K3=4, K3_rows=4, K3_requant=4, K2=1, K8a=1)
          and torch.cuda.current_device() == 0,
          f"the kernels on {dev}: launches {added}, current device "
          f"{torch.cuda.current_device()}")
    return {k: dict(max_abs_err=r["max_abs_err"], ok=r["ok"])
            for k, r in out.items()}


def _covered_ms(edges) -> float:
    """The ms that at least one of the (start, end) us intervals
    covers."""
    total, reach = 0.0, None
    for a, b in sorted(edges):
        if reach is None or a > reach:
            total, reach = total + (b - a), b
        elif b > reach:
            total, reach = total + (b - reach), b
    return total / 1e3


def card_profile(fn, devices) -> dict:
    """One call of fn's device events by card (torch.profiler, one
    warm-up step, 20 ms gaps at both edges as in ``device_profile``): on
    each of ``devices`` (and any other card the call touched), its matmul
    (``qmm_wgmma_kernel``), attention (``attn_sm90_kernel``),
    row-quantization and NCCL kernels and its copies; its busy ms, the
    time at least one of them runs (NCCL's own stream overlaps the
    compute stream, and an NCCL kernel's time includes its wait for the
    other processes), the NCCL kernels' share of it, and its idle share
    over the call's span (the first start to the last end on any card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    gap_s = 0.02
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            time.sleep(gap_s)
            fn()
            for d in devices:
                torch.cuda.synchronize(d)
            time.sleep(gap_s)
            prof.step()
    kinds = {"qmm_wgmma_kernel": "matmuls", "attn_sm90_kernel": "attention",
             "quant_rows_kernel": "row_quant", "nccl": "collectives",
             "Memcpy": "copies"}

    def card():
        return {"matmuls": 0, "attention": 0, "row_quant": 0,
                "collectives": 0, "copies": 0, "other": 0, "edges": [],
                "nccl_edges": []}
    per = {torch.device(d).index: card() for d in devices}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.name.startswith("ProfilerStep"):
            continue
        c = per.setdefault(e.device_index, card())
        kind = next((v for k, v in kinds.items() if k in e.name), "other")
        c[kind] += 1
        edge = (e.time_range.start, e.time_range.end)
        c["edges"].append(edge)
        if kind == "collectives":
            c["nccl_edges"].append(edge)
    edges = [x for c in per.values() for x in c["edges"]]
    span = ((max(b for _, b in edges) - min(a for a, _ in edges)) / 1e3
            if edges else 0.0)
    for c in per.values():
        c["busy_ms"] = _covered_ms(c.pop("edges"))
        c["collective_ms"] = _covered_ms(c.pop("nccl_edges"))
        c["idle_share"] = 1 - c["busy_ms"] / span if span else 1.0
    return {"span_ms": span, "cards": per}


def _random_batch(shape):
    """Random bge ids of ``shape`` (numpy seed 1) and an all-ones mask:
    the timed forwards' input, the same in every process."""
    rng = np.random.default_rng(1)
    ids = rng.integers(1000, 30000, shape).astype(np.int32)
    return ids, np.ones_like(ids)


def _mc_case(name: str, eng, single, one_card, texts, want: dict,
             per_card: dict, shape) -> dict:
    """One mesh over the four cards: encode_batch with exact launch
    counts and no plain-version call, cosine >= 0.999 to the
    single-device Engine; the profile's kernels on every card, ``per_card``
    of each on each; then the forward timed (CUDA events, MC_ROUNDS
    alternating rounds) beside the single-device forward and the same mesh
    on one card (``one_card``)."""
    import torch
    with plain_calls() as calls:
        emb, counts, n, wall = _run_counted(eng, texts)
    check(n == 1 and counts == want and not any(calls.values()),
          f"{name}: launches {counts} over {n} forwards, want {want}, "
          f"plain {calls}")
    cos = _row_cos(emb, single.encode_batch(texts))
    norms = np.linalg.norm(emb, axis=1)
    check(np.isfinite(emb).all() and np.abs(norms - 1).max() < 1e-3
          and cos.min() >= 0.999,
          f"{name}: vs the single-device Engine min cos {cos.min()}")
    ids, mask = _random_batch(shape)
    prof = card_profile(lambda: eng._forward(ids, mask),
                        [torch.device("cuda", c) for c in range(MC_CARDS)])
    per_card = {"row_quant": 0, "collectives": 0, **per_card}
    for c in range(MC_CARDS):
        got = {k: prof["cards"][c][k] for k in per_card}
        check(got == per_card, f"{name}: card {c} ran {got}, want "
              f"{per_card} ({prof['cards']})")
    times = alternating_ms(
        {"four_cards": lambda: eng._forward(ids, mask),
         "one_card": lambda: one_card._forward(ids, mask),
         "single_device": lambda: single._forward(ids, mask)},
        rounds=MC_ROUNDS)
    torch.cuda.synchronize()
    return dict(mesh=dict(eng.mesh.shape),
                devices=[str(d) for d in eng.mesh.devices.flat],
                launches={k: v for k, v in counts.items() if v},
                forwards=n, wall_s=wall,
                mesh_vs_single_device_min_cos=float(cos.min()),
                per_card=per_card, profile=prof,
                forward_ms={k: v[0] for k, v in times.items()},
                forward_ms_range={k: v[1] for k, v in times.items()})


def phase_multicard_path():
    """One process drives four cards (needs four; "not run" otherwise):
    bge-base-en-v1.5 q4_0 packed, random weights from numpy seed 0, full
    width and depth. (a) Each card alone: K1 and K3 at bge's four shapes,
    K2 and K8a launched on cuda:1-3 while cuda:0 is current, against their
    plain versions; an Engine on cuda:3 bit-equal to cuda:0's on 256 STS
    sentences (48 K1 + 12 K2 a forward). (b) Meshes over the four cards
    (``devices=None``, the JAX package's rule): DP 4 x 1 at B=128, L=256
    (48 K1 + 12 K2 a card: a model axis of 1 runs the fused tree); DP x
    TP 2 x 2 and TP 1 x 4 at B=32, L=512 (72 K1 + 12 K2 a card); int8 TP
    1 x 4 (q, k, v on K1, the rest K3); CP 2 x 2 (bge, 48 K1 + 12 K8a a
    card) and CP 1 x 4 (nomic-embed-text-v1 at B=4, L=2,048: 60 K1 + 12
    K8b a card). Each against the single-device Engine (cosine >= 0.999),
    its kernels counted on every card in the profile, and timed beside the
    single-device forward and the same mesh on cuda:0 alone."""
    import torch
    from embeddings_tpu_torch.parallel import make_mesh, make_mesh_cp
    if not _four_cards("multicard_path"):
        return
    torch.cuda.set_device(0)
    cards = [torch.device("cuda", c) for c in range(MC_CARDS)]
    cuda0 = cards[0]
    host = {"nvidia_smi": _smi_lines(), "peer_access": {
        f"{a}->{b}": torch.cuda.can_device_access_peer(a, b)
        for a in range(MC_CARDS) for b in range(MC_CARDS) if a != b}}
    for key, args in (("topo", ["topo", "-m"]),
                      ("nvlink", ["nvlink", "--status"])):
        run = subprocess.run(["nvidia-smi", *args], capture_output=True,
                             text=True, timeout=60)
        host[key] = (run.stdout + run.stderr).splitlines()
    print(json.dumps({"multicard_host": host}), flush=True)
    saved = read_counts()  # comparison launches are not path launches
    rng = np.random.default_rng(21)
    alone = {str(d): _card_kernels(d, rng) for d in cards[1:]}
    set_counts(saved)
    texts = _sts_sentences(MH_SENTENCES)
    e0 = _bge_base_engine()
    e3 = _bge_base_engine(device=cards[3])
    check(e3.device == cards[3] and e3.params["layers"]["attn"]["qkv"]["w"]
          .codes.device == cards[3], f"the cuda:3 Engine is on {e3.device}")
    n = n_bucketed_forwards(e3, texts)
    with plain_calls() as calls:
        reset_counts()
        emb3 = e3.encode_batch(texts)
        counts = read_counts()
    emb0 = e0.encode_batch(texts)
    check(counts == only(K1=48 * n, K2=12 * n) and not any(calls.values()),
          f"the cuda:3 Engine: launches {counts} over {n} forwards, plain "
          f"{calls}")
    check(np.array_equal(emb3, emb0), f"the cuda:3 Engine differs from "
          f"cuda:0's: max abs {np.abs(emb3 - emb0).max()}")
    out = {"host": host, "cards_alone": alone,
           "engine_cuda3": dict(sentences=len(texts), forwards=n,
                                launches={k: v for k, v in counts.items()
                                          if v},
                                bit_equal_to_cuda0=True),
           "model": "bge-base-en-v1.5 (random init, numpy seed 0, vocab "
                    "30528) q4_0 packed; nomic-embed-text-v1 for CP 1 x 4"}
    del e3, e0
    Bd, Ld = MC_DP_SHAPE
    Bt, Lt = TP_SHAPE
    bge = dict(batch_size=Bt, max_seq_len=Lt)
    singles = {"dp": _bge_base_engine(batch_size=Bd, max_seq_len=Ld),
               "bge": _bge_base_engine(**bge),
               "bge8": _bge_base_engine(int8_compute=True, **bge),
               "nomic": _family_engine("nomic", batch_size=CP_NOMIC[0])}
    texts_of = {"dp": [_joined(i * 18, 40) for i in range(Bd)],
                "bge": [_joined(i * 60, 60) for i in range(Bt)],
                "nomic": [_joined(i * 250, 250) for i in range(CP_NOMIC[0])]}
    nomic = functools.partial(_family_engine, "nomic")
    cases = {
        # name: (make, mesh shape, engine, its settings, single, texts,
        #        counts of the forward, per card)
        "dp_4x1": (make_mesh, (4, 1), _bge_base_engine,
                   dict(batch_size=Bd, max_seq_len=Ld), "dp", "dp",
                   only(K1=48 * 4, K2=NL * 4),
                   dict(matmuls=48, attention=NL)),
        "dp_tp_2x2": (make_mesh, (2, 2), _bge_base_engine, bge, "bge",
                      "bge", only(K1=6 * NL * 4, K2=NL * 4),
                      dict(matmuls=6 * NL, attention=NL)),
        "tp_1x4": (make_mesh, (1, 4), _bge_base_engine, bge, "bge", "bge",
                   only(K1=6 * NL * 4, K2=NL * 4),
                   dict(matmuls=6 * NL, attention=NL)),
        "int8_tp_1x4": (make_mesh, (1, 4), _bge_base_engine,
                        dict(int8_compute=True, **bge), "bge8", "bge",
                        only(K1=3 * NL * 4, K3=3 * NL * 4,
                             K3_rows=3 * NL * 4, K2=NL * 4),
                        dict(matmuls=6 * NL, attention=NL,
                             row_quant=3 * NL)),
        "cp_2x2": (make_mesh_cp, (2, 2), _bge_base_engine, bge, "bge",
                   "bge", only(K1=4 * NL * 4, K8a=NL * 4),
                   dict(matmuls=4 * NL, attention=NL)),
        "cp_1x4": (make_mesh_cp, (1, 4), nomic,
                   dict(batch_size=CP_NOMIC[0]), "nomic", "nomic",
                   only(K1=5 * NL * 4, K8b=NL * 4),
                   dict(matmuls=5 * NL, attention=NL))}
    for name, (make, (dp, ax), build, ec, single, tk, want,
               per_card) in cases.items():
        eng = build(mesh=make(dp, ax), **ec)
        one = build(mesh=make(dp, ax, [cuda0] * (dp * ax)), **ec)
        check(sorted(map(str, eng.mesh.devices.flat)) ==
              sorted(map(str, cards)),
              f"{name}: the mesh names {eng.mesh.devices.tolist()}")
        Lx = TP_SHAPE[1] if tk == "bge" else (
            Ld if tk == "dp" else CP_NOMIC[1])
        check(all(len(eng.tokenize(t)) == Lx for t in texts_of[tk]),
              f"{name}: texts do not fill L={Lx}")
        out[name] = _mc_case(
            name, eng, singles[single], one, texts_of[tk], want, per_card,
            (len(texts_of[tk]), Lx))
        line = out[name]
        print(json.dumps({"multicard": name,
                          "forward_ms": line["forward_ms"],
                          "idle_share": [line["profile"]["cards"][c][
                              "idle_share"] for c in range(MC_CARDS)]}),
              flush=True)
        del eng, one
    emit("multicard_path", **out)


NC_PROCS = 4
NC_TIMEOUT_S = 300   # each spawn of four workers, start to exit
NC_LAUNCHERS = ("torchrun", "jax")
# the variables each launcher sets; a worker sees one set only
NC_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
          "LOCAL_WORLD_SIZE", "JAX_COORDINATOR_ADDRESS",
          "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")


def _nc_env(launcher: str, rank: int, port: int) -> dict:
    """A worker's environment as ``launcher`` would set it: torchrun's
    (MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK / LOCAL_RANK) or the
    JAX package's (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID), NCCL's warnings in the worker's log."""
    import os
    env = {k: v for k, v in os.environ.items() if k not in NC_ENV}
    env.setdefault("NCCL_DEBUG", "WARN")
    if launcher == "torchrun":
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(NC_PROCS), RANK=str(rank),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(NC_PROCS))
    else:
        env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES=str(NC_PROCS),
                   JAX_PROCESS_ID=str(rank))
    return env


def nccl_worker(launcher: str, out: str) -> None:
    """One of phase ``nccl_path``'s four processes: ``auto_initialize()``
    from the launcher's variables alone, then the card of the port's card
    rule (cuda:LOCAL_RANK under torchrun; its index among the processes of
    its host under the JAX package's variables), never a hard-coded one;
    ``global_devices()`` names four distinct cards. Under torchrun's
    variables: (a) ``distributed_encode_batch`` of 256 STS sentences, 48
    K1 + 12 K2 a forward, the gathered matrix bit-equal to this process's
    encode of each quarter, cosine >= 0.99999 to one Engine's encode of
    all; (b) meshes over the four processes at B=32, L=512, each
    ``backend == "nccl"``: global (data=2, model=2) and (data=1, model=4),
    72 K1 + 12 K2 a process, and (data=1, seq=4), 48 K1 + 12 K8a; cosine
    >= 0.999 to the single-device Engine, each timed beside it with the
    host ms in collectives, and its card's busy ms and idle share in one
    profiled forward (``card_profile``). Under the JAX package's
    variables: the card and the (data=1, model=4) mesh. Writes one JSON
    line to ``out``."""
    import hashlib
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    from embeddings_tpu_torch.ops import _cuda, attention as A
    from embeddings_tpu_torch.parallel import (auto_initialize,
                                               distributed_encode_batch,
                                               global_devices, make_mesh,
                                               make_mesh_cp, process_shard)
    from embeddings_tpu_torch.runtime.engine import resolve_device
    check(auto_initialize(), "torch.distributed is not up")
    rank, nproc = dist.get_rank(), dist.get_world_size()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = resolve_device(None)
    # one host: a process's local index is its rank
    check(card == torch.device("cuda", rank)
          and torch.cuda.current_device() == rank,
          f"rank {rank} ({launcher}): card {card}, current "
          f"{torch.cuda.current_device()}")
    every = global_devices()
    check([str(e.device) for e in every] ==
          [f"cuda:{r}" for r in range(nproc)]
          and len({e.key for e in every}) == nproc,
          f"rank {rank}: global devices {every}")
    smi = _smi_lines()
    res = {"rank": rank, "launcher": launcher, "card": str(card),
           "nvidia_smi": smi[rank] if rank < len(smi) else None,
           "global_devices": [(e.rank, str(e.device), e.key)
                              for e in every],
           "loaded_prebuilt": all(_cuda._target(n).exists()
                                  for n in SOURCES)}
    Bx, Lx = TP_SHAPE
    mtexts = [_joined(i * 60, 60) for i in range(Bx)]
    ec = dict(batch_size=Bx, max_seq_len=Lx)
    single = _bge_base_engine(**ec)
    on = single.params["layers"]["attn"]["qkv"]["w"].codes.device
    check(on == card, f"rank {rank}: the Engine's weights on {on}")
    res["single_device"] = _mh_forward_ms(single, TP_SHAPE)
    cases = {"model_1x4": (make_mesh, (1, 4), only(K1=6 * NL, K2=NL),
                           "K2")}
    if launcher == "torchrun":
        # (a) the distributed encode
        eng = _bge_base_engine()
        texts = _sts_sentences(MH_SENTENCES)
        mine = texts[process_shard(len(texts))]
        n = n_bucketed_forwards(eng, mine)
        reset_counts()
        with plain_calls() as calls:
            t0 = time.perf_counter()
            emb, routes = _routed(A.fused_attention,
                                  lambda: distributed_encode_batch(eng,
                                                                   texts))
            wall = time.perf_counter() - t0
        counts = read_counts()
        check(counts == only(K1=48 * n, K2=12 * n)
              and not any(calls.values()) and routes == {"sm90": 12 * n},
              f"rank {rank} distributed encode: launches {counts} over {n} "
              f"forwards, K2 routes {routes}, plain {calls}")
        quarters = np.concatenate([eng.encode_batch(texts[process_shard(
            len(texts), count=nproc, index=p)]) for p in range(nproc)])
        whole = eng.encode_batch(texts)
        check(emb.shape == (len(texts), E)
              and np.array_equal(emb, quarters),
              f"rank {rank}: the gathered quarters differ from this "
              f"process's encode of them (max abs "
              f"{np.abs(emb - quarters).max()})")
        cos = _row_cos(emb, whole)
        check(cos.min() >= 0.99999, f"rank {rank}: distributed vs one "
              f"Engine's encode_batch, min cos {cos.min()}")
        res["encode"] = dict(
            sentences=len(texts), own=len(mine), forwards=n,
            launches={k: v for k, v in counts.items() if v},
            k2_routes=routes, wall_s=wall,
            max_abs_vs_local_encode_batch=float(np.abs(emb - whole).max()),
            min_cos_vs_local_encode_batch=float(cos.min()),
            sha256=hashlib.sha256(emb.tobytes()).hexdigest())
        cases = {"global_2x2": (make_mesh, (2, 2),
                                only(K1=6 * NL, K2=NL), "K2"),
                 **cases,
                 "seq_1x4": (make_mesh_cp, (1, 4), only(K1=4 * NL, K8a=NL),
                             "K8a")}
    for name, (make, (dp, ax), want, attn) in cases.items():
        mesh = make(dp, ax)
        check(mesh.backend == "nccl", f"{name} rank {rank}: backend "
              f"{mesh.backend}")
        eng = _bge_base_engine(mesh=mesh, **ec)
        check(all(len(eng.tokenize(t)) == Lx for t in mtexts),
              f"{name}: texts do not fill L={Lx}")
        if attn == "K2":
            row = _tp_check(f"{name} rank {rank}", eng, single, mtexts,
                            want, "K2")
        else:
            with plain_calls() as calls:
                emb, counts, nf, wall = _run_counted(eng, mtexts)
            routes = dict(A.fused_attention_cp.routes)
            check(nf == 1 and counts == want and not any(calls.values())
                  and routes == {"sm90": want["K8a"]},
                  f"{name} rank {rank}: launches {counts} over {nf} "
                  f"forwards, want {want}, K8a routes {routes}, plain "
                  f"{calls}")
            cos = _row_cos(emb, single.encode_batch(mtexts))
            check(cos.min() >= 0.999, f"{name} rank {rank}: vs the "
                  f"single-device Engine min cos {cos.min()}")
            row = dict(launches={k: v for k, v in counts.items() if v},
                       attention_routes=routes, forwards=nf, wall_s=wall,
                       mesh_vs_single_device_min_cos=float(cos.min()))
        ids, mask = _random_batch(TP_SHAPE)
        prof = card_profile(lambda: eng._forward(ids, mask), [card])
        res[name] = dict(row, mesh=dict(mesh.shape),
                         ranks=mesh.ranks.tolist(), backend=mesh.backend,
                         **_mh_forward_ms(eng, TP_SHAPE),
                         profile=prof["cards"][card.index],
                         profile_span_ms=prof["span_ms"])
    Path(out).write_text(json.dumps(res))
    print(json.dumps({"nccl_worker": res}), flush=True)
    dist.destroy_process_group()


def phase_nccl_path():
    """Four processes, one card each, over NCCL (needs four cards; "not
    run" otherwise): ``nccl_worker`` spawned four at a time in fresh
    interpreters after the kernels are built here, once with torchrun's
    variables (the distributed encode and three meshes) and once with the
    JAX package's (the card rule and one mesh); each worker's log in
    ``OUT_DIR/nccl_<launcher>_<rank>.log``. Every process must name
    its own card, read "nccl" for each mesh, and the four must return the
    same distributed encode."""
    import torch
    if not _four_cards("nccl_path"):
        return
    _prebuild()
    out = {"processes": NC_PROCS, "nvidia_smi": _smi_lines(),
           "torch": torch.__version__,
           "nccl": str(torch.cuda.nccl.version()),
           "model": "bge-base-en-v1.5 (random init, numpy seed 0, vocab "
                    "30528) q4_0 packed"}
    for launcher in NC_LAUNCHERS:
        port = _free_port()
        res, wall = _spawn_workers(
            f"nccl_{launcher}", NC_PROCS, "nccl_worker",
            lambda r: (launcher,),
            lambda r, lc=launcher, pt=port: _nc_env(lc, r, pt),
            timeout=NC_TIMEOUT_S)
        check([r["card"] for r in res] ==
              [f"cuda:{r}" for r in range(NC_PROCS)],
              f"{launcher}: cards {[r['card'] for r in res]}")
        if launcher == "torchrun":
            check(len({r["encode"]["sha256"] for r in res}) == 1,
                  "the processes' distributed encodes differ")
        meshes = [k for k in res[0] if isinstance(res[0][k], dict)
                  and "backend" in res[0][k]]
        for r in res:
            print(json.dumps({"nccl_worker": r["rank"],
                              "launcher": launcher, "card": r["card"],
                              "nvidia_smi": r["nvidia_smi"],
                              **{k: {"backend": r[k]["backend"],
                                     "forward_ms": r[k]["forward_ms"],
                                     "collective_ms_a_forward":
                                         r[k]["collective_ms_a_forward"],
                                     "busy_ms": r[k]["profile"]["busy_ms"],
                                     "nccl_kernel_ms":
                                         r[k]["profile"]["collective_ms"],
                                     "idle_share":
                                         r[k]["profile"]["idle_share"]}
                                 for k in meshes},
                              "single_device_ms":
                                  r["single_device"]["forward_ms"]}),
                  flush=True)
        out[launcher] = dict(coordinator=f"tcp://127.0.0.1:{port}",
                             wall_s=wall, workers=res)
    emit("nccl_path", **out)

PHASES = {"device": phase_device, "build": phase_build, "k1": phase_k1,
          "k2": phase_k2, "k3": phase_k3, "k4k5": phase_k4k5,
          "k6k7": phase_k6k7, "attn_tp": phase_attn_tp, "k6w": phase_k6w,
          "k6c": phase_k6c, "k6ca": phase_k6ca,
          "main": phase_main_path,
          "trained": phase_trained, "server": phase_server,
          "emit": phase_emit, "attn_emit": phase_attn_emit,
          "int8_path": phase_int8_path,
          "int8_chain_path": phase_int8_chain_path,
          "packed_path": phase_packed_path,
          "long_path": phase_long_path, "mpnet_path": phase_mpnet_path,
          "jina_path": phase_jina_path,
          "jina_causal_path": phase_jina_causal_path,
          "modernbert_path": phase_modernbert_path,
          "qwen2_path": phase_qwen2_path, "k8": phase_k8,
          "cp_path": phase_cp_path, "capi_path": phase_capi_path,
          "tp_path": phase_tp_path, "multihost_path": phase_multihost_path,
          "multicard_path": phase_multicard_path,
          "nccl_path": phase_nccl_path,
          "distilbert_path": phase_distilbert_path,
          "roberta_path": phase_roberta_path,
          "roformer_path": phase_roformer_path,
          "albert_path": phase_albert_path, "moe_path": phase_moe_path,
          "mla_path": phase_mla_path, "moe_combine": phase_moe_combine,
          "ggml_path": phase_ggml_path,
          "gguf_path": phase_gguf_path, "rerank_path": phase_rerank_path,
          "timing": phase_timing, "native_tok": phase_native_tok,
          "http_path": phase_http_path, "serve_latency": phase_serve_latency,
          "cli_path": phase_cli_path}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (default: all; multicard_path and nccl_path need "
                    "four cards: in the default list they print \"not "
                    "run\" on fewer, named here they fail)")
    named = ap.parse_args().phases
    phases = named.split(",") if named else list(PHASES)
    EXPLICIT_PHASES.update(phases if named else ())
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the GPU")
    sys.path.insert(0, str(ROOT))
    try:
        import embeddings_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the embeddings_tpu_torch package is not beside this "
             f"script: {exc}")
    from embeddings_tpu_torch.ops.qmatmul import qmatmul
    for name in phases:
        qmatmul.routes.clear()  # each phase line shows its own K1 routes
        PHASES[name]()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(RESULTS, indent=1,
                                                        default=str))
    print(json.dumps({"kernels": RESULTS.get("kernels", [])}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
