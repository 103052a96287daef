#!/usr/bin/env python3
"""Time variants of the Hopper attention library against the checkout's,
on one card, in turns: K2, K2e ("only" and "both"), K2i8 (int8 scores,
without emission and with "only", and at B=16, L=1,024, past the rows
whose scores stay in registers), K4 and K4e ("only"; on the packed rows
of the STS fixture), K5 (32 packed rows of 1,024, window 3, the key-block
ranges computed once as the forward does), K7 (MPNet's table bias, jina's
ALiBi bias), K6 (plain and ALiBi), K6w (ModernBERT's banded layers,
window 128), K6c, K6ca, and the CP layout's K8a (bge's shard, q read in
place at row stride 3E) and K8b (nomic's shard) at the shapes the port's
main paths give them (every row full).

    python3 tools/attention_ab.py [--shapes K4_packed,K8b_nomic] \
        [--rounds 2] [VARIANT.cu ...]

Each VARIANT.cu is a variant source of
``embeddings_tpu_torch/csrc/attention_sm90.cu`` (same C interface); it is
built with nvcc beside the checkout's build, under
``embeddings_tpu_torch/_build/`` (one nvcc a variant, all started
together), and its ptxas C75xx notes (each a kernel whose wgmma are
serialized) are printed. For each shape every library runs ``--rounds``
times (CUDA events over 10 launches after 2 warm-ups), the rounds in the
order checkout, variants, then reversed, and so on, and each variant's
output is compared with the checkout's (max abs difference). Prints the
card's name and power limit, then one JSON line per shape. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# name -> (B, L, H, D), mode[, emission]: the main paths' attention
# shapes (K4, K4e: 256 packed rows of 128; K5: 32 packed rows of 1,024;
# "i8s" in place of the mode: K2i8); the CP shapes ("cp" in place of the
# mode) are (B, Lc, L, H, D) of a shard, K8a's q at row stride 3E
CP_SHAPES = {"K8a_bge": (16, 256, 512, 12, 64),
             "K8b_nomic": (4, 512, 2048, 12, 64)}
SHAPES = {"K2_bge": ((128, 256, 12, 64), 0),
          "K4_packed": ((256, 128, 12, 64), 1),
          "K5_packed": ((32, 1024, 12, 64), 2),
          "K2i8_bge": ((128, 256, 12, 64), "i8s"),
          "K2i8_bge_only": ((128, 256, 12, 64), "i8s", "only"),
          "K2i8_long": ((16, 1024, 12, 64), "i8s"),
          "K2e_bge_only": ((128, 256, 12, 64), 0, "only"),
          "K2e_bge_both": ((128, 256, 12, 64), 0, "both"),
          "K4e_packed": ((256, 128, 12, 64), 1, "only"),
          "K7_mpnet": ((128, 256, 12, 64), 3),
          "K7_jina": ((32, 1024, 12, 64), 3),
          "K2_qwen2": ((32, 512, 12, 128), 0),
          "K2_modernbert": ((32, 1024, 12, 64), 0),
          "K6_bert_long": ((2, 2048, 12, 64), 4),
          "K6_qwen2": ((4, 4096, 12, 128), 4),
          "K6_modernbert": ((4, 8192, 12, 64), 4),
          "K6_alibi_jina": ((4, 8192, 12, 64), 5),
          "K6w_modernbert_short": ((32, 1024, 12, 64), 6),
          "K6w_modernbert_long": ((4, 8192, 12, 64), 6),
          "K6c_qwen2_short": ((32, 512, 12, 128), 7),
          "K6c_qwen2": ((4, 4096, 12, 128), 7),
          "K6ca_jina": ((4, 8192, 12, 64), 8),
          **{name: (shape, "cp") for name, shape in CP_SHAPES.items()}}


def build_variants(srcs: list, checkout) -> dict:
    """Build each variant source (one nvcc each, all started together)
    and load it, running ``checkout()`` (the checkout's own build and
    load) meanwhile: {"checkout": its library, source: library, ...}."""
    from embeddings_tpu_torch.ops import _cuda
    from embeddings_tpu_torch.ops.attention import type_lib90
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in map(Path, srcs):
        out = _cuda.BUILD_DIR / f"ab_{src.parent.name}_{src.stem}.so"
        procs[str(src)] = (out, subprocess.Popen(
            [_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-I", str(_cuda.CSRC), "-o", str(out),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {"checkout": checkout()}
    for src, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        print(json.dumps({"variant": src, "ptxas_c75xx_notes":
                          log.count("(C75")}), flush=True)
        libs[src] = ctypes.CDLL(str(out))
        type_lib90(libs[src])
    return libs


def context(got, emit: str):
    """A call's context as f32: the output, or with "only" emission the
    codes times their row scales."""
    if emit == "only":
        return got[0].float() * got[1]
    return (got[0] if emit == "both" else got).float()


def shape_call(name, shape, mode, how, rng, dev):
    """The wrapper call that runs ``name``'s shape, on random bf16 inputs
    (every row full)."""
    import numpy as np
    import torch
    from chip_smoke import _family_bias, packed_tables
    from embeddings_tpu_torch.ops import attention as A
    from embeddings_tpu_torch.ops.alibi import alibi_slopes

    def bf16(*dims):
        return torch.from_numpy(rng.standard_normal(
            dims, dtype=np.float32)).to(dev, torch.bfloat16)
    if mode == "cp":
        B, Lc, L, H, D = shape
        E = H * D
        # K8a's q: a column view of the local fused projection [B*Lc, 3E]
        q = bf16(B * Lc, 3 * E if name.startswith("K8a") else E)[:, :E]
        kv = bf16(B * L, 2 * E)
        lens = torch.full((B,), L, dtype=torch.int32, device=dev)
        kw = dict(B=B, Lc=Lc, L=L, H=H, D=D)
        if name.startswith("K8a"):
            return lambda: A.fused_attention_cp(q, kv, lens, **kw)
        kw["BK"] = A.pick_bk(L)
        return lambda: A.fused_attention_cp_stream(q, kv, lens, **kw)
    B, L, H, D = shape
    qkv = bf16(B * L, 3 * H * D)
    lens = torch.full((B,), L, dtype=torch.int32, device=dev)
    if mode in (0, "i8s"):
        kw = dict(B=B, L=L, H=H, D=D, emit_quantized=how,
                  int8_scores=mode == "i8s")
        return lambda: A.fused_attention(qkv, lens, **kw)
    if mode == 2:
        arrays, W = packed_tables(B, L)
        seg = torch.from_numpy(arrays[1]).to(dev)
        kw = dict(B=B, L=L, H=H, D=D, window=W,
                  ranges=A.block_ranges(seg, L))
        return lambda: A.fused_attention_segmented_blockskip(qkv, seg, **kw)
    if mode == 1:
        seg = torch.from_numpy(packed_tables(B, L)[0][1]).to(dev)
        kw = dict(B=B, L=L, H=H, D=D, emit_quantized=how)
        return lambda: A.fused_attention_segmented(qkv, seg, **kw)
    if mode == 6:
        kw = dict(B=B, L=L, H=H, D=D, window=128)
        return lambda: A.fused_attention_window(qkv, lens, **kw)
    if mode == 3:
        kw = dict(B=B, L=L, H=H, D=D)
        bias = A.prepare_attention_bias(_family_bias(
            "mpnet" if name == "K7_mpnet" else "jina", L, dev), L)
        return lambda: A.fused_attention_bias(qkv, lens, bias, **kw)
    kw = dict(B=B, L=L, H=H, D=D, BK=A.pick_bk(L), causal=mode in (7, 8),
              alibi_slopes=alibi_slopes(H) if mode in (5, 8) else None)
    return lambda: A.fused_attention_stream(qkv, lens, **kw)


def main() -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help="comma-separated subset of " + ",".join(SHAPES))
    ap.add_argument("--rounds", type=int, default=2,
                    help="times each library runs a shape, in turns")
    ap.add_argument("variants", nargs="*", help="variant sources")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import cuda_ms
    from embeddings_tpu_torch.ops import attention as A
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    lib90 = A._lib90
    libs = build_variants(args.variants, lib90)
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    try:
        for name in args.shapes.split(","):
            (shape, mode, *emit) = SHAPES[name]
            how = emit[0] if emit else "no"
            fn = shape_call(name, shape, mode, how, rng, dev)
            ms, outs = {}, {}
            for r in range(args.rounds):
                for key in list(libs)[::-1 if r % 2 else 1]:
                    A._lib90 = lambda key=key: libs[key]
                    ms.setdefault(key, []).append(cuda_ms(fn, iters=10))
                    outs.setdefault(key, context(fn(), how))
            diff = {k: (outs[k] - outs["checkout"]).abs().max().item()
                    for k in libs if k != "checkout"}
            print(json.dumps({"shape": name, "dims": list(shape),
                              "mode": mode, "emit": how, "ms": ms,
                              "max_abs_diff_vs_checkout": diff}), flush=True)
    finally:
        A._lib90 = lib90
    return 0


if __name__ == "__main__":
    sys.exit(main())
