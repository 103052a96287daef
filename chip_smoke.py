"""Smoke test of the PyTorch/CUDA port on one GPU: builds the hand-written
kernels, holds each against its plain PyTorch version on the card, drives
the bge-base q4_0 encode path (Engine -> encode_batch -> BatchingService
-> TCP), and times the kernels and the forward.

    python3 chip_smoke.py              # every phase, needs one CUDA device
    python3 chip_smoke.py --phases device,build,k1,k2

Each phase prints one JSON line. The last two lines are the kernel table
and ``{"ok": true, "device": {...}}``; any failure exits non-zero before
them. Without a CUDA device (or without the package beside this file) the
script exits non-zero and prints no result. Long output goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "benchmarks" / "fixtures" / "tiny_trained"
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM data-sheet peaks (dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
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

# tolerances (kernel vs plain version on the same inputs, bf16 outputs):
# both round the same bf16 operands and accumulate in f32 in different
# orders, so outputs differ where an f32 value sits next to a bf16
# rounding boundary: one bf16 ulp (2^-8 relative) plus what that flip
# carries through an epilogue. K2 also rounds each probability to bf16
# after exp2 (CUDA exp2f vs torch.exp2 may differ by an f32 ulp), so its
# flips reach the output through the p.v sum.
K1_RTOL, K1_ATOL_RMS = 2.0 ** -7, 1e-3
K2_RTOL, K2_ATOL_RMS = 2.0 ** -6, 1e-2

RESULTS: dict = {}


def emit(phase: str, **fields) -> None:
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


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
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


def k1_cost(Mx, K, N, epilogue) -> tuple[float, float]:
    """(flops, bytes) of one main-path K1 call: each input read once, the
    output written once (q4_0 packed codes, f32 scales and bias)."""
    nbytes = Mx * K * 2 + K // 2 * N + K // 32 * N * 4 + N * 4 + Mx * N * 2
    if epilogue == "bias_residual_ln":
        nbytes += Mx * N * 2 + 2 * N * 4
    return 2.0 * Mx * K * N, float(nbytes)


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi[0] if smi else None,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])


def phase_build():
    from embeddings_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    seconds = _cuda.build("qmatmul", "attention")
    emit("build", seconds=time.perf_counter() - t0, per_source=seconds)


def phase_k1():
    import torch
    from embeddings_tpu_torch.ops.qmatmul import EPILOGUES, qmatmul, \
        qmatmul_ref
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    main = {}
    for name, (K, N, epi) in K1_SHAPES.items():
        args, kw, _ = k1_inputs(rng, M, K, N, "q4_0", True, epi, dev)
        got = qmatmul(*args.values(), **kw)
        ref = qmatmul_ref(*args.values(), **kw)
        torch.cuda.synchronize()
        main[name] = compare(got, ref, K1_RTOL, K1_ATOL_RMS)
        check(main[name]["ok"], f"K1 {name} disagrees: {main[name]}")
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
         f"{K1_ATOL_RMS}*rms(ref)", main=main, small_cases=len(small),
         small_worst_max_abs_err=worst)
    RESULTS["k1_small"] = small


def _k2_case(rng, Bx, Lx, lengths, dev):
    import torch
    from embeddings_tpu_torch.ops.attention import fused_attention, \
        fused_attention_ref
    qkv = torch.from_numpy(rng.standard_normal(
        (Bx * Lx, 3 * E), dtype=np.float32)).to(dev, torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = fused_attention(qkv, lens, B=Bx, L=Lx, H=H, D=D)
    ref = fused_attention_ref(qkv, lens, B=Bx, L=Lx, H=H, D=D)
    torch.cuda.synchronize()
    r = compare(got, ref, K2_RTOL, K2_ATOL_RMS)
    zero_rows = [b for b, n in enumerate(lengths) if n == 0]
    r["zero_rows_exact"] = all(
        bool((got.reshape(Bx, Lx, E)[b] == 0).all()) for b in zero_rows)
    return r


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
    for name, r in (("L256", r256), ("L512", r512)):
        check(r["ok"] and r["zero_rows_exact"],
              f"K2 {name} disagrees: {r}")
    emit("k2_parity", tolerance=f"|err| <= {K2_RTOL}*|ref| + "
         f"{K2_ATOL_RMS}*rms(ref); len-0 rows exactly 0",
         L256=r256, L512=r512)


def _sts_sentences(n: int) -> list[str]:
    rows = (FIXTURE / "sts-test.tsv").read_text().splitlines()
    out = []
    for row in rows:
        out.extend(row.split("\t")[1:3])
    return out[:n]


def _bge_base_engine(**ec):
    import torch
    from embeddings_tpu_torch import BertConfig, EngineConfig, KNOWN_MODELS
    from embeddings_tpu_torch.models import params as P
    from embeddings_tpu_torch.runtime.engine import Engine
    from embeddings_tpu_torch.tokenizer import tokenizer_from_dir
    if "params" not in RESULTS:
        cfg = BertConfig(**{**KNOWN_MODELS["bge-base-en-v1.5"],
                            "vocab_size": 30528})
        t0 = time.perf_counter()
        params = P.fuse_qkv(P.pack_q4_params(P.quantize_params(
            P.init_params(cfg, np.random.default_rng(0)), "q4_0")))
        RESULTS["params"] = (cfg, params, time.perf_counter() - t0)
    cfg, params, _ = RESULTS["params"]
    tok = tokenizer_from_dir(FIXTURE / "model")
    return Engine(params, cfg, tok, EngineConfig(batch_size=128, **ec),
                  device=torch.device("cuda"))


def phase_main_path():
    import torch
    from embeddings_tpu_torch.ops.attention import fused_attention
    from embeddings_tpu_torch.ops.qmatmul import qmatmul
    from embeddings_tpu_torch.runtime.batching import extend_buckets, \
        plan_batches
    eng = _bge_base_engine()
    texts = _sts_sentences(300)
    texts += texts[:8]  # identical sentences: cosine 1.0
    toks = [eng.tokenize(t) for t in texts]
    n_forwards = len(plan_batches(
        [len(t) for t in toks], 128, eng._seq_buckets(),
        extend_buckets(eng.engine_config.batch_buckets, 128)))
    qmatmul.launches = 0
    qmatmul.shapes.clear()
    fused_attention.launches = 0
    t0 = time.perf_counter()
    emb = eng.encode_batch(texts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = qmatmul.launches, fused_attention.launches
    RESULTS["launches"] = {"qmatmul": dict(qmatmul.shapes),
                           "fused_attention": k2}
    norms = np.linalg.norm(emb, axis=1)
    dup = (emb[:8] * emb[-8:]).sum(-1)
    plain = _bge_base_engine(use_pallas="never", compute_dtype="float32")
    emb_plain = plain.encode_batch(texts)
    cos = (emb * emb_plain).sum(-1) / (
        np.linalg.norm(emb, axis=1) * np.linalg.norm(emb_plain, axis=1))
    emit("main_path", model="bge-base-en-v1.5 (random init, numpy seed 0, "
         "vocab 30528) q4_0 packed + fused qkv", sentences=len(texts),
         forwards=n_forwards, wall_s=wall,
         init_quantize_s=RESULTS["params"][2],
         k1_launches=k1, k2_launches=k2,
         k1_per_forward=k1 / n_forwards, k2_per_forward=k2 / n_forwards,
         norm_min=float(norms.min()), norm_max=float(norms.max()),
         identical_min_cos=float(dup.min()),
         kernel_vs_plain_f32_min_cos=float(cos.min()),
         finite=bool(np.isfinite(emb).all()))
    check(np.isfinite(emb).all() and emb.shape == (len(texts), E),
          "main path output not finite / wrong shape")
    check(k1 == 48 * n_forwards and k2 == 12 * n_forwards,
          f"launches {k1} K1 / {k2} K2 over {n_forwards} forwards")
    check(np.abs(norms - 1).max() < 1e-3, "embeddings are not unit norm")
    check(dup.min() >= 1 - 1e-6, "identical sentences differ")
    check(cos.min() >= 0.999, f"kernel path vs plain f32: {cos.min()}")
    RESULTS["engine"] = eng


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
    from embeddings_tpu_torch.runtime.client import TcpClient
    from embeddings_tpu_torch.runtime.server import serve_tcp
    eng = RESULTS["engine"]
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
    emit("server", requests=len(texts), n_embd=n_embd,
         max_abs_diff_vs_encode=diff)
    check(n_embd == E and diff <= 1e-6, f"TCP answers differ by {diff}")


def phase_timing():
    import torch
    import torch.nn.functional as Fn
    from embeddings_tpu_torch.ops.attention import fused_attention, \
        fused_attention_ref
    from embeddings_tpu_torch.ops.qmatmul import dequantize_bf16, qmatmul, \
        qmatmul_ref
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    eng = RESULTS["engine"]
    ids = rng.integers(1000, 30000, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    fwd_ms = cuda_ms(lambda: eng._forward(ids, mask), iters=5)
    kernels, saved = [], (qmatmul.launches, fused_attention.launches)
    launches = RESULTS.get("launches", {"qmatmul": {}, "fused_attention": 0})
    for name, (K, N, epi) in K1_SHAPES.items():
        args, kw, qt = k1_inputs(rng, M, K, N, "q4_0", True, epi, dev)
        a = list(args.values())
        w_bf16 = dequantize_bf16(qt.codes, qt.scales, qt.mins, "q4_0", True)
        flops, nbytes = k1_cost(M, K, N, epi)
        bms, by = bound_ms(flops, nbytes)
        kernels.append({
            "name": f"qmatmul[{name} {K}x{N} {epi}]", "route": "cuda",
            "source": "embeddings_tpu_torch/csrc/qmatmul.cu",
            "replaces": K1_REPLACES,
            "launches": launches["qmatmul"].get((K, N, epi), 0),
            "max_abs_err": RESULTS["k1_parity"]["main"][name]["max_abs_err"],
            "ms": cuda_ms(lambda: qmatmul(*a, **kw)),
            "plain_ms": cuda_ms(lambda: qmatmul_ref(*a, **kw), iters=3),
            "bound_ms": bms, "bound_by": by,
            "library_ms": cuda_ms(lambda: torch.matmul(a[0], w_bf16)),
            "shape": [M, K, N]})
    qkv = torch.from_numpy(rng.standard_normal(
        (M, 3 * E), dtype=np.float32)).to(dev, torch.bfloat16)
    lens = torch.full((B,), L, dtype=torch.int32, device=dev)
    q, k, v = (qkv.reshape(B, L, 3, H, D)[:, :, i].transpose(1, 2)
               .contiguous() for i in range(3))
    keymask = (torch.arange(L, device=dev)[None, :]
               < lens[:, None])[:, None, None, :]
    flops = 4.0 * B * H * L * L * D
    bms, by = bound_ms(flops, M * 3 * E * 2 + M * E * 2 + B * 4)
    kernels.append({
        "name": f"fused_attention[B{B} L{L} H{H} D{D}]", "route": "cuda",
        "source": "embeddings_tpu_torch/csrc/attention.cu",
        "replaces": K2_REPLACES,
        "launches": launches["fused_attention"],
        "max_abs_err": RESULTS["k2_parity"]["L256"]["max_abs_err"],
        "ms": cuda_ms(lambda: fused_attention(qkv, lens, B=B, L=L, H=H,
                                              D=D)),
        "plain_ms": cuda_ms(lambda: fused_attention_ref(
            qkv, lens, B=B, L=L, H=H, D=D), iters=3),
        "bound_ms": bms, "bound_by": by,
        "library_ms": cuda_ms(lambda: Fn.scaled_dot_product_attention(
            q, k, v, attn_mask=keymask)),
        "shape": [B, L, H, D]})
    # timing launches are not main-path launches
    qmatmul.launches, fused_attention.launches = saved
    per_layer_bound = sum(kk["bound_ms"] for kk in kernels)
    emit("timing", batch=[B, L], forward_ms=fwd_ms,
         sentences_per_s=B / fwd_ms * 1e3,
         forward_bound_ms=NL * per_layer_bound,
         kernel_ms_per_forward=NL * sum(kk["ms"] for kk in kernels))
    RESULTS["kernels"] = kernels


PHASES = {"device": phase_device, "build": phase_build, "k1": phase_k1,
          "k2": phase_k2, "main": phase_main_path,
          "trained": phase_trained, "server": phase_server,
          "timing": phase_timing}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    phases = ap.parse_args().phases.split(",")
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the GPU")
    sys.path.insert(0, str(ROOT))
    try:
        import embeddings_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the embeddings_tpu_torch package is not beside this "
             f"script: {exc}")
    for name in phases:
        PHASES[name]()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {k: v for k, v in RESULTS.items()
         if k not in ("engine", "params", "launches")}, indent=1,
        default=str))
    print(json.dumps({"kernels": RESULTS.get("kernels", [])}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
