"""Command-line interface of the PyTorch port — the port of
``embeddings_tpu/cli.py``, with one flag more: ``--device`` (default
``cuda``; without a CUDA device the command fails unless it is given
``--device cpu``).

Mirrors the reference's flag surface (bert_params_parse, bert.cpp:140-193:
-m/--model, -p/--prompt, -t/--threads, --port) and its example binaries
(examples/main.cpp = ``encode``, examples/server.cpp = ``serve``,
models/quantize.cpp = ``quantize``, models/convert-to-ggml.py =
``convert``), as subcommands of one tool::

  embeddings-tpu-torch encode   -m MODEL -p "text" [--dtype q4_0]
  embeddings-tpu-torch serve    -m MODEL [--port 8080] [--http-port 8081]
  embeddings-tpu-torch rerank   -m MODEL -q QUERY DOC [DOC ...]
  embeddings-tpu-torch convert  SRC OUT.{npz|bin|gguf} [--dtype f32]
  embeddings-tpu-torch quantize IN.npz OUT.npz --dtype q4_0
  embeddings-tpu-torch bench    -m MODEL [--batch 128 --seq 256]
  embeddings-tpu-torch tokenize -m MODEL -p "text"

(or ``python -m embeddings_tpu_torch.cli ...``). MODEL is an HF
directory, a native .npz, a reference-format ggml .bin, or a GGUF .gguf
(vocab embedded for the latter two). ``convert``'s SRC is any of them
(the JAX CLI takes no .npz there).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from typing import Sequence


def _add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-m", "--model", required=True,
                   help="HF model dir, native .npz, ggml .bin or .gguf")
    p.add_argument("--dtype", default="f32",
                   choices=["f32", "bf16", "f16", "q4_0", "q4_1", "q8_0",
                            "nf4"])
    p.add_argument("--pooling", default=None, choices=["mean", "cls", "max"])
    p.add_argument("-t", "--threads", type=int, default=None,
                   help="accepted for bert.h compatibility; unused")
    p.add_argument("--max-seq", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel mesh size (default: every visible "
                        "card // tp, or 1 with an explicit --device)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel (Megatron) mesh size "
                        "(exclusive with --sp)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence/context-parallel mesh size (exclusive "
                        "with --tp)")
    p.add_argument("--int8", action="store_true",
                   help="int8 tensor-core compute for the quantized "
                        "matmuls (K3; adds ~2^-7-relative error on top of "
                        "the weight quantization)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: a mesh spreads over every visible "
                        "card), cuda:N or cpu (the kernels' plain PyTorch "
                        "versions); a mesh names an explicit device dp * "
                        "tp (or dp * sp) times")


def mesh_layout(device: str, dp: int | None, width: int,
                visible: Sequence = ()) -> tuple[int, list]:
    """(dp, devices) of the --dp x --tp (or --sp) mesh for --device
    ``device``. The default unindexed "cuda" follows the JAX package's
    device rule: the mesh spreads over ``visible`` (the caller passes
    ``parallel.mesh.mesh_devices(None)``: the visible cards, or every
    process's card after ``initialize_distributed``), dp defaults to
    their count // width and dp * width must equal it. An explicit device
    ("cpu", "cuda:N") is named dp * width times (dp default 1): the
    port's way to run a mesh on one card."""
    if device != "cuda":
        import torch
        dp = dp or 1
        return dp, [torch.device(device)] * (dp * width)
    visible = list(visible)
    if dp is None:
        dp = len(visible) // width
    if dp * width != len(visible):
        raise ValueError(f"dp({dp}) x {width} != device count "
                         f"{len(visible)}")
    return dp, visible


def _load_engine(args):
    from .config import EngineConfig
    from .runtime.engine import load_model, resolve_device
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:
        raise SystemExit(f"error: {exc}") from None
    mesh = None
    sp = getattr(args, "sp", 1)
    if sp > 1 and args.tp > 1:
        raise SystemExit("--sp and --tp are mutually exclusive")
    if sp > 1 or args.tp > 1 or (args.dp or 0) > 1:
        from .parallel.context import make_mesh_cp
        from .parallel.mesh import make_mesh, mesh_devices
        width = max(sp, args.tp)
        try:
            dp, devices = mesh_layout(
                args.device, args.dp, width,
                mesh_devices(None) if args.device == "cuda" else ())
        except ValueError as exc:
            raise SystemExit(f"error: {exc}") from None
        mesh = (make_mesh_cp if sp > 1 else make_mesh)(dp, width, devices)
    ec = EngineConfig(max_seq_len=args.max_seq, batch_size=args.batch_size,
                      int8_compute=getattr(args, "int8", False))
    return load_model(args.model, dtype=args.dtype, engine_config=ec,
                      mesh=mesh, pooling=args.pooling,
                      device=None if mesh is not None else device)


def cmd_encode(args) -> int:
    t0 = time.time()
    eng = _load_engine(args)
    t_load = time.time() - t0
    texts = args.prompt if args.prompt else [line.rstrip("\n")
                                             for line in sys.stdin]
    if not texts:
        print("no input: pass -p/--prompt or pipe text on stdin",
              file=sys.stderr)
        return 1
    t0 = time.time()
    embs = (eng.encode_batch_packed(texts) if args.packed
            else eng.encode_batch(texts))
    t_eval = time.time() - t0
    if args.verbose:
        toks = eng.tokenize(texts[0])
        print(f"tokens[0]: {toks}", file=sys.stderr)
        print(f"  {[eng.tokenizer.id_to_token(t) for t in toks]}",
              file=sys.stderr)
    if args.format == "json":
        json.dump({"embeddings": embs.tolist()}, sys.stdout)
        print()
    else:
        for e in embs:
            print(" ".join(f"{v:.6f}" for v in e))
    print(f"load: {t_load*1e3:.0f} ms | eval: {t_eval*1e3:.0f} ms "
          f"({len(texts)} texts)", file=sys.stderr)
    return 0


def cmd_rerank(args) -> int:
    """Cross-encoder reranking: score documents against one query."""
    eng = _load_engine(args)
    docs = args.document if args.document else [line.rstrip("\n")
                                                for line in sys.stdin]
    if not docs:
        print("no documents: pass positional DOC args or pipe one per "
              "line on stdin", file=sys.stderr)
        return 1
    t0 = time.time()
    scores = eng.rerank(args.query, docs)
    t_eval = time.time() - t0
    order = sorted(range(len(docs)), key=lambda i: -scores[i])
    if args.format == "json":
        json.dump({"results": [
            {"index": i, "relevance_score": float(scores[i]),
             "document": docs[i]} for i in order]}, sys.stdout)
        print()
    else:
        for i in order:
            print(f"{scores[i]:+.4f}\t{docs[i]}")
    print(f"eval: {t_eval*1e3:.0f} ms ({len(docs)} documents)",
          file=sys.stderr)
    return 0


def cmd_tokenize(args) -> int:
    eng = _load_engine(args)
    for text in args.prompt:
        ids = eng.tokenize(text)
        print(ids)
        print([eng.tokenizer.id_to_token(i) for i in ids])
    return 0


def cmd_serve(args) -> int:
    import asyncio
    from .runtime.server import serve_forever
    eng = _load_engine(args)
    eng.warmup(batch_sizes=(args.batch_size,), seq_lens=None)
    try:
        asyncio.run(serve_forever(
            eng, host=args.host, tcp_port=args.port,
            http_port=args.http_port, max_batch=args.batch_size,
            max_wait_ms=args.max_wait_ms,
            request_timeout_s=args.request_timeout, packed=args.packed))
    except KeyboardInterrupt:
        pass
    return 0


def cmd_convert(args) -> int:
    from .models import params as P
    from .ops.quant import PACK4_KINDS
    src = Path(args.hf_dir)
    src_tokens = None  # vocab as an ordered token list, wherever it came from
    if src.suffix in (".bin", ".gguf"):
        if src.suffix == ".bin":
            from .models.ggml_io import load_ggml_model as load_file_model
        else:
            from .models.gguf_io import load_gguf_model as load_file_model
        params, config, file_tok = load_file_model(src)
        v = file_tok.vocab.id_to_token
        src_tokens = [v[i] for i in range(len(v))]
    else:
        # an HF directory, or (beyond the JAX CLI) a native .npz with
        # its vocab.txt beside it
        if src.suffix == ".npz":
            params, config = P.load_native(src)
        else:
            params, config = P.load_hf_dir(src)
        vocab_file = (src.parent if src.suffix == ".npz" else src) \
            / "vocab.txt"
        if vocab_file.exists():
            src_tokens = vocab_file.read_text(encoding="utf-8").splitlines()
    if args.out.endswith(".bin"):
        # the reference's ggml .bin format (vocab embedded)
        from .models.ggml_io import NAME_TO_FTYPE, write_ggml
        if args.dtype not in NAME_TO_FTYPE:
            print(f"ggml .bin cannot represent dtype {args.dtype} "
                  f"(reference supports {sorted(NAME_TO_FTYPE)}, "
                  f"bert.cpp:499-521)", file=sys.stderr)
            return 1
        if src_tokens is None:
            print(f"no vocab found for {src} (need vocab.txt next to an HF "
                  f"checkpoint, or a .bin source)", file=sys.stderr)
            return 1
        write_ggml(args.out, params, config, src_tokens, dtype=args.dtype)
        print(f"wrote {args.out} "
              f"({os.path.getsize(args.out)/1e6:.2f} MB, ggml {args.dtype})")
        return 0
    if args.out.endswith(".gguf"):
        # GGUF v3 (the llama.cpp-era container)
        from .models.gguf_io import DTYPE_TO_GGML, write_gguf
        if args.dtype not in DTYPE_TO_GGML:
            print(f"gguf cannot represent dtype {args.dtype} "
                  f"(supported: {sorted(DTYPE_TO_GGML)})", file=sys.stderr)
            return 1
        if src_tokens is None:
            print(f"no vocab found for {src} (need vocab.txt next to an HF "
                  f"checkpoint, or a .bin/.gguf source)", file=sys.stderr)
            return 1
        write_gguf(args.out, params, config, src_tokens, dtype=args.dtype)
        print(f"wrote {args.out} "
              f"({os.path.getsize(args.out)/1e6:.2f} MB, gguf {args.dtype})")
        return 0
    if args.dtype.endswith("_K"):
        print(f"K-quant {args.dtype} is a GGUF block format; use a "
              f".gguf output path", file=sys.stderr)
        return 1
    if args.dtype != "f32":
        params = P.quantize_params(params, args.dtype,
                                   pack4=args.dtype in PACK4_KINDS)
    P.save_native(args.out, params, config)
    size = os.path.getsize(args.out) / 1e6
    print(f"wrote {args.out} ({size:.2f} MB, dtype={args.dtype})")
    # the vocab next to the checkpoint, so load_model finds the tokenizer
    # (a .bin / .gguf source embeds it)
    if src_tokens is not None:
        (Path(args.out).parent / "vocab.txt").write_text(
            "\n".join(src_tokens) + "\n", encoding="utf-8")
    elif src.is_dir():
        # BPE-family source (RoBERTa): carry the tokenizer files over
        import shutil
        for name in ("vocab.json", "merges.txt", "tokenizer.json",
                     "tokenizer_config.json"):
            f = src / name
            dst = Path(args.out).parent / name
            if f.exists() and f.resolve() != dst.resolve():
                shutil.copyfile(f, dst)
    return 0


def _quantized_leaves(tree):
    """Every QuantizedTensor of a parameter tree, depth first."""
    from .ops.quant import QuantizedTensor
    if isinstance(tree, QuantizedTensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _quantized_leaves(v)


def cmd_quantize(args) -> int:
    """Offline re-quantization of a native checkpoint (quantize.cpp:27-319
    equivalent; prints the nibble histogram like the reference)."""
    import numpy as np
    from .models import params as P
    from .ops.quant import PACK4_KINDS, codes_int8, nibble_histogram
    params, config = P.load_native(args.input)
    qp = P.quantize_params(params, args.dtype,
                           pack4=args.dtype in PACK4_KINDS)
    P.save_native(args.out, qp, config)
    if args.dtype in PACK4_KINDS:
        hist = np.zeros(16, np.int64)
        for leaf in _quantized_leaves(qp):
            hist += nibble_histogram(codes_int8(leaf))
        total = hist.sum()
        print("nibble histogram:", " ".join(f"{h/total:.3f}" for h in hist))
    print(f"wrote {args.out} "
          f"({os.path.getsize(args.out)/1e6:.2f} MB, dtype={args.dtype})")
    return 0


def cmd_bench(args) -> int:
    import contextlib

    import numpy as np
    import torch
    from .utils.benchmarking import device_time_us
    eng = _load_engine(args)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(
        0, eng.config.vocab_size, (args.batch, args.seq)).astype(np.int32)
    ).to(eng.device)
    mask = torch.ones((args.batch, args.seq), dtype=torch.int32,
                      device=eng.device)
    trace = (eng.profile(args.profile) if args.profile
             else contextlib.nullcontext())
    with trace:
        # the engine's own forward: the program encode / serve run
        # (compute dtype, mask value, kernels, mesh included)
        us = device_time_us(lambda i, m: eng._forward(i, m), (ids, mask),
                            lo=5, hi=20)
    if args.profile:
        print(f"profiler trace written to {args.profile} (Chrome trace: "
              f"Perfetto or TensorBoard)", file=sys.stderr)
    print(json.dumps({
        "metric": f"sentences/sec/chip {args.dtype} seq{args.seq} "
                  f"batch{args.batch}",
        "value": round(args.batch / (us * 1e-6), 1),
        "unit": "sentences/s",
    }))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="embeddings-tpu-torch",
        description="quantized embedding inference on the GPU (PyTorch/CUDA)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("encode", help="embed prompt(s), print vectors")
    _add_model_args(p)
    p.add_argument("-p", "--prompt", action="append", default=None)
    p.add_argument("--format", choices=["text", "json"], default="text")
    p.add_argument("--packed", action="store_true",
                   help="token-level packing (several sentences per row)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_encode)

    p = sub.add_parser("tokenize", help="print token ids for prompt(s)")
    _add_model_args(p)
    p.add_argument("-p", "--prompt", action="append", required=True)
    p.set_defaults(fn=cmd_tokenize)

    p = sub.add_parser(
        "rerank", help="cross-encoder: score documents against a query")
    _add_model_args(p)
    p.add_argument("-q", "--query", required=True)
    p.add_argument("document", nargs="*",
                   help="documents (or pipe one per line on stdin)")
    p.add_argument("--format", choices=["text", "json"], default="text")
    p.set_defaults(fn=cmd_rerank)

    p = sub.add_parser("serve", help="run the embedding server")
    _add_model_args(p)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080,
                   help="TCP (reference-protocol) port; -1 disables")
    p.add_argument("--http-port", type=int, default=8081,
                   help="HTTP JSON port; -1 disables")
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--request-timeout", type=float, default=None,
                   help="per-request timeout in seconds (default: none)")
    p.add_argument("--packed", action="store_true",
                   help="token-level packing for device batches")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("convert", help="HF dir / .npz / .bin / .gguf -> "
                       ".npz / .bin / .gguf")
    p.add_argument("hf_dir")
    p.add_argument("out")
    # K-quants are export-only (GGUF interop): K-quant files dequantize
    # on load
    p.add_argument("--dtype", default="f32",
                   choices=["f32", "bf16", "f16", "q4_0", "q4_1", "q8_0",
                            "nf4", "q4_K", "q5_K", "q6_K"])
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("quantize", help="requantize a native checkpoint")
    p.add_argument("input")
    p.add_argument("out")
    p.add_argument("--dtype", required=True,
                   choices=["q4_0", "q4_1", "q8_0", "nf4"])
    p.set_defaults(fn=cmd_quantize)

    p = sub.add_parser("bench", help="device throughput microbenchmark")
    _add_model_args(p)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace to DIR")
    p.set_defaults(fn=cmd_bench)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "serve" and args.port == -1:
        args.port = None
    if args.cmd == "serve" and args.http_port == -1:
        args.http_port = None
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
