"""The Engine of the PyTorch port: tokenizer + parameters on one device +
the bucketed batch scheduler — the port of
``embeddings_tpu/runtime/engine.py`` (single device, bucketed path).

  reference                      engine
  ---------------------------   -------------------------------------
  bert_load_from_file           load_model(path_or_dir, dtype=...)
  bert_tokenize                 Engine.tokenize
  bert_forward / _batch         Engine.forward (padded ids+mask in)
  bert_encode / _batch          Engine.encode / Engine.encode_batch
  bert_n_embd                   Engine.n_embd
  bert_n_max_tokens             Engine.max_seq_len

The forward runs eagerly, one Python loop over the layers; on a CUDA device
every quantized matmul and the prefix-masked attention launch the port's
hand-written kernels. ``device=None`` means "cuda", and a missing CUDA
device raises: the engine never carries on on the CPU unless asked to.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..config import BertConfig, EngineConfig
from ..models import bert, params as P
from ..tokenizer import WordPieceTokenizer
from .batching import extend_buckets, pad_batch, plan_batches


def resolve_device(device=None) -> torch.device:
    """``None`` -> cuda. Raises when a CUDA device is asked for and there
    is none; the CPU runs only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the PyTorch port runs on the GPU; pass "
            "device='cpu' to run its plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class Engine:
    def __init__(self, params: dict, config: BertConfig,
                 tokenizer: WordPieceTokenizer,
                 engine_config: EngineConfig | None = None, *,
                 device=None):
        self.device = resolve_device(device)
        self.config = config
        self.tokenizer = tokenizer
        # private copy: a caller-shared EngineConfig must not drift
        self.engine_config = ec = dataclasses.replace(
            engine_config or EngineConfig())
        if ec.int8_compute:
            raise NotImplementedError(
                "int8_compute (kernel K3) is not ported yet; the engine "
                "does not fall back to bf16 silently")
        if ec.use_pallas not in ("auto", "always", "never"):
            raise ValueError(f"use_pallas must be auto|always|never, got "
                             f"{ec.use_pallas!r}")
        self._use_kernels = ec.use_pallas != "never"
        cd = ec.compute_dtype
        if cd is None:
            cd = "bfloat16" if self.device.type == "cuda" else "float32"
        self._compute_dtype = getattr(
            torch, {"bf16": "bfloat16", "f32": "float32"}.get(cd, cd))
        if (self.device.type == "cuda" and self._use_kernels
                and self._compute_dtype != torch.bfloat16):
            raise ValueError(
                "the CUDA kernels compute in bf16; use compute_dtype="
                "'bfloat16' or use_pallas='never' for the plain f32 path")
        P.check_supported(config)
        # single device: merge q/k/v into one matmul
        self.params = P.to_device(P.fuse_qkv(params), self.device)

    # -- introspection ------------------------------------------------------
    @property
    def n_embd(self) -> int:
        dense = self.params.get("st_dense")
        if dense:
            return int(dense[str(len(dense) - 1)]["w"].shape[-1])
        return self.config.hidden_size

    @property
    def max_seq_len(self) -> int:
        return min(self.engine_config.max_seq_len,
                   self.config.max_position_embeddings
                   - self.config.position_offset)

    # -- tokenize -----------------------------------------------------------
    def tokenize(self, text: str) -> list[int]:
        return self.tokenizer.encode(text, max_len=self.max_seq_len)

    # -- forward on pre-tokenized, padded arrays ----------------------------
    def _forward(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """Enqueue one padded batch; returns the pooled embeddings on the
        device (the caller reads them back)."""
        with torch.inference_mode():
            return bert.encode_tokens(
                self.params, self.config,
                torch.from_numpy(np.ascontiguousarray(ids)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(mask)).to(self.device),
                mask_value=self.engine_config.mask_value,
                compute_dtype=self._compute_dtype,
                use_kernels=self._use_kernels)

    def forward(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        return self._forward(ids, mask).cpu().numpy()

    # -- encode (the primary API) -------------------------------------------
    def encode(self, text: str | Sequence[str]) -> np.ndarray:
        """Encode one string -> [E], or a list -> [N, E]."""
        single = isinstance(text, str)
        texts = [text] if single else list(text)
        out = self.encode_batch(texts, batch_size=max(len(texts), 1))
        return out[0] if single else out

    def encode_batch(self, texts: Sequence[str],
                     batch_size: int | None = None) -> np.ndarray:
        """Tokenize, length-sort into bucketed chunks, run, scatter back
        (bert_encode_batch semantics, bert.cpp:1374-1444)."""
        return self.encode_toks([self.tokenize(t) for t in texts],
                                batch_size)

    def encode_toks(self, toks: list[list[int]],
                    batch_size: int | None = None) -> np.ndarray:
        """Bucketed encode of pre-tokenized inputs."""
        ec = self.engine_config
        batch_size = batch_size or ec.batch_size
        out = np.empty((len(toks), self.n_embd), np.float32)
        # a caller-supplied batch_size may exceed the configured buckets
        bb = extend_buckets(ec.batch_buckets, batch_size)
        plans = plan_batches([len(t) for t in toks], batch_size,
                             self._seq_buckets(), bb)

        def dispatch():
            for plan in plans:
                ids, mask = pad_batch([toks[i] for i in plan.indices],
                                      plan.batch, plan.seq,
                                      self.tokenizer.pad_id)
                yield plan, self._forward(ids, mask)

        def scatter(plan, emb):
            out[list(plan.indices)] = emb.cpu().numpy()[: len(plan.indices)]

        self._windowed_drain(dispatch(), scatter)
        return out

    def _windowed_drain(self, tasks, scatter) -> None:
        """Drive a (meta, device tensor) generator with a bounded window:
        the host pads and enqueues up to engine_config.inflight_batches
        batches ahead of the read-back, which is where it waits for the
        device, while holding O(window) output buffers."""
        window = max(1, self.engine_config.inflight_batches)
        pending: deque = deque()
        for meta, val in tasks:
            pending.append((meta, val))
            if len(pending) > window:
                scatter(*pending.popleft())
        while pending:
            scatter(*pending.popleft())

    # -- shape warmup -------------------------------------------------------
    def warmup(self, batch_sizes: Sequence[int] | None = None,
               seq_lens: Sequence[int] | None = None) -> int:
        """Run every (batch, seq) bucket once (builds the kernels and
        warms the allocator); returns the number of shapes run."""
        ec = self.engine_config
        n = 0
        for b in batch_sizes or ec.batch_buckets:
            for s in seq_lens or self._seq_buckets():
                ids = np.zeros((b, s), np.int32)
                mask = np.zeros((b, s), np.int32)
                mask[:, 0] = 1
                self.forward(ids, mask)
                n += 1
        return n

    def _seq_buckets(self) -> tuple[int, ...]:
        """Configured seq buckets clipped to max_seq_len, always covering
        it (tokenize() truncates at max_seq_len)."""
        bs = tuple(b for b in self.engine_config.seq_buckets
                   if b <= self.max_seq_len)
        if not bs or bs[-1] < self.max_seq_len:
            bs = bs + (self.max_seq_len,)
        return bs


def load_model(path: str | Path, *, dtype: str = "f32",
               engine_config: EngineConfig | None = None,
               tokenizer: WordPieceTokenizer | None = None,
               pooling: str | None = None,
               int8_compute: bool = False, device=None) -> Engine:
    """Load an HF model directory or a native ``.npz`` checkpoint into an
    Engine on ``device`` (None = cuda).

    dtype: f32 | bf16 | f16 | q4_0 | q4_1 | q8_0 | nf4 — quantize or cast
    on load; the q4 kinds are then packed to the 4-bit layout."""
    device = resolve_device(device)
    path = Path(path)
    if path.is_dir():
        params, config = P.load_hf_dir(path)
        if pooling is None:
            from ..config import detect_pooling
            detected = detect_pooling(path)
            if detected is not None:
                config = dataclasses.replace(config, pooling=detected)
        if tokenizer is None:
            from ..tokenizer import tokenizer_from_dir
            tokenizer = tokenizer_from_dir(path)
    elif path.suffix in (".bin", ".gguf"):
        raise NotImplementedError(
            f"{path.suffix} model files are not read by the PyTorch port "
            f"yet (HF directories and native .npz are)")
    else:
        params, config = P.load_native(path)
        if tokenizer is None:
            from ..tokenizer import tokenizer_from_dir
            try:
                tokenizer = tokenizer_from_dir(path.parent)
            except FileNotFoundError:
                raise FileNotFoundError(
                    f"no tokenizer: pass tokenizer= or put vocab.txt next "
                    f"to {path}") from None
    if pooling is not None:
        config = dataclasses.replace(config, pooling=pooling)
    from ..ops.quant import PACK4_KINDS, QuantizedTensor
    already_quant = isinstance(params["layers"]["mlp"]["up"]["w"],
                               QuantizedTensor)
    if dtype != "f32" and not already_quant:
        params = P.quantize_params(params, dtype)
    if dtype in PACK4_KINDS:
        # q4 weights truly 4-bit: two codes per byte
        params = P.pack_q4_params(params)
    config = dataclasses.replace(
        config, cls_token_id=tokenizer.cls_id, sep_token_id=tokenizer.sep_id,
        unk_token_id=tokenizer.unk_id, pad_token_id=tokenizer.pad_id)
    if engine_config is None:
        # honor the model's context length
        engine_config = EngineConfig(
            max_seq_len=config.max_position_embeddings
            - config.position_offset, int8_compute=int8_compute)
    elif int8_compute and not engine_config.int8_compute:
        engine_config = dataclasses.replace(engine_config, int8_compute=True)
    return Engine(params, config, tokenizer, engine_config, device=device)
