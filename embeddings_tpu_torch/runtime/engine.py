"""The Engine of the PyTorch port: tokenizer + parameters on one device +
the bucketed and the token-packed batch schedulers — the port of
``embeddings_tpu/runtime/engine.py``.

  reference                      engine
  ---------------------------   -------------------------------------
  bert_load_from_file           load_model(path_or_dir, dtype=...)
  bert_tokenize                 Engine.tokenize
  bert_forward / _batch         Engine.forward (padded ids+mask in)
  bert_encode / _batch          Engine.encode / Engine.encode_batch
  bert_n_embd                   Engine.n_embd
  bert_n_max_tokens             Engine.max_seq_len

``Engine.tokenize`` runs the native C++ tokenizer (``tokenizer.native``,
built at first use) where it can represent the tokenizer, else the
Python one; ``Engine.profile`` writes a ``torch.profiler`` trace, in
which each call's host phases show as the spans of ``utils.spans``
(``engine.call`` around plan, pad or pack, upload, ``model.forward``,
read-back and scatter; under a mesh the forward makes its shards' copies
itself, inside ``model.forward``).

The forward runs eagerly, one Python loop over the layers; on a CUDA device
every quantized matmul (K1, or K3 with ``EngineConfig.int8_compute``,
whose int8 weights the Engine requantizes once, when it is built) and
the attention (K2 on padded batches, K7 with MPNet's or short rows' ALiBi
bias, K6 on long rows and long ALiBi rows, K6w on ModernBERT's local
layers, K6c on causal Qwen2 rows, K4/K5 on packed rows) launch the port's
hand-written kernels. ``device=None`` means "cuda", and a missing
CUDA device raises: the engine never carries on on the CPU unless asked to.

With ``mesh=`` the Engine runs the JAX Engine's mesh branch: batch sizes
and buckets round to multiples of the data-axis size, the parameter tree
is not fused (but for a model axis of 1, where each shard runs the
single-device tree), and the device is the mesh's first of this process
(on a mesh that spans processes, every process calls with the same texts
and gets every embedding). A ("data", "seq") mesh
(``parallel.make_mesh_cp``) runs context parallelism: seq buckets that the
seq-axis size does not divide are dropped, the tree is kept as given, and
each forward is ``parallel.make_cp_forward``'s (K8a / K8b attention, K1
matmuls: no int8 mode); token packing falls back to bucketed encode. A
("data", "model") mesh (``parallel.make_mesh``) runs data and Megatron
tensor parallelism: the tree is cut into its shards once, here
(``parallel.shard_params``; with ``int8_compute`` each shard keeps K3's
weights of its own slices), each bucketed forward is
``parallel.make_sharded_forward``'s and each packed one
``make_sharded_packed_forward``'s; a weight that cannot shard raises at
the first forward, in the JAX package's words.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import os
from collections import deque
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..config import BertConfig, EngineConfig
from ..models import bert, params as P
from ..ops.attention import BQ
from ..tokenizer import ByteLevelBPETokenizer, UnigramTokenizer, \
    WordPieceTokenizer
from ..utils.spans import profiling, span
from .batching import extend_buckets, pad_batch, pick_bucket, plan_batches
from .packing import materialize, max_block_span, plan_packing


# the tokenizers an Engine takes (``tokenizer.tokenizer_from_dir`` picks
# one from a model directory)
Tokenizer = WordPieceTokenizer | ByteLevelBPETokenizer | UnigramTokenizer


def _bucket_window(w: int, row_len: int) -> int:
    """Quantize the packed attention window to a small fixed set, so a
    varied corpus runs a handful of window values per row_len instead of
    one per distinct span (1..row_len/128). Values past the block-skip
    threshold (row_len/128 - 2, ``models.bert.attention_route_name``) select
    the full segmented kernel and ignore the window, so they collapse to
    one sentinel. Rounding a span up only widens the window: always
    correct, occasionally a block of extra work."""
    if w <= 0:
        return 0
    nk = row_len // BQ  # key blocks of the kernel's size
    usable = [b for b in (3, 4, 6, 8, 12, 16, 24, 32) if w <= b <= nk - 2]
    if usable:
        return usable[0]
    # between the largest fitting bucket and the dispatch threshold:
    # widen to the threshold (still block-skip)
    return nk - 2 if w <= nk - 2 else nk


def _call_span(entry):
    """An Engine entry under the span ``engine.call``, the root of the
    call's phase spans."""
    @functools.wraps(entry)
    def call(*args, **kwargs):
        with span("engine.call"):
            return entry(*args, **kwargs)
    return call


def _forward_args(ids, real, packed: bool) -> dict | None:
    """``model.forward``'s args while a profiler runs (else None): the
    batch's rows and row length, whether it is packed, and its real
    tokens (the mask's ones, or the packed rows' segment slots), counted
    before the upload and only where ``real`` is on the host: a caller's
    device tensor is not read back."""
    if not profiling():
        return None
    args = {"rows": int(ids.shape[0]), "row_len": int(ids.shape[1]),
            "packed": packed}
    if not isinstance(real, torch.Tensor) or real.device.type == "cpu":
        args["tokens"] = int(((real >= 0) if packed else (real != 0)).sum())
    return args


def resolve_device(device=None) -> torch.device:
    """``None`` -> cuda: the process's own card where it has one, under
    torchrun (LOCAL_RANK set) cuda:LOCAL_RANK, else the card that
    ``parallel.mesh.initialize_distributed`` gave it
    (``parallel.mesh.process_card``). Raises when a CUDA device is asked
    for and there is none, or when its index is past the card count (a
    local rank never wraps around onto another process's card); the CPU
    runs only when the caller names it."""
    from ..parallel.mesh import process_card
    local_rank = os.environ.get("LOCAL_RANK")
    if device is None:
        own = int(local_rank) if local_rank is not None else process_card()
        dev = (torch.device("cuda") if own is None
               else torch.device("cuda", own))
    else:
        dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the PyTorch port runs on the GPU; pass "
            "device='cpu' to run its plain PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is not None \
            and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"{dev} does not exist: this process sees "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class Engine:
    def __init__(self, params: dict, config: BertConfig,
                 tokenizer: Tokenizer,
                 engine_config: EngineConfig | None = None, *,
                 device=None, mesh=None):
        if mesh is not None:
            # the device is the mesh's (this process's first shard's)
            first = mesh.home
            if device is not None and resolve_device(device) != first:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"first device {first}")
            device = first
        self.device = resolve_device(device)
        self.config = config
        self.tokenizer = tokenizer
        self.mesh = mesh
        # the native C++ tokenizer (built at first use), where it can
        # represent this one; the Python tokenizer stays the API surface
        # (id_to_token, vocab, encode_pair, ...)
        from ..tokenizer import native
        self._fast_tokenizer = native.wrap_fast(tokenizer)
        # private copy: the mesh branch adjusts batch fields, and a
        # caller-shared EngineConfig must not drift
        self.engine_config = ec = dataclasses.replace(
            engine_config or EngineConfig())
        if ec.use_pallas not in ("auto", "always", "never"):
            raise ValueError(f"use_pallas must be auto|always|never, got "
                             f"{ec.use_pallas!r}")
        self._use_kernels = ec.use_pallas != "never"
        self._int8 = bool(ec.int8_compute)
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
        if mesh is not None and config.mla:
            raise NotImplementedError("MLA models run on one device")
        self._dp = 1
        self._cp = False  # a context-parallel mesh
        if mesh is None:
            # single device: merge q/k/v into one matmul
            self.params = P.to_device(P.fuse_qkv(params), self.device)
            P.hold_gated_experts(self.params, self._compute_dtype)
            if self._int8 and self._use_kernels:
                # K3's int8 weights, requantized once here, not per call
                P.keep_int8_weights(self.params)
            return
        from ..parallel.context import SEQ_AXIS, make_cp_forward
        from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
        self._cp = SEQ_AXIS in mesh.shape
        # sharded batches must divide by the data-axis size
        self._dp = dp = mesh.shape.get(DATA_AXIS, 1)
        ec.batch_size = -(-ec.batch_size // dp) * dp
        ec.batch_buckets = tuple(b for b in ec.batch_buckets
                                 if b % dp == 0) or (dp,)
        kw = dict(compute_dtype=self._compute_dtype,
                  mask_value=ec.mask_value, use_kernels=self._use_kernels)
        if self._cp:
            sp = mesh.shape[SEQ_AXIS]
            ec.seq_buckets = tuple(b for b in ec.seq_buckets
                                   if b % sp == 0) or (sp,)
            # the tree as given (the JAX CP branch does not fuse q/k/v)
            self.params = self._mesh_params = P.to_device(params,
                                                          self.device)
            self._mesh_forward = make_cp_forward(config, mesh, **kw)
            return
        from ..parallel.sharding import (make_sharded_forward,
                                         make_sharded_packed_forward,
                                         shard_params)
        if mesh.shape.get(MODEL_AXIS, 1) == 1:
            # data parallelism alone: each shard runs the single-device
            # forward, q/k/v merged into one matmul
            params = P.fuse_qkv(params)
        # one tree per shard of this process, cut once here; ``params``
        # is its first shard's (the replicated leaves and its slices)
        sharded = shard_params(params, config, mesh)
        if self._int8 and self._use_kernels:
            for tree in sharded.distinct_trees():
                P.keep_int8_weights(tree)  # K3's weights of each slice
        self._mesh_params = sharded
        self.params = sharded.tree(*mesh.home_index)
        kw["int8"] = self._int8
        self._mesh_forward = make_sharded_forward(config, mesh, **kw)
        self._mesh_packed = make_sharded_packed_forward(config, mesh, **kw)

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
        tok = self._fast_tokenizer or self.tokenizer
        return tok.encode(text, max_len=self.max_seq_len)

    # -- forward on pre-tokenized, padded arrays ----------------------------
    def _dev(self, a) -> torch.Tensor:
        """A host array (or a tensor) on the engine's device."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _forward(self, ids, mask) -> torch.Tensor:
        """Enqueue one padded batch (numpy arrays or tensors); returns the
        pooled embeddings on the device (the caller reads them back)."""
        args = _forward_args(ids, mask, False)
        with torch.inference_mode():
            if self.mesh is not None:
                with span("model.forward", args):
                    return self._mesh_forward(self._mesh_params, ids, mask)
            with span("engine.upload"):
                ids, mask = self._dev(ids), self._dev(mask)
            with span("model.forward", args):
                return bert.encode_tokens(
                    self.params, self.config, ids, mask,
                    mask_value=self.engine_config.mask_value,
                    compute_dtype=self._compute_dtype,
                    use_kernels=self._use_kernels, int8=self._int8)

    @_call_span
    def forward(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        if self._dp > 1 and ids.shape[0] % self._dp:
            raise ValueError(
                f"batch size {ids.shape[0]} not divisible by the data-axis "
                f"size {self._dp}; pad the batch (encode_batch does this "
                f"automatically) or use a divisible batch")
        emb = self._forward(ids, mask)
        with span("engine.readback"):
            return emb.cpu().numpy()

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
        with span("engine.tokenize"):
            toks = [self.tokenize(t) for t in texts]
        return self.encode_toks(toks, batch_size)

    @_call_span
    def encode_toks(self, toks: list[list[int]],
                    batch_size: int | None = None) -> np.ndarray:
        """Bucketed encode of pre-tokenized inputs."""
        ec = self.engine_config
        batch_size = batch_size or ec.batch_size
        # under a mesh, device batches must divide by the data-axis size
        batch_size = -(-batch_size // self._dp) * self._dp
        out = np.empty((len(toks), self.n_embd), np.float32)
        # a caller-supplied batch_size may exceed the configured buckets
        bb = extend_buckets(ec.batch_buckets, batch_size)
        with span("engine.plan"):
            plans = plan_batches([len(t) for t in toks], batch_size,
                                 self._seq_buckets(), bb)

        def dispatch():
            for plan in plans:
                with span("engine.pad"):
                    ids, mask = pad_batch([toks[i] for i in plan.indices],
                                          plan.batch, plan.seq,
                                          self.tokenizer.pad_id)
                yield plan, self._forward(ids, mask)

        def scatter(plan, emb):
            with span("engine.readback"):
                emb = emb.cpu().numpy()
            with span("engine.scatter"):
                out[list(plan.indices)] = emb[: len(plan.indices)]

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

    # -- cross-encoder rerank -----------------------------------------------
    @_call_span
    def rerank(self, query: str, documents: Sequence[str],
               batch_size: int | None = None) -> np.ndarray:
        """Cross-encoder relevance scores [N] for (query, document)
        pairs (raw logits, the HF convention; apply a sigmoid for [0, 1]
        scores). Needs a checkpoint with a classification head
        (bge-reranker family, ms-marco cross-encoders); the loader
        attaches it as params["cls_head"]."""
        if "cls_head" not in self.params:
            raise ValueError(
                "this model has no classification head — load a "
                "cross-encoder/reranker checkpoint (e.g. bge-reranker, "
                "ms-marco cross-encoders) to use rerank()")
        if self.mesh is not None:
            raise NotImplementedError(
                "rerank() runs single-device (reranker backbones are "
                "small); build the Engine without a mesh")
        enc = getattr(self.tokenizer, "encode_pair", None)
        if enc is None:
            raise ValueError(
                f"{type(self.tokenizer).__name__} has no pair encoding")
        with span("engine.tokenize"):
            pairs = [enc(query, d, max_len=self.max_seq_len)
                     for d in documents]
        ec = self.engine_config
        batch_size = batch_size or ec.batch_size
        out = np.empty(len(pairs), np.float32)
        bb = extend_buckets(ec.batch_buckets, batch_size)
        with span("engine.plan"):
            plans = plan_batches([len(p[0]) for p in pairs], batch_size,
                                 self._seq_buckets(), bb)

        def dispatch():
            for plan in plans:
                with span("engine.pad"):
                    ids, mask = pad_batch(
                        [pairs[i][0] for i in plan.indices], plan.batch,
                        plan.seq, self.tokenizer.pad_id)
                    types = np.zeros_like(ids)
                    for r, i in enumerate(plan.indices):
                        t = pairs[i][1]
                        types[r, : len(t)] = t
                yield plan, self._forward_pairs(ids, types, mask)

        def scatter(plan, scores):
            with span("engine.readback"):
                scores = scores.cpu().numpy()
            with span("engine.scatter"):
                out[list(plan.indices)] = scores[: len(plan.indices)]

        self._windowed_drain(dispatch(), scatter)
        return out

    def _forward_pairs(self, ids: np.ndarray, types: np.ndarray,
                       mask: np.ndarray) -> torch.Tensor:
        """Enqueue one padded batch of pairs; returns the logits on the
        device."""
        args = _forward_args(ids, mask, False)
        dev = self._dev
        with torch.inference_mode():
            with span("engine.upload"):
                ids, mask, types = dev(ids), dev(mask), dev(types)
            with span("model.forward", args):
                return bert.score_pairs(
                    self.params, self.config, ids, mask, types,
                    mask_value=self.engine_config.mask_value,
                    compute_dtype=self._compute_dtype,
                    use_kernels=self._use_kernels, int8=self._int8)

    # -- token-packed encode ------------------------------------------------
    def encode_batch_packed(self, texts: Sequence[str],
                            row_len: int | None = None,
                            batch_rows: int | None = None) -> np.ndarray:
        """Token-packed encode: several sentences per device row
        (``runtime/packing.py``). Faster than bucketed padding when
        sentences are short against the row. Needs mean, cls or lasttoken
        pooling."""
        with span("engine.tokenize"):
            toks = [self.tokenize(t) for t in texts]
        return self.encode_toks_packed(toks, row_len, batch_rows)

    @_call_span
    def encode_toks_packed(self, toks: list[list[int]],
                           row_len: int | None = None,
                           batch_rows: int | None = None) -> np.ndarray:
        """Token-packed encode of pre-tokenized inputs. row_len stays fixed
        across calls (default 128, one stable shape family); sentences
        longer than row_len take the bucketed path (``encode_toks``).
        batch_rows defaults to the larger of batch_size and 32768/row_len
        rows (about 32K tokens a forward), rounded up to the data-axis
        size under a mesh. A CP mesh falls back to bucketed encode, as the
        JAX Engine does."""
        if self._cp:
            # context parallelism shards L itself — packed rows mix
            # segments across the seq shards; out of scope
            logging.getLogger("embeddings_tpu_torch.engine").warning(
                "token packing is not implemented for seq-parallel (CP) "
                "meshes; falling back to bucketed encode")
            return self.encode_toks(toks)
        if self.config.pooling not in ("mean", "cls", "lasttoken"):
            raise ValueError("packing supports mean/cls/lasttoken pooling")
        ec = self.engine_config
        row_len = row_len or min(128, self.max_seq_len)
        batch_rows = batch_rows or max(ec.batch_size, 32768 // row_len)
        # mesh: the rows split over "data", so row buckets must divide
        batch_rows = -(-batch_rows // self._dp) * self._dp
        out = np.empty((len(toks), self.n_embd), np.float32)
        with span("engine.plan"):
            lengths = np.fromiter(map(len, toks), np.int64, len(toks))
            fits = lengths <= row_len
            short = np.flatnonzero(fits)
            long_idx = np.flatnonzero(~fits)
            stoks = [toks[i] for i in short] if len(long_idx) else toks
            # a fixed segments-per-row cap keeps one stable shape family
            batches = plan_packing(lengths[short], row_len, batch_rows,
                                   max_segs=max(2, row_len // 8))
        if len(long_idx):
            out[long_idx] = self.encode_toks([toks[i] for i in long_idx])
        if not len(short):
            return out
        bb = extend_buckets(ec.batch_buckets, batch_rows)

        def dispatch():
            for b in batches:
                with span("engine.pack"):
                    b.batch = pick_bucket(b.n_rows, bb)  # pad row count
                    ids, seg, pos, pool, mapping = materialize(
                        b, stoks, self.tokenizer.pad_id, self.config.pooling)
                    # the block-skip window (host-side; only rows longer
                    # than one 128-block can skip), bucketed
                    w = max_block_span(seg) if row_len > 128 else 0
                    window = _bucket_window(w, row_len)
                yield mapping, self._forward_packed(ids, seg, pos, pool,
                                                    window)

        def scatter(mapping, pooled):
            with span("engine.readback"):
                pooled = pooled.cpu().numpy()
            with span("engine.scatter"):
                out[short[mapping[:, 2]]] = pooled[mapping[:, 0],
                                                   mapping[:, 1]]

        self._windowed_drain(dispatch(), scatter)
        return out

    def _forward_packed(self, ids, seg, pos, pool,
                        attn_window: int = 0) -> torch.Tensor:
        """Enqueue one packed batch; returns the pooled [B, S, E'] on the
        device."""
        args = _forward_args(ids, seg, True)
        dev = self._dev
        with torch.inference_mode():
            if self.mesh is not None:
                with span("model.forward", args):
                    return self._mesh_packed(self._mesh_params, ids, seg,
                                             pos, pool, attn_window)
            with span("engine.upload"):
                ids, seg, pos, pool = dev(ids), dev(seg), dev(pos), dev(pool)
            with span("model.forward", args):
                return bert.encode_packed(
                    self.params, self.config, ids, seg, pos, pool,
                    mask_value=self.engine_config.mask_value,
                    compute_dtype=self._compute_dtype,
                    attn_window=attn_window, use_kernels=self._use_kernels,
                    int8=self._int8)

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

    def warmup_packed(self, row_len: int | None = None,
                      batch_rows: int | None = None,
                      segs_per_row: Sequence[int] = (4, 8, 16)) -> int:
        """Run the token-packed shape family once (one dispatch per
        segs-per-row value at the serving row/batch shape, then the
        smaller row-count buckets partial serving batches land on), so a
        packed server builds its kernels and warms the allocator before
        the first request. Returns the number of dispatches run."""
        if self.config.pooling not in ("mean", "cls", "lasttoken"):
            return 0
        row_len = row_len or min(128, self.max_seq_len)
        batch_rows = batch_rows or max(self.engine_config.batch_size,
                                       32768 // row_len)
        tok = max(1, self.tokenizer.pad_id + 1)
        n = 0
        for spr in segs_per_row:
            sents = [[tok] * max(1, row_len // spr)] * (batch_rows * spr)
            self.encode_toks_packed(sents, row_len, batch_rows)
            n += 1
        for rb in extend_buckets(self.engine_config.batch_buckets,
                                 batch_rows):
            if rb >= batch_rows:
                break
            sents = [[tok] * max(1, row_len // 8)] * (rb * 8)
            self.encode_toks_packed(sents, row_len, rb)
            n += 1
        return n

    @contextlib.contextmanager
    def profile(self, out_dir):
        """Context manager: a ``torch.profiler`` trace of everything run
        inside (host ops with their input shapes, the Engine's spans with
        ``model.forward``'s args, and the device's kernels on a CUDA
        engine), written into ``out_dir`` as a Chrome trace
        (``<host>_<pid>.<ms>.pt.trace.json``, for Perfetto or TensorBoard)
        — the counterpart of the JAX Engine's xprof trace and of the
        reference's GGML_PERF per-op dumps."""
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        cuda = self.device.type == "cuda"
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        with profile(activities=acts, record_shapes=True,
                     on_trace_ready=tensorboard_trace_handler(
                         str(out_dir))) as prof:
            yield prof
            if cuda:
                torch.cuda.synchronize(self.device)

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
               tokenizer: Tokenizer | None = None,
               pooling: str | None = None,
               int8_compute: bool = False, device=None,
               mesh=None) -> Engine:
    """Load an HF model directory, a native ``.npz`` checkpoint, a
    reference-format ggml ``.bin`` or a GGUF file into an Engine on
    ``device`` (None = cuda), or on a ``mesh`` (``parallel.make_mesh``
    or ``parallel.make_mesh_cp``; the device is then the mesh's). Under
    a ("data", "model") mesh packed q4 weights stay packed where their
    shards hold whole group-64 packs (``parallel.adapt_packed_params``).

    dtype: f32 | bf16 | f16 | q4_0 | q4_1 | q8_0 | nf4 — quantize or cast
    on load; the q4 kinds are then packed to the 4-bit layout. A file
    that is already quantized keeps its weights (and their kind) and is
    only packed, when dtype is a q4 kind.
    int8_compute: run the quantized matmuls in the int8 tensor-core mode
    (K3) while keeping the model-aware EngineConfig defaults."""
    if mesh is None:
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
    elif path.suffix == ".bin":
        # reference-format ggml model file (vocab embedded)
        from ..models.ggml_io import load_ggml_model
        params, config, file_tok = load_ggml_model(path)
        tokenizer = tokenizer or file_tok
    elif path.suffix == ".gguf":
        # llama.cpp-era container (vocab embedded)
        from ..models.gguf_io import load_gguf_model
        params, config, file_tok = load_gguf_model(path)
        tokenizer = tokenizer or file_tok
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
    if (config.norm_type == "rmsnorm"
            and getattr(tokenizer, "special_style", None) == "cls_sep"):
        # decoder embedders (Qwen2) take bare tokens + eos, not a
        # <s> ... </s> wrap
        tokenizer.special_style = "eos_only"
    from ..ops.quant import PACK4_KINDS, QuantizedTensor
    layers = params["layers"]
    # an MoE tree's dense half says (its experts are never quantized)
    already_quant = isinstance(layers.get("dense", layers)["mlp"]["up"]["w"],
                               QuantizedTensor)
    if dtype != "f32" and not already_quant:
        params = P.quantize_params(params, dtype)
    if dtype in PACK4_KINDS:
        # q4 weights truly 4-bit: two codes per byte
        params = P.pack_q4_params(params)
        if mesh is not None:
            # under TP only the row-parallel weights whose shards would
            # split group-64 packs fall back to int8 codes
            from ..parallel.sharding import adapt_packed_params
            params = adapt_packed_params(params, mesh)
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
    return Engine(params, config, tokenizer, engine_config, device=device,
                  mesh=mesh)
