"""Reader/writer for the reference's ggml .bin model format — the PyTorch
port of ``embeddings_tpu/models/ggml_io.py``.

Layout (reader: the reference's bert.cpp:434-766; writer:
models/convert-to-ggml.py:68-108 and models/quantize.cpp:64-261):

  int32 magic 0x67676d6c ('ggml' LE)
  int32 x 7 hparams: n_vocab, n_max_tokens, n_embd, n_intermediate,
                     n_head, n_layer, ftype (0=f32 1=f16 2=q4_0 3=q4_1)
  vocab: n_vocab x { uint32 len, len bytes }           (bert.cpp:470-495)
  tensors until EOF:
    int32 n_dims, int32 name_len, int32 ftype
    int32 ne[n_dims]    -- REVERSED dims: ne[0] = innermost/contiguous
                           (convert-to-ggml.py:104)
    name bytes (HF state-dict name)
    raw data, unaligned (old pre-GGUF format, no padding)

ggml data layout: row-major with ne[0] contiguous — i.e. exactly a numpy
array of shape ne[::-1]. Quantized rows are streams of ggml block structs
(quant.pack_ggml_q4_0). The per-tensor dtype rule matches the reference:
f16/q4 applies only to 2-D '.weight' tensors (convert-to-ggml.py:93-98,
quantize.cpp:154-167); 1-D tensors stay f32.

The byte codecs are numpy, as in the JAX package; a quantized tensor read
from a file becomes a ``QuantizedTensor`` of CPU torch tensors (wrapping
the decoded numpy arrays with ``torch.from_numpy``), which the Engine
moves to its device and feeds to the dequant-matmul kernel as it is.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import BinaryIO

import numpy as np
import torch

from ..config import BertConfig
from ..ops import quant as Q

MAGIC = 0x67676D6C
FTYPE_F32, FTYPE_F16, FTYPE_Q4_0, FTYPE_Q4_1 = 0, 1, 2, 3
FTYPE_NAMES = {FTYPE_F32: "f32", FTYPE_F16: "f16",
               FTYPE_Q4_0: "q4_0", FTYPE_Q4_1: "q4_1"}
NAME_TO_FTYPE = {v: k for k, v in FTYPE_NAMES.items()}


# ---------------------------------------------------------------------------
# Write
# ---------------------------------------------------------------------------

def _write_tensor(f: BinaryIO, name: str, arr: np.ndarray, ftype: int) -> None:
    """arr is the ggml-logical array with shape ne[::-1] (numpy row-major)."""
    ne = arr.shape[::-1]
    name_b = name.encode("utf-8")
    f.write(struct.pack("<iii", len(ne), len(name_b), ftype))
    f.write(struct.pack(f"<{len(ne)}i", *ne))
    f.write(name_b)
    if ftype == FTYPE_F32:
        f.write(np.ascontiguousarray(arr, np.float32).tobytes())
    elif ftype == FTYPE_F16:
        f.write(np.ascontiguousarray(arr, np.float16).tobytes())
    elif ftype == FTYPE_Q4_0:
        # quantize along ne[0] (the contiguous axis) = numpy's last axis;
        # the quantizer blocks along axis -2 of [K, N], so feed arr.T
        q, d = Q.quantize_q4_0(np.asarray(arr, np.float32).T)
        f.write(Q.pack_ggml_q4_0(q, d))
    elif ftype == FTYPE_Q4_1:
        q, d, m = Q.quantize_q4_1(np.asarray(arr, np.float32).T)
        f.write(Q.pack_ggml_q4_1(q, d, m))
    else:
        raise ValueError(f"unsupported ftype {ftype}")


def write_ggml(path: str | Path, params: dict, config: BertConfig,
               vocab_tokens: list[str], dtype: str = "f32",
               n_max_tokens: int | None = None) -> None:
    """Write a parameter tree as a reference-format .bin.

    dtype selects the 2-D-'.weight' tensor storage (f32/f16/q4_0/q4_1),
    exactly like the reference pipeline's ftype."""
    from .params import to_hf_state_dict
    ftype = NAME_TO_FTYPE[dtype]
    sd = to_hf_state_dict(params)
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", MAGIC, len(vocab_tokens)))
        f.write(struct.pack("<iiiiii",
                            n_max_tokens or config.max_position_embeddings,
                            config.hidden_size, config.intermediate_size,
                            config.num_attention_heads,
                            config.num_hidden_layers, ftype))
        for tok in vocab_tokens:
            b = tok.encode("utf-8")
            f.write(struct.pack("<I", len(b)))
            f.write(b)
        for name, arr in sd.items():
            # dtype rule: non-f32 only for 2-D .weight tensors
            t_ftype = (ftype if arr.ndim == 2 and name.endswith(".weight")
                       else FTYPE_F32)
            _write_tensor(f, name, arr, t_ftype)


# ---------------------------------------------------------------------------
# Read
# ---------------------------------------------------------------------------

def _read_struct(f: BinaryIO, fmt: str):
    size = struct.calcsize(fmt)
    data = f.read(size)
    if len(data) != size:
        raise EOFError
    return struct.unpack(fmt, data)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def read_ggml(path: str | Path, *, dequant: bool = False):
    """Parse a reference .bin -> (state_dict, config, vocab_tokens).

    state_dict maps HF names to f32 numpy arrays (or QuantizedTensor for
    quantized 2-D weights when dequant=False). Orientation matches HF
    ([out, in] for linears), i.e. ready for params.from_hf_state_dict.
    """
    with open(path, "rb") as f:
        magic, n_vocab = _read_struct(f, "<ii")
        if magic != MAGIC:
            raise ValueError(f"bad magic {magic:#x} (want {MAGIC:#x})")
        (n_max_tokens, n_embd, n_intermediate, n_head, n_layer,
         ftype) = _read_struct(f, "<iiiiii")
        vocab_tokens = []
        for _ in range(n_vocab):
            (ln,) = _read_struct(f, "<I")
            vocab_tokens.append(f.read(ln).decode("utf-8", errors="replace"))

        sd: dict[str, object] = {}
        while True:
            try:
                n_dims, name_len, t_ftype = _read_struct(f, "<iii")
            except EOFError:
                break
            ne = _read_struct(f, f"<{n_dims}i")
            name = f.read(name_len).decode("utf-8")
            shape = ne[::-1]  # numpy shape
            nel = int(np.prod(shape))
            if t_ftype == FTYPE_F32:
                arr = np.frombuffer(f.read(nel * 4), np.float32).reshape(shape)
                sd[name] = arr.astype(np.float32)
            elif t_ftype == FTYPE_F16:
                arr = np.frombuffer(f.read(nel * 2), np.float16).reshape(shape)
                sd[name] = arr.astype(np.float32)
            elif t_ftype in (FTYPE_Q4_0, FTYPE_Q4_1):
                K = ne[0]  # contiguous (contraction for matmul weights)
                N = nel // K
                nb = K // Q.QK
                bs = (4 + 16) if t_ftype == FTYPE_Q4_0 else (8 + 16)
                buf = f.read(N * nb * bs)
                if t_ftype == FTYPE_Q4_0:
                    codes, scales = Q.unpack_ggml_q4_0(buf, K, N)  # [K,N]
                    qt = Q.QuantizedTensor(_t(codes), _t(scales), None,
                                           "q4_0", -2)
                else:
                    codes, scales, mins = Q.unpack_ggml_q4_1(buf, K, N)
                    qt = Q.QuantizedTensor(_t(codes), _t(scales), _t(mins),
                                           "q4_1", -2)
                if dequant:
                    # back to HF orientation [N, K] = shape
                    sd[name] = Q.dequantize(qt).numpy().T.reshape(shape)
                else:
                    sd[name] = qt  # note: [K, N] = transposed vs HF
            else:
                raise ValueError(f"unsupported tensor ftype {t_ftype} ({name})")

    # max_position_embeddings is the file's position table size (an
    # inflated value would let tokenize() emit inputs longer than the
    # table; the reference's 512 hardcode is a property of ITS models)
    config = BertConfig(vocab_size=n_vocab, hidden_size=n_embd,
                        num_hidden_layers=n_layer, num_attention_heads=n_head,
                        intermediate_size=n_intermediate,
                        max_position_embeddings=n_max_tokens)
    return sd, config, vocab_tokens


def build_params_from_sd(sd: dict, config: BertConfig) -> dict:
    """HF-named state dict (dense arrays and/or QuantizedTensors in ggml
    [K, N] orientation) -> parameter tree, keeping quantized leaves
    quantized. Shared by the legacy .bin and GGUF loaders."""
    from . import params as P
    dense_sd = {}
    quants: dict[str, Q.QuantizedTensor] = {}
    for name, v in sd.items():
        if isinstance(v, Q.QuantizedTensor):
            if config.num_experts:
                # the (dense, moe) layer tree is not modelled by the
                # quantized installer: load dense (load_model(dtype=...)
                # quantizes the attention and dense-half matmuls)
                dense_sd[name] = Q.dequantize(v).numpy().T
                continue
            quants[name] = v
            # placeholder so from_hf_state_dict sees a complete dict
            K, N = v.shape[-2], v.shape[-1]
            dense_sd[name] = np.zeros((N, K), np.float32)
        else:
            dense_sd[name] = v
    params = P.from_hf_state_dict(dense_sd, config)
    if quants:
        params = _install_quantized(params, quants, config)
    return params


def load_ggml_model(path: str | Path):
    """.bin -> (parameter tree, BertConfig, WordPieceTokenizer).

    Quantized files keep their quantized weights (fed straight to the
    dequant-matmul kernel); f32/f16 files load dense.
    """
    from ..tokenizer import WordPieceTokenizer, WordPieceVocab
    sd, config, vocab_tokens = read_ggml(path, dequant=False)
    params = build_params_from_sd(sd, config)
    tok = WordPieceTokenizer(WordPieceVocab.from_tokens(vocab_tokens))
    return params, config, tok


def _install_quantized(params: dict, quants: dict, config: BertConfig) -> dict:
    """Replace placeholder dense weights with the QuantizedTensors read
    from the file (stacking per-layer tensors like from_hf_state_dict)."""
    NL = config.num_hidden_layers

    def stack_qt(fmt: str):
        qs = [quants[fmt.format(i) + ".weight"] for i in range(NL)]
        return Q.QuantizedTensor(
            torch.stack([q.codes for q in qs]),
            torch.stack([q.scales for q in qs]),
            (torch.stack([q.mins for q in qs])
             if qs[0].mins is not None else None),
            qs[0].kind, -2)

    def maybe(name: str, node: dict, fmt: str) -> None:
        names = [fmt.format(i) + ".weight" for i in range(NL)]
        present = [n for n in names if n in quants]
        if not present:
            return
        kinds = {quants[n].kind for n in present}
        if len(present) == NL and len(kinds) == 1:
            node[name] = {"w": stack_qt(fmt), "b": node[name]["b"]}
            return
        # per-tensor mixed types are legal in the formats: the stacked
        # kernel layout needs one kind across layers, so fall back to
        # dense for this weight, filling the zero placeholders that
        # build_params_from_sd inserted
        w = node[name]["w"].clone()
        for i, n in enumerate(names):
            if n in quants:
                w[i] = Q.dequantize(quants[n])
        node[name] = {"w": w, "b": node[name]["b"]}

    emb_name = "embeddings.word_embeddings.weight"
    if emb_name in quants:
        # the file stores an [E, V]-oriented quant (blocks along E) = the
        # block_axis=-1 layout transposed; re-orient to [V, E]
        q = quants[emb_name]

        def swap(t):
            return t.transpose(-1, -2).contiguous()

        params["embeddings"]["word"] = Q.QuantizedTensor(
            swap(q.codes), swap(q.scales),
            None if q.mins is None else swap(q.mins), q.kind, -1)
    for nm in ("position", "token_type"):
        key = f"embeddings.{nm}_embeddings.weight"
        if key in quants:
            params["embeddings"][nm] = Q.dequantize(
                quants[key]).T.contiguous()

    attn, mlp = params["layers"]["attn"], params["layers"]["mlp"]
    maybe("q", attn, "encoder.layer.{}.attention.self.query")
    maybe("k", attn, "encoder.layer.{}.attention.self.key")
    maybe("v", attn, "encoder.layer.{}.attention.self.value")
    maybe("o", attn, "encoder.layer.{}.attention.output.dense")
    maybe("up", mlp, "encoder.layer.{}.intermediate.dense")
    maybe("down", mlp, "encoder.layer.{}.output.dense")
    if "gate" in mlp:  # gated-MLP arches (nomic / jina GGUFs)
        maybe("gate", mlp, "encoder.layer.{}.intermediate.gate")
    return params
