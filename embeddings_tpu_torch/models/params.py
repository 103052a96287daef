"""Parameter trees of the PyTorch port: random init, the numpy handoff from
the JAX package, quantization, packing, q/k/v fusion, HF import and the
native ``.npz`` checkpoint — the port of ``embeddings_tpu/models/params.py``
for the post-LN BERT families: plain BERT (learned positions), RoBERTa
(position offset), DistilBERT, ALBERT (factorized embeddings, one shared
layer), MPNet (relative-position bias), jina-bert-v2 (ALiBi, GeGLU MLP),
nomic-bert (RoPE, SwiGLU) and RoFormer (interleaved RoPE); and for the
pre-norm ModernBERT and Qwen2 (RMSNorm, grouped-query attention).

The tree has the JAX package's layout, with torch tensors as leaves and
every linear stored [in, out] so the forward computes ``x @ w``. Layer
weights are stacked on a leading axis [num_layers, ...]:

  params = {
    "embeddings": {"word": [V,E]|QT, "position": [P,E], "token_type": [T,E],
                   "ln": {"scale": [E], "bias": [E]},
                   "proj": {"w": [Ee,E], "b": [E]}  (factorized only)},
    "layers": {
      "attn": {"q"/"k"/"v"/"o": {"w": [E,E]|QT, "b": [E]}  (or "qkv";
               k/v [E,Ekv] with grouped-query attention),
               "ln": {"scale", "bias"}},
      "mlp":  {"up": {"w": [E,F]|QT, "b": [F]}, "down": {"w": [F,E]|QT,
               "b": [E]}, "ln": {"scale", "bias"},
               "gate": {"w": [E,F]|QT, "b": [F]}  (gated MLPs only)},
    },
    "rel_bias": [num_buckets, H] f32       (MPNet only)
    "alibi_slopes": [H] f32                (ALiBi only; no "position")
    "final_ln": {"scale", "bias"}          (pre-norm models only)
    "st_dense": {"0": {"w", "b"}, ...}   (SentenceTransformers Dense, opt.)
  }

A mixture-of-experts model (nomic-embed-text-v2-moe: ``num_experts``,
an MoE FFN at every odd layer) splits the layers into two half-stacks of
NL/2, applied in pairs (``layer``: layer i is ``dense[i // 2]`` for even
i, ``moe[i // 2]`` for odd i):

  "layers": {"dense": {"attn": {...}, "mlp": {...}},     (as above)
             "moe": {"attn": {...},
                     "mlp": {"router": {"w": [D, Ex] f32},
                             "up": {"w": [Ex, D, I], "b": [Ex, I]},
                             "down": {"w": [Ex, I, D], "b": [Ex, D]},
                             "bias": [D]  (the shared output bias, opt.),
                             "ln": {"scale", "bias"}}}}

each leaf with the NL/2 axis first. The experts and the router are never
quantized, and the router stays f32 through every cast.

DeepSeek-V2 (``kv_lora_rank`` > 0: MLA; ``_translate_deepseek_v2``) keeps
the (dense, moe) halves with the ``first_k_dense_replace`` leading layers
in "dense" and every later one in "moe" (``layer(params, i,
first_dense)``), RMSNorm scales with zero biases, zero linear biases:

  "attn": {"ln", "q": [E, H*(dn+dr)], "kv_a": [E, r+dr],
           "latent": {"ln": [r]}, "kv_b": [r, H*(dn+dv)], "o": [H*dv, E]}
  "moe"/"mlp": {"router": {"w": [D, Ex] f32},
                "gate"/"up": {"w": [Ex, D, I]}, "down": {"w": [Ex, I, D]},
                "shared": {"gate", "up", "down"}  (one gated MLP), "ln"}

The routed experts have no biases; the shared expert is quantized like a
dense MLP.

Rotary models (nomic-bert, ModernBERT, Qwen2) have no "position" table.
In a pre-norm tree the layer norms are the pre-attention ("attn/ln") and
pre-MLP ("mlp/ln") norms; ModernBERT's layer-0 attention norm is an
identity and its slot holds ones and zeros. Qwen2 (``norm_type``
"rmsnorm") keeps RMSNorm scales in those slots with zero biases, has no
embedding norm, and keeps its K/V projections ``num_key_value_heads *
head_dim`` (Ekv) wide, so ``fuse_qkv`` leaves them apart.

ALBERT (``embedding_size`` set) keeps its embedding tables Ee =
``embedding_size`` wide and projects them to E with the dense ``proj``
leaf; with ``shared_layers`` the stacks hold one layer, which the forward
applies ``num_hidden_layers`` times. RoFormer's ``embeddings_project``
lands in the same ``proj`` slot.

``rel_bias`` and ``alibi_slopes`` stay f32 through every cast and are
never quantized; ``gate`` is quantized like ``up``; ``proj`` stays dense.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from ..config import BertConfig
from ..ops.quant import QuantizedTensor, pack_q4, quantize

Params = dict[str, Any]

DENSE_KINDS = ("f32", "f16", "bf16")
QUANT_KINDS = ("q4_0", "q4_1", "q8_0", "nf4")
_TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                 "f16": torch.float16}


def check_supported(config: BertConfig) -> None:
    """Raise for model families the port does not run. It runs the
    post-LN BERT encoder with learned positions, MPNet's relative-position
    bias, ALiBi or RoPE, a plain or gated MLP, ALBERT's factorized
    embeddings and shared layer, ModernBERT's pre-norm LayerNorm stack
    with its sliding window, and Qwen2's pre-norm decoder block (RMSNorm,
    grouped-query attention, causal or bidirectional), and the
    mixture-of-experts interleave of nomic-embed-text-v2-moe: an MoE FFN
    at every second layer of an even, unshared post-LN stack (the JAX
    package's layout rule); and DeepSeek-V2's pre-norm stack: MLA
    attention, leading dense layers, then an MoE FFN at every layer."""
    H = config.num_attention_heads
    kv = config.num_key_value_heads or H
    unsupported = {
        "position_embedding_type": config.position_embedding_type not in (
            "absolute", "alibi", "rotary"),
        "norm_style": config.norm_style not in ("post", "pre"),
        "norm_type": config.norm_type not in ("layernorm", "rmsnorm"),
        "num_key_value_heads": H % kv != 0,
        "num_experts": bool(config.num_experts) and (
            config.shared_layers or not (_nomic_moe(config)
                                         or _leading_dense_moe(config))),
        "kv_lora_rank": config.mla and (config.norm_style != "pre"
                                        or config.shared_layers),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"the PyTorch port runs post-LN BERT, RoBERTa, DistilBERT, "
            f"ALBERT, MPNet, jina-bert-v2, nomic-bert, RoFormer, ModernBERT "
            f"and Qwen2 models, nomic-bert mixture-of-experts models "
            f"with an MoE FFN at every second layer of an even, unshared "
            f"post-LN stack, and DeepSeek-V2 (MLA, leading dense layers "
            f"then MoE, pre-norm); this config sets {', '.join(bad)}")


def _nomic_moe(config: BertConfig) -> bool:
    """nomic-v2-moe's layout: an MoE FFN at every odd layer of an even
    post-LN stack."""
    return (config.moe_every_n_layers == 2 and config.norm_style == "post"
            and config.num_hidden_layers % 2 == 0
            and not config.first_k_dense_replace)


def _leading_dense_moe(config: BertConfig) -> bool:
    """DeepSeek-V2's layout: first_k_dense_replace dense layers, then an
    MoE FFN at every layer, in a pre-norm stack."""
    return (config.moe_every_n_layers == 1 and config.norm_style == "pre"
            and 0 < config.first_k_dense_replace < config.num_hidden_layers)


def map_tree(fn: Callable, tree):
    """Apply ``fn`` to every tensor leaf (QuantizedTensor parts included)."""
    if isinstance(tree, QuantizedTensor):
        return tree.map(fn)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def to_device(params: Params, device) -> Params:
    """The tree with every tensor moved to ``device`` (dtypes kept)."""
    return map_tree(lambda t: t.to(device), params)


def hold_gated_experts(params: Params, dtype) -> Params:
    """DeepSeek-V2's routed experts (a gated expert stack) in ``dtype``,
    leaf by leaf where they lie: the compute dtype on the card, so the
    expert products read them as held, where nomic's f32 experts are cast
    for each product (the same bf16 values either way). In place; returns
    params."""
    moe = params["layers"].get("moe", {}).get("mlp", {})
    if "gate" in moe:
        for name in ("gate", "up", "down"):
            moe[name]["w"] = moe[name]["w"].to(dtype)
    return params


def keep_int8_weights(params: Params) -> Params:
    """Requantize every matmul weight the int8 mode engages on once, and
    keep the result on the weight (``ops.qmatmul.keep_int8_weight``), so
    a forward launches no requantization. In place; returns params."""
    from ..ops.qmatmul import int8_engages, keep_int8_weight

    def visit(tree):
        if isinstance(tree, QuantizedTensor):
            if tree.block_axis == -2 and int8_engages(*tree.shape[-2:],
                                                      tree.packed):
                keep_int8_weight(tree)
        elif isinstance(tree, dict):
            for v in tree.values():
                visit(v)
    visit(params)
    return params


def layer(params: Params, i: int, first_dense: int = 0) -> Params:
    """Layer ``i`` of the stacked layer tree (views, no copies); in a
    mixture-of-experts tree ``dense[i // 2]`` for even i, ``moe[i // 2]``
    for odd i — the JAX package's (dense, moe) pair scan — or, with
    ``first_dense`` (DeepSeek-V2's first_k_dense_replace), ``dense[i]``
    for the leading layers and ``moe[i - first_dense]`` after them."""
    layers = params["layers"]
    if "dense" in layers:
        if first_dense:
            half, i = (("dense", i) if i < first_dense
                       else ("moe", i - first_dense))
        else:
            half, i = "moe" if i % 2 else "dense", i // 2
        layers = layers[half]
    return map_tree(lambda t: t[i], layers)


def _ln(scale, bias) -> Params:
    return {"scale": torch.as_tensor(np.asarray(scale, np.float32)),
            "bias": torch.as_tensor(np.asarray(bias, np.float32))}


def init_params(config: BertConfig, generator: np.random.Generator | int = 0,
                dtype=torch.float32) -> Params:
    """Random init (tests and benchmarks without a checkpoint): normal
    weights with std 0.02 from a numpy generator, zero biases, unit
    LayerNorms — the JAX package's init, with numpy randomness. Gated
    MLPs add a gate stack, MPNet a [num_buckets, H] relative-bias table;
    ALiBi models carry their slopes and no position table, rotary models
    no position table; pre-norm models add the final norm; grouped-query
    attention makes k/v Ekv wide; RMSNorm models have no embedding
    norm; a factorized config (ALBERT) has tables ``embedding_size`` wide
    and a ``proj`` to E, and shared layers store one layer; a
    mixture-of-experts config takes the (dense, moe) layout (a router and
    ``num_experts`` expert stacks at odd layers, zero expert biases, a
    zero shared output bias)."""
    check_supported(config)
    if config.mla:
        raise NotImplementedError(
            "init_params does not build MLA trees; map an HF state dict "
            "with from_hf_state_dict")
    rng = (np.random.default_rng(generator) if isinstance(generator, int)
           else generator)
    E, F = config.hidden_size, config.intermediate_size
    NL = 1 if config.shared_layers else config.num_hidden_layers
    Ee = config.embedding_size or E

    def mat(*shape):
        w = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        return torch.from_numpy(w).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype)

    def lin(k, n):
        return {"w": mat(NL, k, n), "b": zeros(NL, n)}

    def ln_stack():
        return {"scale": torch.ones(NL, E), "bias": torch.zeros(NL, E)}

    emb = {"word": mat(config.vocab_size, Ee)}
    if config.position_embedding_type == "absolute":
        emb["position"] = mat(config.max_position_embeddings, Ee)
    emb["token_type"] = mat(config.type_vocab_size, Ee)
    if config.norm_type != "rmsnorm":  # Qwen2: bare token embedding
        emb["ln"] = _ln(np.ones(Ee), np.zeros(Ee))
    if config.embedding_size is not None:
        emb["proj"] = {"w": mat(Ee, E), "b": zeros(E)}
    Ekv = ((config.num_key_value_heads or config.num_attention_heads)
           * config.head_dim)
    layers = {
        "attn": {"q": lin(E, E), "k": lin(E, Ekv), "v": lin(E, Ekv),
                 "o": lin(E, E), "ln": ln_stack()},
        "mlp": {"up": lin(E, F), "down": lin(F, E), "ln": ln_stack()},
    }
    if config.gated_mlp:
        layers["mlp"]["gate"] = lin(E, F)
    if config.num_experts:
        NLh, Ex = NL // 2, config.num_experts
        layers = {
            "dense": map_tree(lambda t: t[0::2].contiguous(), layers),
            "moe": {"attn": map_tree(lambda t: t[1::2].contiguous(),
                                     layers["attn"]),
                    "mlp": {"router": {"w": mat(NLh, E, Ex).float()},
                            "up": {"w": mat(NLh, Ex, E, F),
                                   "b": zeros(NLh, Ex, F)},
                            "down": {"w": mat(NLh, Ex, F, E),
                                     "b": zeros(NLh, Ex, E)},
                            "bias": zeros(NLh, E),
                            "ln": {"scale": torch.ones(NLh, E),
                                   "bias": torch.zeros(NLh, E)}}}}
    out: Params = {"embeddings": emb, "layers": layers}
    if config.relative_attention_num_buckets:
        out["rel_bias"] = mat(config.relative_attention_num_buckets,
                              config.num_attention_heads).float()
    if config.position_embedding_type == "alibi":
        out["alibi_slopes"] = _slopes(config)
    if config.norm_style == "pre":
        out["final_ln"] = _ln(np.ones(E), np.zeros(E))
    return out


def _slopes(config: BertConfig) -> torch.Tensor:
    """The ALiBi slopes leaf: derived from the head count (checkpoints
    do not store it), f32."""
    from ..ops.alibi import alibi_slopes
    return torch.tensor(alibi_slopes(config.num_attention_heads),
                        dtype=torch.float32)


# ---------------------------------------------------------------------------
# Handoff from the JAX package (numpy only: nothing of it is imported here)
# ---------------------------------------------------------------------------

def _tensor(a) -> torch.Tensor:
    """numpy-convertible array -> torch tensor (bf16 arrays, which numpy
    only knows through an extension dtype, arrive as torch bf16)."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def from_jax_params(tree, device="cpu") -> Params:
    """The JAX package's parameter tree -> the port's tree on ``device``.

    Leaves are arrays (anything ``np.asarray`` takes) or quantized weights:
    any object with ``.codes/.scales/.mins/.kind/.block_axis/.packed``
    (duck-typed, so no JAX type is imported)."""
    if all(hasattr(tree, a) for a in ("codes", "scales", "mins", "kind",
                                       "block_axis", "packed")):
        return QuantizedTensor(
            _tensor(tree.codes).to(device), _tensor(tree.scales).to(device),
            None if tree.mins is None else _tensor(tree.mins).to(device),
            str(tree.kind), int(tree.block_axis), bool(tree.packed))
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    return _tensor(tree).to(device)


# ---------------------------------------------------------------------------
# Quantization, packing and fusion over the tree
# ---------------------------------------------------------------------------

def pack_q4_params(params: Params) -> Params:
    """Pack every int8-coded q4 weight to the 4-bit group-64 layout
    (no-op for other leaves)."""
    if isinstance(params, QuantizedTensor):
        return pack_q4(params)
    if isinstance(params, dict):
        return {k: pack_q4_params(v) for k, v in params.items()}
    return params


def cast_params(params: Params, kind: str) -> Params:
    """Matmul weights and embedding tables (tensors of 2+ dims outside
    LayerNorms) to f32/bf16/f16; LayerNorms, biases, the relative-bias
    table and an MoE router stay f32."""
    from ..ops.quant import dequantize
    target = _TORCH_DTYPES[kind]

    def cast(path: str, x):
        if isinstance(x, QuantizedTensor):
            x = dequantize(x)
        if isinstance(x, dict):
            return {k: cast(f"{path}/{k}", v) for k, v in x.items()}
        parts = path.split("/")
        if x.ndim >= 2 and not {"ln", "rel_bias", "router"} & set(parts):
            return x.to(target)
        return x

    return cast("", params)


def quantize_params(params: Params, kind: str, *,
                    quantize_embeddings: bool = True,
                    pack4: bool = False) -> Params:
    """Quantize every layer matmul weight (and the word-embedding table,
    blocked along E); biases, LayerNorms and the position / token-type
    tables stay dense, and so do an MoE tree's router and experts (only
    its attention, its dense-half FFN and DeepSeek-V2's shared expert are
    quantized). Same selection and codes as the JAX package."""
    from ..ops.quant import dequantize
    if kind in DENSE_KINDS:
        return cast_params(params, kind)
    if kind not in QUANT_KINDS:
        raise ValueError(f"unknown dtype {kind!r}")

    def qt(x, block_axis=-2):
        if isinstance(x, QuantizedTensor):
            x = dequantize(x)  # re-quantization goes through dense f32
        return quantize(x.float().cpu().numpy(), kind,
                        block_axis=block_axis, pack4=pack4).map(
            lambda t: t.to(x.device))

    out = dict(params)
    emb = dict(params["embeddings"])
    if quantize_embeddings:
        emb["word"] = qt(emb["word"], block_axis=-1)
    out["embeddings"] = emb

    def quantize_linears(d):
        return {k: ({"w": qt(v["w"]), "b": v["b"]}
                    if isinstance(v, dict) and "w" in v else v)
                for k, v in d.items()}

    layers = params["layers"]
    if "dense" in layers:
        moe_mlp = layers["moe"]["mlp"]
        if "shared" in moe_mlp:  # DeepSeek-V2's shared expert: quantized
            moe_mlp = {**moe_mlp,
                       "shared": quantize_linears(moe_mlp["shared"])}
        out["layers"] = {
            "dense": {"attn": quantize_linears(layers["dense"]["attn"]),
                      "mlp": quantize_linears(layers["dense"]["mlp"])},
            "moe": {"attn": quantize_linears(layers["moe"]["attn"]),
                    "mlp": moe_mlp}}
        return out
    out["layers"] = {"attn": quantize_linears(layers["attn"]),
                     "mlp": quantize_linears(layers["mlp"])}
    return out


def fuse_qkv(params: Params) -> Params:
    """Merge the q/k/v projections into one [E, 3E] matmul whose output
    columns are [q | k | v] (each E wide, heads contiguous). A
    grouped-query tree (k/v narrower than q) is returned unchanged, as
    the JAX package does: the forward splits a fused projection in
    thirds. An MoE tree fuses each half-stack's attention apart."""
    if "dense" in params["layers"]:
        out = dict(params)
        out["layers"] = {
            h: {**params["layers"][h],
                "attn": fuse_qkv({"layers": params["layers"][h]}
                                 )["layers"]["attn"]}
            for h in ("dense", "moe")}
        return out
    attn = params["layers"]["attn"]
    if "qkv" in attn or "kv_a" in attn:  # fused already, or MLA
        return params
    q, k, v = attn["q"], attn["k"], attn["v"]
    if k["b"].shape[-1] != q["b"].shape[-1]:
        return params

    def cat(xs):
        if isinstance(xs[0], QuantizedTensor):
            if len({x.packed for x in xs}) != 1:
                raise ValueError("q/k/v weights differ in packing")
            return QuantizedTensor(
                torch.cat([x.codes for x in xs], -1),
                torch.cat([x.scales for x in xs], -1),
                (torch.cat([x.mins for x in xs], -1)
                 if xs[0].mins is not None else None),
                xs[0].kind, xs[0].block_axis, xs[0].packed)
        return torch.cat(xs, -1)

    new_attn = {n: x for n, x in attn.items() if n not in ("q", "k", "v")}
    new_attn["qkv"] = {"w": cat([q["w"], k["w"], v["w"]]),
                       "b": torch.cat([q["b"], k["b"], v["b"]], -1)}
    out = dict(params)
    out["layers"] = {"attn": new_attn, "mlp": params["layers"]["mlp"]}
    return out


# ---------------------------------------------------------------------------
# HF import
# ---------------------------------------------------------------------------

_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "I64": np.int64, "I32": np.int32, "I16": np.int16,
              "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path: str | Path) -> dict[str, np.ndarray]:
    """A ``.safetensors`` file -> {name: numpy array}: an 8-byte
    little-endian header length, a JSON header of name -> {dtype, shape,
    data_offsets}, then the raw little-endian data. BF16 tensors come
    back as float32 (numpy has no bf16)."""
    raw = Path(path).read_bytes()
    n = int.from_bytes(raw[:8], "little")
    header = json.loads(raw[8:8 + n])
    data = memoryview(raw)[8 + n:]
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        begin, end = meta["data_offsets"]
        buf = data[begin:end]
        if meta["dtype"] == "BF16":
            bits = np.frombuffer(buf, "<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        else:
            arr = np.frombuffer(buf, np.dtype(_ST_DTYPES[meta["dtype"]])
                                .newbyteorder("<"))
        out[name] = arr.reshape(meta["shape"]).copy()
    return out


def _read_sd(d: Path) -> dict[str, np.ndarray]:
    """One checkpoint dir -> numpy state dict (safetensors or
    pytorch_model.bin)."""
    st, pt = d / "model.safetensors", d / "pytorch_model.bin"
    if st.exists():
        return read_safetensors(st)
    if pt.exists():
        return {k: v.float().numpy()
                for k, v in torch.load(pt, map_location="cpu",
                                       weights_only=True).items()}
    raise FileNotFoundError(f"no checkpoint in {d}")


def _strip_prefix(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Drop the 'bert.' / 'roberta.' / '0.auto_model.' style prefixes HF
    checkpoints use (a classifier head outside the backbone prefix is
    carried across), then rewrite DistilBERT, ALBERT, MPNet, nomic-bert,
    jina-bert-v2, ModernBERT and Qwen2 names into BERT naming — the JAX
    package's ``_strip_prefix`` key for key."""
    # RoBERTa and RoFormer tensors use BERT's layer naming under their own
    # prefix; RoBERTa's position offset and one token-type row live in the
    # config, RoFormer's embedding projection is renamed by
    # from_hf_state_dict
    for prefix in ("bert.", "roberta.", "albert.", "mpnet.", "distilbert.",
                   "roformer.", "model.", "0.auto_model."):
        if any(k.startswith(prefix + "embeddings") for k in sd):
            # cross-encoder rerankers keep their scoring head outside the
            # backbone prefix
            sd = {**{k: v for k, v in sd.items()
                     if k.startswith("classifier.")},
                  **{k[len(prefix):]: v for k, v in sd.items()
                     if k.startswith(prefix)}}
            break
    return _translate_qwen2(_translate_modernbert(_translate_jina(
        _translate_nomic(_translate_mpnet(_translate_albert(
            _translate_distilbert(sd)))))))


# DistilBERT layer-tensor names -> BERT names (the same post-LN block,
# learned positions and erf GELU, without token-type embeddings or pooler)
_DISTIL_LAYER_MAP = {
    "attention.q_lin": "attention.self.query",
    "attention.k_lin": "attention.self.key",
    "attention.v_lin": "attention.self.value",
    "attention.out_lin": "attention.output.dense",
    "sa_layer_norm": "attention.output.LayerNorm",
    "ffn.lin1": "intermediate.dense",
    "ffn.lin2": "output.dense",
    "output_layer_norm": "output.LayerNorm",
}


def _translate_distilbert(sd: dict[str, np.ndarray]
                          ) -> dict[str, np.ndarray]:
    """Rewrite a DistilBERT state dict into BERT naming; no-op otherwise.
    DistilBERT has no token-type table: a zeros row keeps embed() shared."""
    if not any(k.startswith("transformer.layer.") for k in sd):
        return sd
    out: dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if k.startswith("transformer.layer."):
            _, _, i, rest = k.split(".", 3)
            stem, _, leaf = rest.rpartition(".")
            mapped = _DISTIL_LAYER_MAP.get(stem)
            if mapped is not None:
                out[f"encoder.layer.{i}.{mapped}.{leaf}"] = v
        else:
            out[k] = v  # embeddings.* names already match BERT's
    emb = out.get("embeddings.word_embeddings.weight")
    if emb is not None:
        out.setdefault("embeddings.token_type_embeddings.weight",
                       np.zeros((1, emb.shape[1]), np.float32))
    return out


# ALBERT layer-tensor names -> BERT names (the same post-LN block; the one
# shared layer lands at index 0 and the forward applies it
# num_hidden_layers times)
_ALBERT_LAYER_MAP = {
    "attention.query": "attention.self.query",
    "attention.key": "attention.self.key",
    "attention.value": "attention.self.value",
    "attention.dense": "attention.output.dense",
    "attention.LayerNorm": "attention.output.LayerNorm",
    "ffn": "intermediate.dense",
    "ffn_output": "output.dense",
    "full_layer_layer_norm": "output.LayerNorm",
}


def _translate_albert(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Rewrite an ALBERT state dict into BERT naming, the factorized
    embedding projection as embeddings.proj.*; no-op otherwise. Further
    layer groups or inner layers are dropped: ``BertConfig.from_hf_dict``
    refuses configs that have them."""
    pref = "encoder.albert_layer_groups.0.albert_layers.0."
    if not any(k.startswith(pref) for k in sd):
        return sd
    out: dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if k.startswith(pref):
            stem, _, leaf = k[len(pref):].rpartition(".")
            mapped = _ALBERT_LAYER_MAP.get(stem)
            if mapped is not None:
                out[f"encoder.layer.0.{mapped}.{leaf}"] = v
        elif k.startswith("encoder.albert_layer_groups"):
            continue
        elif k.startswith("encoder.embedding_hidden_mapping_in."):
            out["embeddings.proj." + k.rsplit(".", 1)[1]] = v
        else:
            out[k] = v  # embeddings.* names already match BERT's
    return out


# MPNet layer-tensor names -> BERT names (same post-LN block; the shared
# relative-attention-bias table is carried as the top-level "rel_bias")
_MPNET_LAYER_MAP = {
    "attention.attn.q": "attention.self.query",
    "attention.attn.k": "attention.self.key",
    "attention.attn.v": "attention.self.value",
    "attention.attn.o": "attention.output.dense",
    "attention.LayerNorm": "attention.output.LayerNorm",
    "intermediate.dense": "intermediate.dense",
    "output.dense": "output.dense",
    "output.LayerNorm": "output.LayerNorm",
}


def _translate_mpnet(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Rewrite an MPNet state dict into BERT naming (+ the relative
    position bias table as "rel_bias"); no-op otherwise."""
    if not any(".attention.attn.q." in k for k in sd):
        return sd
    out: dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if k.startswith("encoder.layer."):
            _, _, i, rest = k.split(".", 3)
            stem, _, leaf = rest.rpartition(".")
            mapped = _MPNET_LAYER_MAP.get(stem)
            if mapped is not None:
                out[f"encoder.layer.{i}.{mapped}.{leaf}"] = v
        elif k == "encoder.relative_attention_bias.weight":
            out["rel_bias"] = v  # [num_buckets, num_heads]
        else:
            out[k] = v  # embeddings.* names already match BERT's
    emb = out.get("embeddings.word_embeddings.weight")
    if emb is not None:
        # MPNet has no token-type table; a zeros row keeps embed() shared
        out.setdefault("embeddings.token_type_embeddings.weight",
                       np.zeros((1, emb.shape[1]), np.float32))
    return out


# nomic-bert-2048 layer-tensor names -> BERT names (same post-LN block;
# fc11/fc12 are the gated MLP's gate/up: nomic's forward is
# fc2(act(fc11(x)) * fc12(x)))
_NOMIC_LAYER_MAP = {
    "attn.out_proj": "attention.output.dense",
    "norm1": "attention.output.LayerNorm",
    "norm2": "output.LayerNorm",
    "mlp.fc11": "intermediate.gate",
    "mlp.fc12": "intermediate.dense",
    "mlp.fc1": "intermediate.dense",
    "mlp.fc2": "output.dense",
}


def _translate_nomic(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Rewrite a nomic-bert-2048 state dict into BERT naming; no-op
    otherwise. The fused [3E, in] Wqkv splits row-wise into query | key |
    value. The MoE variant's router (``encoder.layer.{i}.moe.router.*``)
    and its expert stacks and shared output bias (``...moe.w1`` / ``w2``
    / ``bias``, HF layout) are carried for ``_build_moe_layers``."""
    if not any(".attn.Wqkv." in k for k in sd):
        return sd
    out: dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if k.startswith("encoder.layers."):
            _, _, i, rest = k.split(".", 3)
            stem, _, leaf = rest.rpartition(".")
            if stem == "attn.Wqkv":
                E3 = v.shape[0]
                for j, name in enumerate(("query", "key", "value")):
                    out[f"encoder.layer.{i}.attention.self.{name}.{leaf}"] \
                        = v[j * E3 // 3:(j + 1) * E3 // 3]
                continue
            if stem == "mlp.router.layer":
                # nomic-v2-moe's NomicRouter.layer (no bias)
                out[f"encoder.layer.{i}.moe.router.{leaf}"] = v
                continue
            if stem in ("mlp.experts.mlp", "mlp.experts"):
                # NomicExpertMLP w1 / w2 [Ex*I, D] and NomicExperts' bias
                out[f"encoder.layer.{i}.moe.{leaf}"] = v
                continue
            mapped = _NOMIC_LAYER_MAP.get(stem)
            if mapped is not None:
                out[f"encoder.layer.{i}.{mapped}.{leaf}"] = v
        elif k.startswith("emb_ln."):
            out["embeddings.LayerNorm." + k.split(".", 1)[1]] = v
        else:
            out[k] = v  # embeddings.* names already match BERT's
    return out


def _translate_modernbert(sd: dict[str, np.ndarray]
                          ) -> dict[str, np.ndarray]:
    """Rewrite a ModernBERT state dict into BERT naming; no-op otherwise.

    ModernBERT is biasless throughout: zero biases are synthesized so the
    stacks stay uniform. Wqkv [3E, E] splits row-wise q | k | v; the GeGLU
    Wi [2I, E] splits into the activated half (rows 0..I, "gate") and the
    multiplier half (rows I.., "up"), HF's ``act(input) * gate`` order.
    Layer 0's attention norm is an identity: ones/zeros placeholders fill
    its slot (the forward skips it). The final norm lands as
    "final_ln"."""
    if not any(k.startswith("layers.") and ".attn.Wqkv." in k for k in sd):
        return sd
    out: dict[str, np.ndarray] = {}
    E = sd["embeddings.tok_embeddings.weight"].shape[1]
    norm_map = {"attn_norm": "attention.output.LayerNorm",
                "mlp_norm": "output.LayerNorm"}
    n_layers = 1 + max(int(k.split(".")[1]) for k in sd
                       if k.startswith("layers."))
    for k, v in sd.items():
        if k.startswith("layers."):
            _, i, rest = k.split(".", 2)
            stem, _, leaf = rest.rpartition(".")
            p = f"encoder.layer.{i}."
            if stem == "attn.Wqkv":
                for j, name in enumerate(("query", "key", "value")):
                    out[p + f"attention.self.{name}.{leaf}"] \
                        = v[j * v.shape[0] // 3:(j + 1) * v.shape[0] // 3]
            elif stem == "attn.Wo":
                out[p + f"attention.output.dense.{leaf}"] = v
            elif stem == "mlp.Wi":
                I = v.shape[0] // 2
                out[p + f"intermediate.gate.{leaf}"] = v[:I]
                out[p + f"intermediate.dense.{leaf}"] = v[I:]
            elif stem == "mlp.Wo":
                out[p + f"output.dense.{leaf}"] = v
            elif stem in norm_map:
                out[p + f"{norm_map[stem]}.{leaf}"] = v
        elif k == "embeddings.tok_embeddings.weight":
            out["embeddings.word_embeddings.weight"] = v
        elif k.startswith("embeddings.norm."):
            out["embeddings.LayerNorm." + k.rsplit(".", 1)[1]] = v
        elif k.startswith("final_norm."):
            out["final_ln." + k.rsplit(".", 1)[1]] = v
        else:
            out[k] = v
    _zero_fill(out)
    for i in range(n_layers):
        p = f"encoder.layer.{i}.attention.output.LayerNorm."
        out.setdefault(p + "weight", np.ones(E, np.float32))
        out.setdefault(p + "bias", np.zeros(E, np.float32))
    return out


# Qwen2 layer-tensor names -> BERT names; the two RMSNorms land in the
# pre-norm slots
_QWEN2_LAYER_MAP = {
    "self_attn.q_proj": "attention.self.query",
    "self_attn.k_proj": "attention.self.key",
    "self_attn.v_proj": "attention.self.value",
    "self_attn.o_proj": "attention.output.dense",
    "input_layernorm": "attention.output.LayerNorm",   # pre-attention
    "post_attention_layernorm": "output.LayerNorm",    # pre-MLP
    "mlp.gate_proj": "intermediate.gate",
    "mlp.up_proj": "intermediate.dense",
    "mlp.down_proj": "output.dense",
}


def _translate_qwen2(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Rewrite a Qwen2 state dict (``Qwen2Model``, or the ``model.``-
    prefixed ``Qwen2ForCausalLM`` dump) into BERT naming; no-op
    otherwise. K/V keep their grouped-query width; zero biases are
    synthesized where Qwen2 has none (o-proj, MLP, the norms), and a
    zeros token-type row; no position table, no embedding norm; the
    final RMSNorm lands as "final_ln". lm_head and rotary buffers are
    dropped."""
    if not any("self_attn.q_proj" in k for k in sd):
        return sd
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items()
              if k.startswith("model.")}
    out: dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if k.startswith("layers."):
            _, i, rest = k.split(".", 2)
            stem, _, leaf = rest.rpartition(".")
            mapped = _QWEN2_LAYER_MAP.get(stem)
            if mapped is not None:
                out[f"encoder.layer.{i}.{mapped}.{leaf}"] = v
        elif k == "embed_tokens.weight":
            out["embeddings.word_embeddings.weight"] = v
        elif k == "norm.weight":
            out["final_ln.weight"] = v
    return _zero_fill(out)


def _zero_fill(out: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Synthesize, in place, what a biasless checkpoint (ModernBERT,
    Qwen2) lacks so the stacks stay uniform: a zeros token-type row and a
    zero bias beside every linear and norm weight (HF weights are [out,
    in] and norms [out]: the bias length is shape[0])."""
    E = out["embeddings.word_embeddings.weight"].shape[1]
    out.setdefault("embeddings.token_type_embeddings.weight",
                   np.zeros((1, E), np.float32))
    for k in list(out):
        if k.endswith(".weight") and not k.endswith("_embeddings.weight"):
            out.setdefault(k[:-len("weight")] + "bias",
                           np.zeros(out[k].shape[0], np.float32))
    return out


def _translate_jina(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Rewrite a jina-bert-v2 state dict into BERT naming; no-op
    otherwise. The GLU MLP maps as gate/up/down: ``mlp.gated_layers``
    [2I, E] (no bias) splits row-wise into gate (first I rows) | up (last
    I rows); later jina revisions ship the halves pre-split as
    ``gated_layers_w`` / ``gated_layers_v``. ``mlp.wo`` is the down
    projection and ``mlp.layernorm`` the block's output LayerNorm."""
    if not any(".mlp.wo." in k for k in sd):
        return sd
    out: dict[str, np.ndarray] = {}
    leaf_map = {"wo": "output.dense", "layernorm": "output.LayerNorm",
                "gated_layers_w": "intermediate.gate",
                "gated_layers_v": "intermediate.dense",
                # non-GLU jina variants (feed_forward_type "original")
                "up_layer": "intermediate.dense",
                "down_layer": "output.dense"}
    for k, v in sd.items():
        if k.startswith("encoder.layer.") and ".mlp." in k:
            _, _, i, rest = k.split(".", 3)
            stem, _, leaf = rest.rpartition(".")
            name = stem.removeprefix("mlp.")
            if name == "gated_layers":
                half = v.shape[0] // 2
                out[f"encoder.layer.{i}.intermediate.gate.{leaf}"] = v[:half]
                out[f"encoder.layer.{i}.intermediate.dense.{leaf}"] = v[half:]
                continue
            mapped = leaf_map.get(name)
            if mapped is not None:
                out[f"encoder.layer.{i}.{mapped}.{leaf}"] = v
        else:
            out[k] = v  # embeddings.* / attention.* names match BERT's
    # gated_layers has no bias: zeros keep the linear stacks uniform (HF
    # Linear weights are [out, in], so the bias length is shape[0])
    for k in list(out):
        if k.endswith((".intermediate.gate.weight",
                       ".intermediate.dense.weight")):
            out.setdefault(k[:-len("weight")] + "bias",
                           np.zeros(out[k].shape[0], np.float32))
    return out


def _build_moe_layers(sd: dict[str, np.ndarray], config: BertConfig,
                      layers: Params, stack_ln, dtype) -> Params:
    """Split an HF-named layer stack into the (dense, moe) half-stacks of
    the nomic-v2-moe interleave (``init_params``' MoE layout). ``layers``
    holds the attention of every layer and the dense FFN of the even
    ones. Per odd layer i the state dict holds
    ``encoder.layer.{i}.moe.router.weight`` [Ex, D], ``...moe.w1`` /
    ``...moe.w2`` [Ex*I, D] (HF NomicExpertMLP: x @ w1_e.T, then h @
    w2_e) and optionally the shared ``...moe.bias`` [D]."""
    NL = config.num_hidden_layers
    moe_idx = list(range(1, NL, 2))
    NLh, Ex = len(moe_idx), config.num_experts

    def stack(name: str) -> np.ndarray:
        return np.stack([np.asarray(sd[f"encoder.layer.{i}.moe.{name}"],
                                    np.float32) for i in moe_idx])

    def t(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dt)

    w1, w2 = stack("w1"), stack("w2")                     # [NLh, Ex*I, D]
    D = w1.shape[-1]
    I = w1.shape[1] // Ex
    moe_mlp: Params = {
        "router": {"w": t(stack("router.weight").transpose(0, 2, 1),
                          torch.float32)},                 # [NLh, D, Ex]
        # the tree's [in, out]: up = w1_e.T, down = w2_e
        "up": {"w": t(w1.reshape(NLh, Ex, I, D).transpose(0, 1, 3, 2)),
               "b": torch.zeros(NLh, Ex, I, dtype=dtype)},
        "down": {"w": t(w2.reshape(NLh, Ex, I, D)),
                 "b": torch.zeros(NLh, Ex, D, dtype=dtype)},
        "ln": stack_ln("encoder.layer.{}.output.LayerNorm", moe_idx),
    }
    if f"encoder.layer.{moe_idx[0]}.moe.bias" in sd:
        moe_mlp["bias"] = t(stack("bias"))
    return {"dense": {"attn": map_tree(lambda a: a[0::2].contiguous(),
                                       layers["attn"]),
                      "mlp": layers["mlp"]},
            "moe": {"attn": map_tree(lambda a: a[1::2].contiguous(),
                                     layers["attn"]),
                    "mlp": moe_mlp}}


def _translate_deepseek_v2(sd: dict[str, np.ndarray], config: BertConfig,
                           dtype=torch.float32) -> Params:
    """A DeepSeek-V2 state dict (``DeepseekV2Model``, or the ``model.``-
    prefixed ``DeepseekV2ForCausalLM`` dump; lm_head dropped) as the
    port's tree, linears [in, out] with zero biases (the checkpoint has
    none), a zeros token-type row, no embedding norm:

      layers.{i}.input_layernorm          -> attn/ln (RMSNorm)
      self_attn.q_proj                    -> attn/q   [E, H*(dn+dr)]
      self_attn.kv_a_proj_with_mqa        -> attn/kv_a [E, r+dr]
      self_attn.kv_a_layernorm            -> attn/latent/ln [r]
      self_attn.kv_b_proj                 -> attn/kv_b [r, H*(dn+dv)]
      self_attn.o_proj                    -> attn/o   [H*dv, E]
      post_attention_layernorm            -> mlp/ln
      mlp.{gate,up,down}_proj             -> mlp/{gate,up,down} (dense)
      mlp.gate                            -> mlp/router [E, Ex] f32
      mlp.experts.{e}.{gate,up,down}_proj -> mlp/{gate,up,down}/w [Ex, ...]
      mlp.shared_experts.*                -> mlp/shared/{gate,up,down}
      norm                                -> final_ln

    in the (dense, moe) halves of ``layer``'s leading-dense layout. The
    routed experts are dense and have no biases (``ops.moe`` adds none);
    each layer's are written into one preallocated stack, so the host
    holds them once."""
    sd = {k.removeprefix("model."): v for k, v in sd.items()
          if not k.startswith("lm_head.")}
    NL, k = config.num_hidden_layers, config.first_k_dense_replace
    dense_idx = range(k) if config.num_experts else range(NL)
    moe_idx = range(k, NL) if config.num_experts else range(0)

    def t(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dt)

    def lin(fmt: str, idx) -> Params:
        w = t(np.stack([np.asarray(sd[fmt.format(i)]).T for i in idx]))
        return {"w": w, "b": torch.zeros(w.shape[0], w.shape[-1],
                                         dtype=dtype)}

    def norm(fmt: str, idx) -> Params:
        s = t(np.stack([sd[fmt.format(i)] for i in idx]), torch.float32)
        return {"scale": s, "bias": torch.zeros_like(s)}

    def attn(idx) -> Params:
        p = "layers.{}.self_attn."
        return {"ln": norm("layers.{}.input_layernorm.weight", idx),
                "q": lin(p + "q_proj.weight", idx),
                "kv_a": lin(p + "kv_a_proj_with_mqa.weight", idx),
                "latent": {"ln": norm(p + "kv_a_layernorm.weight", idx)},
                "kv_b": lin(p + "kv_b_proj.weight", idx),
                "o": lin(p + "o_proj.weight", idx)}

    def mlp(fmt: str, idx) -> Params:
        return {n: lin(fmt + n + "_proj.weight", idx)
                for n in ("gate", "up", "down")}

    dense = {"attn": attn(dense_idx),
             "mlp": {**mlp("layers.{}.mlp.", dense_idx),
                     "ln": norm("layers.{}.post_attention_layernorm.weight",
                                dense_idx)}}
    E = config.hidden_size
    out: Params = {
        "embeddings": {"word": t(sd["embed_tokens.weight"]),
                       "token_type": torch.zeros(1, E, dtype=dtype)},
        "final_ln": _ln(sd["norm.weight"], np.zeros(E, np.float32))}
    if not config.num_experts:
        out["layers"] = dense
        return out
    Ex, I, n = config.num_experts, config.expert_width, len(moe_idx)
    experts = {"gate": torch.empty(n, Ex, E, I, dtype=dtype),
               "up": torch.empty(n, Ex, E, I, dtype=dtype),
               "down": torch.empty(n, Ex, I, E, dtype=dtype)}
    for j, i in enumerate(moe_idx):
        for e in range(Ex):
            for name, stack in experts.items():
                w = sd[f"layers.{i}.mlp.experts.{e}.{name}_proj.weight"]
                stack[j, e].copy_(torch.from_numpy(np.asarray(w).T))
    moe_mlp: Params = {
        "router": {"w": t(np.stack([np.asarray(
            sd[f"layers.{i}.mlp.gate.weight"]).T for i in moe_idx]),
            torch.float32)},
        **{name: {"w": w} for name, w in experts.items()},
        "ln": norm("layers.{}.post_attention_layernorm.weight", moe_idx)}
    if config.n_shared_experts:
        moe_mlp["shared"] = mlp("layers.{}.mlp.shared_experts.", moe_idx)
    out["layers"] = {"dense": dense,
                     "moe": {"attn": attn(moe_idx), "mlp": moe_mlp}}
    return out


def from_hf_state_dict(sd: dict[str, np.ndarray], config: BertConfig,
                       dtype=torch.float32) -> Params:
    """Map a HF BERT, RoBERTa, DistilBERT, ALBERT, MPNet, jina-bert-v2,
    nomic-bert, RoFormer, ModernBERT or Qwen2 state dict to the port's
    tree (position_ids and the pooler are dropped, as the reference's
    converter does, unless a classifier head rides on the pooler: a
    reranker's head lands in ``cls_head``). ALBERT's shared layer is
    stored once; a mixture-of-experts model (nomic-v2-moe) takes the
    dense FFN tensors of its even layers only, then the (dense, moe)
    layout (``_build_moe_layers``)."""
    check_supported(config)
    if config.mla:
        return _translate_deepseek_v2(sd, config, dtype)
    sd = _strip_prefix({k: np.asarray(v) for k, v in sd.items()})
    NL = 1 if config.shared_layers else config.num_hidden_layers

    def t(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dt)

    def stack_lin(fmt: str, idx=None) -> Params:
        # HF Linear stores [out, in]; the tree stores [in, out]
        idx = range(NL) if idx is None else idx
        return {"w": t(np.stack([sd[fmt.format(i) + ".weight"].T
                                 for i in idx])),
                "b": t(np.stack([sd[fmt.format(i) + ".bias"]
                                 for i in idx]))}

    def stack_ln(fmt: str, idx=None) -> Params:
        idx = range(NL) if idx is None else idx
        return {"scale": t(np.stack([sd[fmt.format(i) + ".weight"]
                                     for i in idx]), torch.float32),
                "bias": t(np.stack([sd[fmt.format(i) + ".bias"]
                                    for i in idx]), torch.float32)}

    emb = {"word": t(sd["embeddings.word_embeddings.weight"])}
    if config.position_embedding_type == "absolute":
        emb["position"] = t(sd["embeddings.position_embeddings.weight"])
    emb["token_type"] = t(sd["embeddings.token_type_embeddings.weight"])
    if "embeddings.LayerNorm.weight" in sd:  # absent for Qwen2
        emb["ln"] = _ln(sd["embeddings.LayerNorm.weight"],
                        sd["embeddings.LayerNorm.bias"])
    if "embeddings_project.weight" in sd:
        # RoFormer's factorized-embedding projection name
        sd = {**sd, "embeddings.proj.weight": sd["embeddings_project.weight"],
              "embeddings.proj.bias": sd["embeddings_project.bias"]}
    if "embeddings.proj.weight" in sd:
        # the factorized-embedding projection [Ee -> E], dense
        emb["proj"] = {"w": t(sd["embeddings.proj.weight"].T),
                       "b": t(sd["embeddings.proj.bias"])}
    pre = "encoder.layer.{}."
    # the MoE interleave: dense FFN tensors at even layers only
    dense_idx = range(0, NL, 2) if config.num_experts else None
    layers = {
        "attn": {"q": stack_lin(pre + "attention.self.query"),
                 "k": stack_lin(pre + "attention.self.key"),
                 "v": stack_lin(pre + "attention.self.value"),
                 "o": stack_lin(pre + "attention.output.dense"),
                 "ln": stack_ln(pre + "attention.output.LayerNorm")},
        "mlp": {"up": stack_lin(pre + "intermediate.dense", dense_idx),
                "down": stack_lin(pre + "output.dense", dense_idx),
                "ln": stack_ln(pre + "output.LayerNorm", dense_idx)},
    }
    if "encoder.layer.0.intermediate.gate.weight" in sd:
        # gated MLP: down(act(gate(x)) * up(x))
        layers["mlp"]["gate"] = stack_lin(pre + "intermediate.gate",
                                          dense_idx)
    if config.num_experts:
        layers = _build_moe_layers(sd, config, layers, stack_ln, dtype)
    out: Params = {"embeddings": emb, "layers": layers}
    if "rel_bias" in sd:
        # MPNet's shared [buckets, heads] table: f32, added to f32 logits
        out["rel_bias"] = t(sd["rel_bias"], torch.float32)
    if config.position_embedding_type == "alibi":
        out["alibi_slopes"] = _slopes(config)
    if "final_ln.weight" in sd:  # ModernBERT's and Qwen2's final norm
        out["final_ln"] = _ln(sd["final_ln.weight"], sd["final_ln.bias"])
    if "classifier.weight" in sd or "classifier.out_proj.weight" in sd:
        # cross-encoder reranker head (models/bert.score_pairs): BERT style
        # = pooler (tanh) -> classifier [num_labels, E] (ms-marco
        # cross-encoders); RoBERTa style = classifier.dense (tanh) ->
        # classifier.out_proj (bge-reranker). The pooler is kept only
        # when a classifier rides on it: embedding checkpoints drop it.
        def lin(name: str) -> Params:
            return {"w": t(sd[name + ".weight"].T), "b": t(sd[name + ".bias"])}

        if "classifier.out_proj.weight" in sd:
            head = {"dense": lin("classifier.dense"),
                    "out": lin("classifier.out_proj")}
        else:
            head = ({"pooler": lin("pooler.dense")}
                    if "pooler.dense.weight" in sd else {})
            head["out"] = lin("classifier")
        out["cls_head"] = head
    return out


def _load_st_modules(model_dir: Path, params: Params,
                     config: BertConfig) -> tuple[Params, BertConfig]:
    """Attach SentenceTransformers Dense modules (modules.json) as
    params["st_dense"]; a pipeline without a Normalize module turns
    embedding normalization off."""
    mj = model_dir / "modules.json"
    if not mj.exists():
        return params, config
    dense, acts, has_norm = {}, [], False
    for m in json.loads(mj.read_text()):
        kind = m.get("type", "")
        if kind.endswith(".Transformer") or kind.endswith(".Pooling"):
            continue
        if kind.endswith(".Normalize"):
            has_norm = True
            continue
        if not kind.endswith(".Dense"):
            raise ValueError(
                f"unsupported sentence-transformers module type {kind!r} "
                f"in {mj} (supported: Transformer, Pooling, Dense, "
                f"Normalize)")
        d = model_dir / m["path"]
        cfg = json.loads((d / "config.json").read_text())
        sd = _read_sd(d)
        entry = {"w": torch.from_numpy(np.ascontiguousarray(
            np.asarray(sd["linear.weight"], np.float32).T))}
        if cfg.get("bias", True) and "linear.bias" in sd:
            entry["b"] = torch.from_numpy(
                np.asarray(sd["linear.bias"], np.float32).copy())
        act = cfg.get("activation_function", "")
        acts.append("tanh" if act.endswith("Tanh") else "none")
        dense[str(len(dense))] = entry
    if not dense:
        return params, config
    params = {**params, "st_dense": dense}
    config = dataclasses.replace(config, st_dense_acts=tuple(acts),
                                 normalize_embeddings=has_norm)
    return params, config


def load_hf_dir(model_dir: str | Path, dtype=torch.float32,
                config: BertConfig | None = None
                ) -> tuple[Params, BertConfig]:
    """Load an HF model directory (config.json + model.safetensors or
    pytorch_model.bin) with its SentenceTransformers Dense/Normalize
    modules, on the CPU."""
    model_dir = Path(model_dir)
    if config is None:
        config = BertConfig.from_json(model_dir / "config.json")
    params = from_hf_state_dict(_read_sd(model_dir), config, dtype)
    return _load_st_modules(model_dir, params, config)


def to_hf_state_dict(params: Params) -> dict[str, np.ndarray]:
    """Inverse of from_hf_state_dict for plain BERT trees: the port's tree
    -> HF-named f32 numpy arrays (linears transposed back to [out, in]).
    QuantizedTensors are dequantized. Used by the ggml .bin and GGUF
    writers."""
    from ..ops.quant import dequantize

    def dense(x) -> np.ndarray:
        if isinstance(x, QuantizedTensor):
            x = dequantize(x)
        return x.detach().float().cpu().numpy()

    emb = params["embeddings"]
    if "dense" in params["layers"]:
        raise ValueError(
            "mixture-of-experts params (nomic-embed-text-v2-moe: router "
            "and expert stacks) have no BERT-named state-dict form — the "
            "ggml/GGUF export formats cannot represent them")
    if "proj" in emb:
        raise ValueError(
            "ALBERT-family params (factorized embeddings / shared layers) "
            "have no BERT-named state-dict form — the ggml/GGUF export "
            "formats cannot represent them")
    if "rel_bias" in params:
        raise ValueError(
            "MPNet-family params (relative attention bias) have no "
            "BERT-named state-dict form — the ggml/GGUF export formats "
            "cannot represent them")
    if "alibi_slopes" in params:
        raise ValueError(
            "ALiBi-family params (jina-bert-v2) have no BERT-named "
            "state-dict form — the ggml/GGUF export formats cannot "
            "represent them")
    if "st_dense" in params:
        raise ValueError(
            "sentence-transformers Dense modules (post-pooling "
            "projections) have no BERT-named state-dict form — the "
            "ggml/GGUF export formats cannot represent them")
    if "position" not in emb or "gate" in params["layers"].get("mlp", {}):
        raise ValueError(
            "rotary / gated-MLP params (RoFormer, nomic-bert) have no "
            "BERT-named state-dict form — the ggml/GGUF export formats "
            "cannot represent them")
    sd: dict[str, np.ndarray] = {
        "embeddings.word_embeddings.weight": dense(emb["word"]),
        "embeddings.position_embeddings.weight": dense(emb["position"]),
        "embeddings.token_type_embeddings.weight": dense(emb["token_type"]),
        "embeddings.LayerNorm.weight": dense(emb["ln"]["scale"]),
        "embeddings.LayerNorm.bias": dense(emb["ln"]["bias"]),
    }
    layers = params["layers"]
    NL = len(dense(layers["attn"]["ln"]["scale"]))

    def put_lin(fmt: str, v: dict) -> None:
        w = dense(v["w"])   # [NL, in, out]
        b = dense(v["b"])
        for i in range(NL):
            sd[fmt.format(i) + ".weight"] = np.ascontiguousarray(w[i].T)
            sd[fmt.format(i) + ".bias"] = b[i]

    def put_ln(fmt: str, v: dict) -> None:
        s, b = dense(v["scale"]), dense(v["bias"])
        for i in range(NL):
            sd[fmt.format(i) + ".weight"] = s[i]
            sd[fmt.format(i) + ".bias"] = b[i]

    put_lin("encoder.layer.{}.attention.self.query", layers["attn"]["q"])
    put_lin("encoder.layer.{}.attention.self.key", layers["attn"]["k"])
    put_lin("encoder.layer.{}.attention.self.value", layers["attn"]["v"])
    put_lin("encoder.layer.{}.attention.output.dense", layers["attn"]["o"])
    put_ln("encoder.layer.{}.attention.output.LayerNorm", layers["attn"]["ln"])
    put_lin("encoder.layer.{}.intermediate.dense", layers["mlp"]["up"])
    put_lin("encoder.layer.{}.output.dense", layers["mlp"]["down"])
    put_ln("encoder.layer.{}.output.LayerNorm", layers["mlp"]["ln"])
    return sd


def unpack_q4_params(params: Params) -> Params:
    """Inverse of pack_q4_params: every packed q4 weight back to int8
    codes (on the device it was on)."""
    from ..ops.quant import codes_int8
    if isinstance(params, QuantizedTensor):
        if not params.packed:
            return params
        return QuantizedTensor(
            torch.from_numpy(codes_int8(params)).to(params.codes.device),
            params.scales, params.mins, params.kind, params.block_axis)
    if isinstance(params, dict):
        return {k: unpack_q4_params(v) for k, v in params.items()}
    return params


def param_bytes(params: Params) -> int:
    """Bytes the tree's tensors hold (a kept int8 requantization too)."""
    total = 0

    def visit(t: torch.Tensor) -> torch.Tensor:
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    map_tree(visit, params)
    return total


# ---------------------------------------------------------------------------
# Native checkpoint (.npz): the JAX package's format — flat dotted names,
# each QuantizedTensor expanded into .codes/.scales/.mins plus a
# .__quant__ record [kind, block_axis, packed], the config as JSON bytes.
# ---------------------------------------------------------------------------

def save_native(path: str | Path, params: Params, config: BertConfig) -> None:
    flat: dict[str, np.ndarray] = {}

    def arr(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def visit(prefix: str, node) -> None:
        if isinstance(node, QuantizedTensor):
            flat[prefix + ".__quant__"] = np.array(
                [node.kind, str(node.block_axis),
                 "1" if node.packed else "0"], dtype=object)
            flat[prefix + ".codes"] = arr(node.codes)
            flat[prefix + ".scales"] = arr(node.scales)
            if node.mins is not None:
                flat[prefix + ".mins"] = arr(node.mins)
        elif isinstance(node, dict):
            for k, v in node.items():
                visit(f"{prefix}.{k}" if prefix else k, v)
        else:
            flat[prefix] = arr(node)

    visit("", params)
    flat["__config__"] = np.frombuffer(
        json.dumps(config.to_dict()).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def load_native(path: str | Path) -> tuple[Params, BertConfig]:
    """A native ``.npz`` (from either package) -> (CPU tree, config)."""
    data = np.load(path, allow_pickle=True)
    config = BertConfig(**json.loads(bytes(data["__config__"]).decode()))
    tree: dict[str, Any] = {}
    quants: dict[str, dict] = {}
    for key in data.files:
        if key == "__config__":
            continue
        if key.endswith(".__quant__"):
            rec = list(data[key])
            q = quants.setdefault(key[: -len(".__quant__")], {})
            q["kind"], q["block_axis"] = str(rec[0]), int(rec[1])
            q["packed"] = len(rec) > 2 and str(rec[2]) == "1"
            continue
        for suffix in (".codes", ".scales", ".mins"):
            if key.endswith(suffix):
                quants.setdefault(key[: -len(suffix)], {})[suffix[1:]] = \
                    torch.from_numpy(data[key].copy())
                break
        else:
            _set_path(tree, key.split("."), torch.from_numpy(data[key].copy()))
    for base, q in quants.items():
        _set_path(tree, base.split("."), QuantizedTensor(
            q["codes"], q["scales"], q.get("mins"), q["kind"],
            q["block_axis"], q.get("packed", False)))
    return tree, config


def _set_path(tree: dict, path: list[str], value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value
