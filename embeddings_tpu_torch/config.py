"""Model and engine configuration (the PyTorch port's own copy of
``embeddings_tpu.config``; the two are kept field-for-field identical so
configs, native checkpoints and tests move between the packages).

The reference keeps hparams in a 7-int file header (its `bert.cpp:449-468`)
plus hardcoded constants scattered through the code (special token ids
`bert.cpp:304-306`, pad id `bert.cpp:916`, mask scale `bert.cpp:959`,
512-token cap `bert.cpp:789`). Here everything is an explicit dataclass field.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """Architecture hyperparameters for a BERT-family encoder.

    Mirrors the reference's ``bert_hparams`` (`bert.cpp:17-27`), extended with
    the fields HF `config.json` carries that the reference hardcodes.
    """

    vocab_size: int = 30522
    hidden_size: int = 384
    num_hidden_layers: int = 6
    num_attention_heads: int = 12
    intermediate_size: int = 1536
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    # "gelu" (erf, HF default), "gelu_tanh" (ggml's), or "silu"
    # (gated-MLP models — see gated_mlp)
    hidden_act: str = "gelu"
    # RoBERTa-family position-embedding offset: position row for token i
    # is i + position_offset (HF reserves rows 0..pad_token_id for the
    # padding_idx convention; RoBERTa uses pad_token_id+1 = 2). 0 = BERT.
    position_offset: int = 0
    # ALBERT-family: factorized embeddings (tables at embedding_size,
    # projected to hidden_size before the encoder; None = hidden_size)
    # and cross-layer parameter sharing (one stored layer applied
    # num_hidden_layers times).
    embedding_size: int | None = None
    shared_layers: bool = False
    # MPNet-family: T5-style bucketed relative position bias added to the
    # attention logits, one [num_buckets, heads] table shared across
    # layers. 0 = no relative attention (BERT).
    relative_attention_num_buckets: int = 0
    relative_attention_max_distance: int = 128
    # Rotary family (RoFormer, nomic-bert-2048): "rotary" drops the
    # learned position table and rotates each head's q/k pairwise by
    # position-dependent angles (ops/rotary.py). rotary_interleaved
    # picks the pairing convention: True = (x0,x1)(x2,x3)... (RoFormer /
    # GPT-J), False = (x0,x_{D/2})... (GPT-NeoX / flash-attn / nomic).
    # "alibi" (jina-bert-v2): no position table; a symmetric per-head
    # -slope*|i-j| penalty on the attention logits (ops/alibi.py).
    position_embedding_type: str = "absolute"  # "absolute"|"rotary"|"alibi"
    rotary_base: float = 10000.0
    rotary_interleaved: bool = False
    # Gated MLP (nomic-bert "swiglu"/"geglu"): down(act(gate(x)) * up(x))
    # instead of down(act(up(x))); hidden_act supplies act.
    gated_mlp: bool = False
    # ModernBERT family: pre-norm blocks (x += attn(ln(x)); x += mlp(ln(x))
    # with the FIRST layer's attention norm an identity — the embedding
    # LayerNorm directly precedes it — and one final norm after the
    # stack). "post" = classic BERT post-LN (everything else).
    norm_style: str = "post"  # "post" | "pre"
    # Decoder-based embedders (Qwen2 family: gte-Qwen2, e5-style):
    # RMSNorm instead of LayerNorm, grouped-query attention (fewer K/V
    # heads than Q heads), optionally causal attention, and last-token
    # pooling. first_attn_norm_identity is the ModernBERT layer-0 quirk.
    norm_type: str = "layernorm"  # "layernorm" | "rmsnorm"
    num_key_value_heads: int | None = None  # None = num_attention_heads
    causal: bool = False
    first_attn_norm_identity: bool = False
    # Mixture-of-experts FFN (nomic-embed-text-v2-moe / the
    # nomic-bert-moe GGUF arch): every moe_every_n_layers-th layer
    # (i % n == n-1, the HF NomicBertBlock placement for n=2) replaces
    # its FFN with num_experts experts routed top-moe_top_k
    # (softmax-before-top-k, unnormalized unless moe_normalize_topk —
    # ops/moe.py). 0 experts = dense model.
    num_experts: int = 0
    moe_top_k: int = 2
    moe_every_n_layers: int = 0
    moe_normalize_topk: bool = False
    # "dense" = every expert on every token, router weights mask the
    # combine (static shapes, no gather); "ragged" = grouped matmuls
    # over sorted (token, expert) pairs via lax.ragged_dot (k/E of the
    # dense FLOPs); "auto" = ragged on a single device, dense under EP
    moe_dispatch: str = "auto"
    # ModernBERT alternating attention: layer i attends globally iff
    # i % global_attn_every_n_layers == 0, otherwise only within
    # |i-j| <= local_attention_window//2; local layers use
    # local_rotary_base for their RoPE tables. 1/0/None = all-global.
    global_attn_every_n_layers: int = 1
    local_attention_window: int = 0
    local_rotary_base: float | None = None
    # DeepSeek-V2 (the port's own fields; ``to_dict`` leaves them out at
    # their defaults, so every other config keeps the JAX package's keys).
    # MoE layout: the first first_k_dense_replace layers keep a dense FFN,
    # every later one is MoE (moe_every_n_layers 1); experts
    # moe_intermediate_size wide (0 = intermediate_size), gated like the
    # dense MLP, n_shared_experts of them fused into one shared SwiGLU
    # added for every token, routed weights times routed_scaling_factor.
    first_k_dense_replace: int = 0
    moe_intermediate_size: int = 0
    n_shared_experts: int = 0
    routed_scaling_factor: float = 1.0
    # Multi-head latent attention (MLA) where kv_lora_rank > 0: q per head
    # [nope | rope] (qk_nope_head_dim + qk_rope_head_dim), k and v from a
    # kv_lora_rank-wide RMS-normed latent, one rotated key part shared by
    # every head, v_head_dim-wide values; rope_scaling holds HF's YaRN
    # dict as sorted (key, value) pairs (hashable), () = plain RoPE.
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    rope_scaling: tuple = ()

    # Sentence-embedding head (SentenceTransformers semantics).
    # "lasttoken" = the last non-pad position (decoder-based embedders).
    pooling: str = "mean"  # "mean" | "cls" | "max" | "lasttoken"
    normalize_embeddings: bool = True
    # SentenceTransformers Dense modules (modules.json entries of type
    # models.Dense — distiluse, LaBSE): post-pooling projections applied
    # in order, params["st_dense"]["0".."n"]; one activation name per
    # module ("tanh" | "none"). () = no Dense stack.
    st_dense_acts: tuple = ()

    # Special token ids. The reference hardcodes 101/102/100/0
    # (`bert.cpp:304-306`); we read them from tokenizer config when available.
    cls_token_id: int = 101
    sep_token_id: int = 102
    unk_token_id: int = 100
    pad_token_id: int = 0

    def __post_init__(self) -> None:
        # JSON round-trips (save_native / GGUF metadata) deserialize the
        # Dense-activation stack as a list; keep it a tuple so configs
        # compare equal and stay hashable for jit static args. A bare
        # string would silently explode into per-character entries.
        if isinstance(self.st_dense_acts, str):
            raise TypeError(
                "st_dense_acts must be a sequence of activation names "
                f"(one per Dense module), got string {self.st_dense_acts!r}"
                " — wrap it in a tuple/list")
        object.__setattr__(self, "st_dense_acts", tuple(self.st_dense_acts))
        # HF's rope_scaling dict, or its JSON round trip (a list of pairs)
        rs = self.rope_scaling
        items = rs.items() if isinstance(rs, dict) else (rs or ())
        object.__setattr__(self, "rope_scaling",
                           tuple(sorted((str(k), v) for k, v in items)))

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def mla(self) -> bool:
        """Multi-head latent attention (DeepSeek-V2)."""
        return self.kv_lora_rank > 0

    @property
    def qk_head_dim(self) -> int:
        """A query or key head's width: MLA's nope + rope parts, else
        head_dim."""
        if self.mla:
            return self.qk_nope_head_dim + self.qk_rope_head_dim
        return self.head_dim

    @property
    def expert_width(self) -> int:
        """A routed expert's hidden width."""
        return self.moe_intermediate_size or self.intermediate_size

    @classmethod
    def from_hf_dict(cls, d: dict[str, Any], **overrides: Any) -> "BertConfig":
        """Build from a HuggingFace ``config.json`` dict (BERT or
        DistilBERT key names — DistilBERT's encoder math is identical,
        it only renames hparams and drops token-type embeddings)."""
        if d.get("model_type") in ("roberta", "xlm-roberta", "camembert"):
            # RoBERTa family: same encoder math as BERT; differences are
            # all in the embedding/tokenizer contract — byte-level BPE
            # (or Unigram for XLM-R) with <s>/</s>/<pad> = 0/2/1, one
            # token-type row, and position rows offset by padding_idx+1
            # (max_position_embeddings is 514 for a 512-token model)
            pad = int(d.get("pad_token_id", 1))
            d = {**d, "pad_token_id": pad}
            overrides.setdefault("position_offset", pad + 1)
            overrides.setdefault("cls_token_id", int(d.get("bos_token_id", 0)))
            overrides.setdefault("sep_token_id", int(d.get("eos_token_id", 2)))
            overrides.setdefault("unk_token_id", 3)
        if d.get("model_type") == "mpnet":
            # MPNet: BERT's encoder block + T5-style relative position
            # bias shared across layers; RoBERTa's embedding contract
            # (padding_idx position offset, <s>/</s>/<pad> = 0/2/1, no
            # token-type table — a zeros row is synthesized)
            pad = int(d.get("pad_token_id", 1))
            d = {**d, "pad_token_id": pad, "type_vocab_size": 1}
            overrides.setdefault("position_offset", pad + 1)
            overrides.setdefault("cls_token_id", int(d.get("bos_token_id", 0)))
            overrides.setdefault("sep_token_id", int(d.get("eos_token_id", 2)))
            overrides.setdefault("unk_token_id", 3)
            overrides.setdefault(
                "relative_attention_num_buckets",
                int(d.get("relative_attention_num_buckets", 32)))
        if d.get("model_type") == "albert":
            # ALBERT: BERT's encoder math with factorized embeddings and
            # one shared layer applied num_hidden_layers times. All
            # published ALBERTs use one layer group with one inner layer;
            # other configurations interleave groups we don't model.
            if (d.get("num_hidden_groups", 1) != 1
                    or d.get("inner_group_num", 1) != 1):
                raise ValueError(
                    "only num_hidden_groups=1 / inner_group_num=1 ALBERT "
                    "models are supported")
            overrides.setdefault("embedding_size",
                                 int(d.get("embedding_size", 128)))
            overrides.setdefault("shared_layers", True)
            d = {**d, "hidden_act": d.get("hidden_act", "gelu_new")}
        if d.get("model_type") == "roformer":
            # RoFormer: BERT's block with rotary q/k (interleaved
            # pairing) instead of a learned position table; optional
            # factorized embeddings (embedding_size != hidden_size).
            if d.get("rotary_value"):
                raise ValueError("rotary_value=True RoFormer models "
                                 "(rotary applied to V) are not supported")
            overrides.setdefault("position_embedding_type", "rotary")
            overrides.setdefault("rotary_interleaved", True)
            es = d.get("embedding_size")
            if es is not None and es != d["hidden_size"]:
                overrides.setdefault("embedding_size", int(es))
        if d.get("model_type") == "nomic_bert":
            # nomic-bert-2048 (nomic-embed-text-v1/v1.5): BERT block with
            # half-split rotary q/k and a SwiGLU gated MLP; GPT2-style
            # hparam names. Post-norm only (prenorm unsupported), full
            # rotary fraction only.
            if d.get("prenorm"):
                raise ValueError("prenorm nomic-bert models are not "
                                 "supported (post-LN only)")
            if float(d.get("rotary_emb_fraction", 1.0)) != 1.0:
                raise ValueError("partial rotary_emb_fraction is not "
                                 "supported")
            act = d.get("activation_function", "swiglu")
            gated = act in ("swiglu", "geglu")
            if int(d.get("num_experts") or 0) > 0:
                # nomic-embed-text-v2-moe: MoE FFN every 2nd layer with
                # plain-GELU experts AND plain-GELU dense layers
                # (llama.cpp build_bert treats NOMIC_BERT_MOE FFNs as
                # non-gated GELU)
                every = int(d.get("moe_every_n_layers") or 2)
                if every != 2:
                    raise ValueError(
                        f"moe_every_n_layers={every} is not supported "
                        f"(only the published every-2nd-layer layout)")
                overrides.setdefault("num_experts",
                                     int(d["num_experts"]))
                overrides.setdefault("moe_top_k",
                                     int(d.get("moe_top_k", 2)))
                overrides.setdefault("moe_every_n_layers", every)
                overrides.setdefault(
                    "moe_normalize_topk",
                    bool(d.get("moe_normalize_expert_weights")))
                act, gated = "gelu", False
            d = {**d,
                 "hidden_size": d["n_embd"],
                 "num_hidden_layers": d["n_layer"],
                 "num_attention_heads": d["n_head"],
                 "intermediate_size": d.get("n_inner") or 4 * d["n_embd"],
                 "max_position_embeddings": d.get("n_positions", 2048),
                 "layer_norm_eps": d.get("layer_norm_epsilon", 1e-12),
                 "hidden_act": {"swiglu": "silu", "geglu": "gelu"}.get(
                     act, act)}
            overrides.setdefault("position_embedding_type", "rotary")
            overrides.setdefault("rotary_interleaved",
                                 bool(d.get("rotary_emb_interleaved",
                                            False)))
            overrides.setdefault("rotary_base",
                                 float(d.get("rotary_emb_base", 1000.0)))
            overrides.setdefault("gated_mlp", gated)
        if d.get("model_type") == "qwen2":
            # Decoder-based embedders on the Qwen2 architecture
            # (gte-Qwen2-*-instruct, and the same block shape as
            # e5-mistral/Llama-style embedders): RMSNorm pre-norm
            # blocks, GQA, SwiGLU, RoPE, last-token pooling. Causal by
            # default (decoder); gte-Qwen2's modeling code flips
            # attention bidirectional — honor an is_causal field when
            # the checkpoint carries one.
            overrides.setdefault("norm_style", "pre")
            overrides.setdefault("norm_type", "rmsnorm")
            overrides.setdefault("causal", bool(d.get("is_causal", True)))
            overrides.setdefault("num_key_value_heads",
                                 int(d.get("num_key_value_heads",
                                           d["num_attention_heads"])))
            overrides.setdefault("position_embedding_type", "rotary")
            overrides.setdefault("rotary_base",
                                 float(d.get("rope_theta", 1000000.0)))
            overrides.setdefault("gated_mlp", True)
            overrides.setdefault("pooling", "lasttoken")
            eos = d.get("eos_token_id", 151643)
            overrides.setdefault("cls_token_id", int(d.get("bos_token_id")
                                                     or eos))
            overrides.setdefault("sep_token_id", int(eos))
            d = {**d,
                 "hidden_act": d.get("hidden_act", "silu"),
                 "layer_norm_eps": d.get("rms_norm_eps", 1e-6),
                 "pad_token_id": d.get("pad_token_id") or int(eos),
                 "type_vocab_size": 1}  # synthesized zeros row
        if d.get("model_type") == "deepseek_v2":
            # DeepSeek-V2(-Lite) run as a decoder embedder (causal, an
            # appended EOS, last-token pooling), on Qwen2's pre-norm
            # RMSNorm stack: MLA attention (no q compression), YaRN on the
            # rotated parts, leading dense SwiGLU layers, then MoE layers
            # of SwiGLU experts with softmax greedy top-k routing and a
            # shared expert.
            refused = {
                "q_lora_rank": d.get("q_lora_rank") is not None,
                "topk_method": d.get("topk_method", "greedy") != "greedy",
                "scoring_func": d.get("scoring_func", "softmax")
                != "softmax",
                "moe_layer_freq": int(d.get("moe_layer_freq", 1)) != 1,
                "attention_bias": bool(d.get("attention_bias")),
            }
            bad = [k for k, v in refused.items() if v]
            if bad:
                raise ValueError(f"unsupported DeepSeek-V2 settings: "
                                 f"{', '.join(bad)}")
            rs = d.get("rope_scaling") or {}
            if rs and rs.get("type", rs.get("rope_type")) != "yarn":
                raise ValueError(f"only YaRN rope_scaling is supported, "
                                 f"got {rs!r}")
            overrides.setdefault("norm_style", "pre")
            overrides.setdefault("norm_type", "rmsnorm")
            overrides.setdefault("causal", bool(d.get("is_causal", True)))
            overrides.setdefault("position_embedding_type", "rotary")
            overrides.setdefault("rotary_base",
                                 float(d.get("rope_theta", 10000.0)))
            overrides.setdefault("rope_scaling", rs)
            overrides.setdefault("gated_mlp", True)
            overrides.setdefault("pooling", "lasttoken")
            overrides.setdefault("kv_lora_rank", int(d["kv_lora_rank"]))
            for k in ("qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim"):
                overrides.setdefault(k, int(d[k]))
            if d.get("n_routed_experts"):
                overrides.setdefault("num_experts",
                                     int(d["n_routed_experts"]))
                overrides.setdefault("moe_top_k",
                                     int(d["num_experts_per_tok"]))
                overrides.setdefault("moe_every_n_layers", 1)
                overrides.setdefault("moe_normalize_topk",
                                     bool(d.get("norm_topk_prob")))
                overrides.setdefault("first_k_dense_replace",
                                     int(d.get("first_k_dense_replace", 0)))
                overrides.setdefault("moe_intermediate_size",
                                     int(d["moe_intermediate_size"]))
                overrides.setdefault("n_shared_experts",
                                     int(d.get("n_shared_experts") or 0))
                overrides.setdefault(
                    "routed_scaling_factor",
                    float(d.get("routed_scaling_factor", 1.0)))
            eos = int(d.get("eos_token_id", 100001))
            overrides.setdefault("cls_token_id",
                                 int(d.get("bos_token_id", 100000)))
            overrides.setdefault("sep_token_id", eos)
            d = {**d,
                 "hidden_act": d.get("hidden_act", "silu"),
                 "layer_norm_eps": d.get("rms_norm_eps", 1e-6),
                 "pad_token_id": d.get("pad_token_id") or eos,
                 "type_vocab_size": 1}  # synthesized zeros row
        if d.get("model_type") == "modernbert":
            # ModernBERT (gte-modernbert-base, nomic modernbert-embed):
            # pre-norm biasless blocks, RoPE with separate global/local
            # thetas, attention alternating global / 128-token sliding
            # window, GeGLU MLP (Wi packs act-half|mult-half), final norm.
            overrides.setdefault("position_embedding_type", "rotary")
            overrides.setdefault("rotary_base",
                                 float(d.get("global_rope_theta", 160000.0)))
            overrides.setdefault(
                "local_rotary_base",
                float(d.get("local_rope_theta")
                      or d.get("global_rope_theta", 160000.0)))
            overrides.setdefault("global_attn_every_n_layers",
                                 int(d.get("global_attn_every_n_layers", 3)))
            overrides.setdefault("local_attention_window",
                                 int(d.get("local_attention", 128)))
            overrides.setdefault("gated_mlp", True)
            overrides.setdefault("norm_style", "pre")
            overrides.setdefault("first_attn_norm_identity", True)
            overrides.setdefault("cls_token_id",
                                 int(d.get("cls_token_id", 50281)))
            overrides.setdefault("sep_token_id",
                                 int(d.get("sep_token_id", 50282)))
            d = {**d,
                 "hidden_act": d.get("hidden_activation", "gelu"),
                 "layer_norm_eps": d.get("norm_eps", 1e-5),
                 "type_vocab_size": 1}  # synthesized zeros row
        if d.get("position_embedding_type") == "alibi":
            # jina-bert-v2 (jina-embeddings-v2-*): model_type "bert" with
            # ALiBi attention bias instead of a position table, and a GLU
            # MLP selected by feed_forward_type ("geglu" in every
            # published jina-v2; "reglu" accepted, "original" = plain
            # BERT FFN). 8192-token context via the blocked-query
            # attention grids.
            overrides.setdefault("position_embedding_type", "alibi")
            fft = d.get("feed_forward_type", "original")
            if fft in ("geglu", "reglu"):
                overrides.setdefault("gated_mlp", True)
                d = {**d, "hidden_act": {"geglu": "gelu",
                                         "reglu": "relu"}[fft]}
            elif fft != "original":
                raise ValueError(f"unknown feed_forward_type {fft!r}")
        if d.get("model_type") == "distilbert":
            d = {**d,
                 "hidden_size": d["dim"],
                 "num_hidden_layers": d["n_layers"],
                 "num_attention_heads": d["n_heads"],
                 "intermediate_size": d["hidden_dim"],
                 "hidden_act": d.get("activation", "gelu"),
                 "type_vocab_size": 1}  # synthesized zeros row
        act = d.get("hidden_act", "gelu")
        if act in ("gelu_new", "gelu_pytorch_tanh"):
            act = "gelu_tanh"
        kw: dict[str, Any] = dict(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=d["num_attention_heads"],
            intermediate_size=d["intermediate_size"],
            max_position_embeddings=d.get("max_position_embeddings", 512),
            type_vocab_size=d.get("type_vocab_size", 2),
            layer_norm_eps=d.get("layer_norm_eps", 1e-12),
            hidden_act=act,
            pad_token_id=d.get("pad_token_id", 0),
        )
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def from_json(cls, path: str | Path, **overrides: Any) -> "BertConfig":
        with open(path) as f:
            return cls.from_hf_dict(json.load(f), **overrides)

    def to_dict(self) -> dict[str, Any]:
        """The fields as a dict; the port's own DeepSeek-V2 fields only
        where they are set, so other configs round-trip through the JAX
        package's ``BertConfig``."""
        out = dataclasses.asdict(self)
        for f in dataclasses.fields(self):
            if f.name in PORT_ONLY_FIELDS and out[f.name] == f.default:
                del out[f.name]
        return out


PORT_ONLY_FIELDS = frozenset((
    "first_k_dense_replace", "moe_intermediate_size", "n_shared_experts",
    "routed_scaling_factor", "kv_lora_rank", "qk_nope_head_dim",
    "qk_rope_head_dim", "v_head_dim", "rope_scaling"))


@dataclasses.dataclass
class EngineConfig:
    """Runtime/engine knobs (the reference's ``bert_params`` analogue,
    `bert.h:18-25`, plus what a batched accelerator engine needs)."""

    # Sequence-length buckets: a small closed set of padded shapes (the
    # reference grows a byte arena per batch instead, bert.cpp:788-810).
    seq_buckets: tuple[int, ...] = (16, 32, 64, 128, 256, 512)
    max_seq_len: int = 512
    batch_size: int = 32
    # Batch-size buckets (powers of two up to batch_size).
    batch_buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    # activation dtype inside the encoder; None = auto (bf16 on a CUDA
    # device, f32 on the CPU). LayerNorm/softmax/pooling accumulate in f32
    # regardless.
    compute_dtype: str | None = None
    mask_value: float = -1e9  # additive mask for pad positions (ref uses -1e5·…)
    # "auto" | "always": quantized matmuls and prefix-masked attention go
    # through the hand-written kernels (their plain versions on the CPU);
    # "never": the plain f32 reference math (dequantize + matmul, exact-erf
    # GELU, additive-mask attention), as the JAX package's XLA fallback
    use_pallas: str = "auto"
    # int8 tensor-core compute for quantized matmuls (kernel K3 on the
    # card: s8 x s8 -> s32 over per-column requantized weights and per-row
    # quantized activations); shapes the JAX package's rule does not
    # engage run bf16 with a warning
    int8_compute: bool = False
    # max device batches dispatched ahead of result read-back: keeps the
    # host/device pipeline full while bounding live output buffers (a
    # retrieval-scale encode holds O(inflight) buffers, not O(corpus))
    inflight_batches: int = 4

    def __post_init__(self) -> None:
        self.seq_buckets = tuple(sorted(set(int(b) for b in self.seq_buckets)))
        if self.seq_buckets[-1] < self.max_seq_len:
            # extend by doubling, ending exactly at max_seq_len: a
            # long-context model (nomic 2048, jina/ModernBERT 8192) gets
            # intermediate buckets instead of padding every >512-token
            # text to the full context
            bb = set(self.seq_buckets)
            b = self.seq_buckets[-1]
            while b < self.max_seq_len:
                b = min(b * 2, self.max_seq_len)
                bb.add(b)
            self.seq_buckets = tuple(sorted(bb))
        # batch buckets must cover batch_size (a batch_size above the
        # largest default bucket would otherwise fail at plan time):
        # extend by doubling, ending exactly at batch_size
        bb = set(int(b) for b in self.batch_buckets if b <= self.batch_size)
        b = max(bb) if bb else 1
        while b < self.batch_size:
            b = min(b * 2, self.batch_size)
            bb.add(b)
        self.batch_buckets = tuple(sorted(bb))


def detect_pooling(model_dir: str | Path) -> str | None:
    """Infer the sentence-pooling mode for an HF/SentenceTransformers model
    directory. Returns None when nothing identifies it (caller keeps the
    default).

    Order: (1) SentenceTransformers ``1_Pooling/config.json`` flags —
    authoritative when present; (2) match the directory name (and the
    checkpoint's ``_name_or_path``) against KNOWN_MODELS. The reference
    mean-pools everything (bert.cpp:1087-1089) including CLS-pooled BGE
    models; this detection is deliberately better than parity.
    """
    model_dir = Path(model_dir)
    pool_cfg = model_dir / "1_Pooling" / "config.json"
    if pool_cfg.exists():
        with open(pool_cfg) as f:
            d = json.load(f)
        for mode, key in (("cls", "pooling_mode_cls_token"),
                          ("mean", "pooling_mode_mean_tokens"),
                          ("max", "pooling_mode_max_tokens")):
            if d.get(key):
                return mode
        # the file exists but declares a mode we don't implement (e.g.
        # pooling_mode_weightedmean_tokens): it is authoritative, so do
        # NOT fall through to the name heuristic — surface it instead
        unsupported = [k for k, v in d.items()
                       if k.startswith("pooling_mode_") and v]
        import logging
        logging.getLogger("embeddings_tpu_torch.config").warning(
            "1_Pooling/config.json declares unsupported pooling %s; "
            "keeping the default (pass pooling= to override)",
            unsupported or "<none set>")
        return None
    names = [model_dir.name.lower()]
    cfg = model_dir / "config.json"
    if cfg.exists():
        with open(cfg) as f:
            ref = json.load(f).get("_name_or_path", "")
        if ref:
            names.append(str(ref).lower())
    for known, kw in KNOWN_MODELS.items():
        if any(known.lower() in n for n in names):
            return kw.get("pooling", "mean")
    # no 1_Pooling/config.json and no KNOWN_MODELS match: the caller will
    # keep its default (mean). That is silently wrong for unknown
    # CLS-trained models, so say so once per load.
    import logging
    logging.getLogger("embeddings_tpu_torch.config").info(
        "no pooling signal found for %s (no 1_Pooling/config.json, not a "
        "known model); defaulting to mean pooling — pass pooling= to "
        "override", model_dir)
    return None


# Known model families (the reference supports these via its converter;
# `README.md:16-22` lists MiniLM + BGE en/zh).
KNOWN_MODELS: dict[str, dict[str, Any]] = {
    "all-MiniLM-L6-v2": dict(hidden_size=384, num_hidden_layers=6, num_attention_heads=12, intermediate_size=1536),
    "all-MiniLM-L12-v2": dict(hidden_size=384, num_hidden_layers=12, num_attention_heads=12, intermediate_size=1536),
    "bert-base-uncased": dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072),
    "bge-small-en-v1.5": dict(hidden_size=384, num_hidden_layers=12, num_attention_heads=12, intermediate_size=1536, pooling="cls"),
    "bge-base-en-v1.5": dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072, pooling="cls"),
    "bge-large-en-v1.5": dict(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16, intermediate_size=4096, pooling="cls"),
    "bge-small-zh-v1.5": dict(vocab_size=21128, hidden_size=512, num_hidden_layers=4, num_attention_heads=8, intermediate_size=2048, pooling="cls"),
    "bge-base-zh-v1.5": dict(vocab_size=21128, hidden_size=768, num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072, pooling="cls"),
    # RoBERTa family (beyond the reference; byte-level BPE tokenizer,
    # position rows offset by 2, mean-pooled SentenceTransformers heads)
    "all-distilroberta-v1": dict(hidden_size=768, num_hidden_layers=6, num_attention_heads=12, intermediate_size=3072, type_vocab_size=1, position_offset=2),
    "paraphrase-distilroberta-base-v2": dict(hidden_size=768, num_hidden_layers=6, num_attention_heads=12, intermediate_size=3072, type_vocab_size=1, position_offset=2),
    # MPNet family (beyond the reference; relative position bias)
    "all-mpnet-base-v2": dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072, type_vocab_size=1, position_offset=2, relative_attention_num_buckets=32),
    "multi-qa-mpnet-base-dot-v1": dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072, type_vocab_size=1, position_offset=2, relative_attention_num_buckets=32, pooling="cls", normalize_embeddings=False),
    # Rotary family (beyond the reference): nomic-bert-2048 behind
    # nomic-embed-text (half-split rotary, SwiGLU gated MLP, 2048-token
    # context — the >512 blocked-query attention path), RoFormer
    # (interleaved rotary)
    "nomic-embed-text-v1": dict(vocab_size=30528, hidden_size=768, num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072, max_position_embeddings=2048, type_vocab_size=2, position_embedding_type="rotary", rotary_base=1000.0, gated_mlp=True, hidden_act="silu"),
    "nomic-embed-text-v1.5": dict(vocab_size=30528, hidden_size=768, num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072, max_position_embeddings=2048, type_vocab_size=2, position_embedding_type="rotary", rotary_base=1000.0, gated_mlp=True, hidden_act="silu"),
    # nomic-embed-text-v2-moe: multilingual (XLM-R sentencepiece vocab),
    # ungated GELU FFNs, MoE FFN every 2nd layer (8 experts, top-2)
    "nomic-embed-text-v2-moe": dict(vocab_size=250048, hidden_size=768, num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072, max_position_embeddings=2048, type_vocab_size=2, position_embedding_type="rotary", rotary_base=1000.0, hidden_act="gelu", num_experts=8, moe_top_k=2, moe_every_n_layers=2),
    "roformer_chinese_base": dict(vocab_size=50000, hidden_size=768, num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072, max_position_embeddings=1536, position_embedding_type="rotary", rotary_interleaved=True),
    # ModernBERT family (beyond the reference): pre-norm biasless blocks,
    # alternating global/sliding-window RoPE attention, GeGLU, 8192 ctx
    "gte-modernbert-base": dict(vocab_size=50368, hidden_size=768, num_hidden_layers=22, num_attention_heads=12, intermediate_size=1152, max_position_embeddings=8192, position_embedding_type="rotary", rotary_base=160000.0, local_rotary_base=10000.0, global_attn_every_n_layers=3, local_attention_window=128, gated_mlp=True, norm_style="pre", first_attn_norm_identity=True, layer_norm_eps=1e-5, type_vocab_size=1, cls_token_id=50281, sep_token_id=50282, pooling="cls"),
    "modernbert-embed-base": dict(vocab_size=50368, hidden_size=768, num_hidden_layers=22, num_attention_heads=12, intermediate_size=1152, max_position_embeddings=8192, position_embedding_type="rotary", rotary_base=160000.0, local_rotary_base=10000.0, global_attn_every_n_layers=3, local_attention_window=128, gated_mlp=True, norm_style="pre", first_attn_norm_identity=True, layer_norm_eps=1e-5, type_vocab_size=1, cls_token_id=50281, sep_token_id=50282),
    # Qwen2 decoder-embedder family (beyond the reference): RMSNorm
    # pre-norm blocks, GQA, SwiGLU, RoPE, last-token pooling. gte-Qwen2
    # runs attention bidirectionally (is_causal=False in its config).
    "gte-Qwen2-1.5B-instruct": dict(vocab_size=151646, hidden_size=1536, num_hidden_layers=28, num_attention_heads=12, intermediate_size=8960, max_position_embeddings=32768, num_key_value_heads=2, norm_style="pre", norm_type="rmsnorm", position_embedding_type="rotary", rotary_base=1000000.0, gated_mlp=True, hidden_act="silu", layer_norm_eps=1e-6, type_vocab_size=1, pooling="lasttoken"),
    "gte-Qwen2-7B-instruct": dict(vocab_size=151646, hidden_size=3584, num_hidden_layers=28, num_attention_heads=28, intermediate_size=18944, max_position_embeddings=32768, num_key_value_heads=4, norm_style="pre", norm_type="rmsnorm", position_embedding_type="rotary", rotary_base=1000000.0, gated_mlp=True, hidden_act="silu", layer_norm_eps=1e-6, type_vocab_size=1, pooling="lasttoken"),
    # ALiBi family (beyond the reference): jina-bert-v2 — symmetric
    # ALiBi logit bias, GeGLU MLP, 8192-token context, mean pooling
    "jina-embeddings-v2-base-en": dict(vocab_size=30528, hidden_size=768, num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072, max_position_embeddings=8192, position_embedding_type="alibi", gated_mlp=True, hidden_act="gelu"),
    "jina-embeddings-v2-small-en": dict(vocab_size=30528, hidden_size=512, num_hidden_layers=4, num_attention_heads=8, intermediate_size=2048, max_position_embeddings=8192, position_embedding_type="alibi", gated_mlp=True, hidden_act="gelu"),
    # DistilBERT family (beyond the reference; loader translates names)
    "distilbert-base-uncased": dict(hidden_size=768, num_hidden_layers=6, num_attention_heads=12, intermediate_size=3072, type_vocab_size=1),
    "multi-qa-distilbert-cos-v1": dict(hidden_size=768, num_hidden_layers=6, num_attention_heads=12, intermediate_size=3072, type_vocab_size=1),
    "msmarco-distilbert-base-v4": dict(hidden_size=768, num_hidden_layers=6, num_attention_heads=12, intermediate_size=3072, type_vocab_size=1),
}
