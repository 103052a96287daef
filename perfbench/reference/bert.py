"""Plain reference of a BERT encoder (HF ``BertModel``: learned
positions, post-LN blocks, exact GELU) with its SentenceTransformers head,
in float32, from the checkpoint's own tensor names. The matmul weights
and the word table go through the q4_0 codec, as the configuration
states; everything else stays as made.
"""

from __future__ import annotations

import torch

from .common import attention, batched, gelu, layer_norm, no_tf32, pool, \
    q4_0_roundtrip


def widths(hf: dict) -> dict:
    """The published config's sizes under common names."""
    return {"hidden_size": hf["hidden_size"],
            "num_hidden_layers": hf["num_hidden_layers"],
            "num_attention_heads": hf["num_attention_heads"],
            "intermediate_size": hf["intermediate_size"],
            "vocab_size": hf["vocab_size"]}


def checkpoint_spec(hf: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor the encoder's checkpoint holds
    (the pooler aside: an embedding model does not use it); kind is
    "matrix", "bias", "ln_scale" or "ln_bias"."""
    E, F = hf["hidden_size"], hf["intermediate_size"]
    spec = [("embeddings.word_embeddings.weight", (hf["vocab_size"], E),
             "matrix"),
            ("embeddings.position_embeddings.weight",
             (hf["max_position_embeddings"], E), "matrix"),
            ("embeddings.token_type_embeddings.weight",
             (hf["type_vocab_size"], E), "matrix")]
    spec += _ln("embeddings.LayerNorm", E)
    for i in range(hf["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        for n in ("query", "key", "value"):
            spec += _lin(p + "attention.self." + n, E, E)
        spec += _lin(p + "attention.output.dense", E, E)
        spec += _ln(p + "attention.output.LayerNorm", E)
        spec += _lin(p + "intermediate.dense", F, E)
        spec += _lin(p + "output.dense", E, F)
        spec += _ln(p + "output.LayerNorm", E)
    return spec


def _lin(name: str, out: int, inp: int) -> list:
    return [(name + ".weight", (out, inp), "matrix"),
            (name + ".bias", (out,), "bias")]


def _ln(name: str, n: int) -> list:
    return [(name + ".weight", (n,), "ln_scale"),
            (name + ".bias", (n,), "ln_bias")]


def quantized(name: str) -> bool:
    """Does the served model hold this tensor in q4_0? The word table and
    every layer's matmul weights."""
    return name == "embeddings.word_embeddings.weight" or (
        name.startswith("encoder.layer.") and name.endswith(".weight")
        and "LayerNorm" not in name)


def encode(sd: dict, hf: dict, head: dict, seqs: list,
           device) -> torch.Tensor:
    """[len(seqs), E] float32 embeddings of token-id sequences."""
    no_tf32()
    w = {k: (q4_0_roundtrip(v) if quantized(k) else v.float())
         for k, v in sd.items()}
    E, H = hf["hidden_size"], hf["num_attention_heads"]
    eps = hf.get("layer_norm_eps", 1e-12)

    def forward(ids, ok):
        B, L = ids.shape
        x = (w["embeddings.word_embeddings.weight"][ids]
             + w["embeddings.position_embeddings.weight"][:L][None]
             + w["embeddings.token_type_embeddings.weight"][0])
        x = layer_norm(x, w["embeddings.LayerNorm.weight"],
                       w["embeddings.LayerNorm.bias"], eps)
        for i in range(hf["num_hidden_layers"]):
            p = f"encoder.layer.{i}."

            def lin(n, t):
                return t @ w[p + n + ".weight"].T + w[p + n + ".bias"]
            q, k, v = (lin("attention.self." + n, x).reshape(B, L, H, -1)
                       for n in ("query", "key", "value"))
            ctx = attention(q, k, v, ok).reshape(B, L, E)
            x = layer_norm(x + lin("attention.output.dense", ctx),
                           w[p + "attention.output.LayerNorm.weight"],
                           w[p + "attention.output.LayerNorm.bias"], eps)
            h = gelu(lin("intermediate.dense", x))
            x = layer_norm(x + lin("output.dense", h),
                           w[p + "output.LayerNorm.weight"],
                           w[p + "output.LayerNorm.bias"], eps)
        return pool(x, ok, head["pooling"], head["normalize"])

    with torch.no_grad():
        return batched(seqs, forward, device)
