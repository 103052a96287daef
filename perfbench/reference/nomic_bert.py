"""Plain reference of nomic-bert with a mixture of experts (HF
``NomicBertModel`` as nomic-embed-text-v2-moe configures it: no position
table, half-split rotary q and k, post-LN blocks, exact GELU; every
second layer's FFN is ``num_experts`` experts routed top-``moe_top_k`` by
a softmax router, the chosen experts' outputs weighted by their
probabilities, plus one shared output bias) with mean pooling, in
float32, from the checkpoint's own tensor names. The attention and dense
FFN weights and the word table go through the q4_0 codec, as the
configuration states; the router and the experts stay as made.
"""

from __future__ import annotations

import torch

from .common import attention, batched, gelu, layer_norm, no_tf32, pool, \
    q4_0_roundtrip, rotary


def widths(hf: dict) -> dict:
    """The published config's sizes under common names."""
    return {"hidden_size": hf["n_embd"], "num_hidden_layers": hf["n_layer"],
            "num_attention_heads": hf["n_head"],
            "intermediate_size": hf["n_inner"],
            "vocab_size": hf["vocab_size"],
            "num_experts": hf.get("num_experts", 0),
            "moe_top_k": hf.get("moe_top_k", 0)}


def _moe_layer(hf: dict, i: int) -> bool:
    every = hf.get("moe_every_n_layers") or 0
    return bool(hf.get("num_experts")) and every > 0 and i % every == every - 1


def checkpoint_spec(hf: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of the checkpoint: a fused
    Wqkv [3E, E] (q | k | v rows), fc1 / fc2 at dense layers, and at MoE
    layers the router [Ex, E], the experts' w1 and w2 [Ex * I, E] and
    their shared output bias [E]."""
    E, F, Ex = hf["n_embd"], hf["n_inner"], hf.get("num_experts", 0)
    spec = [("embeddings.word_embeddings.weight", (hf["vocab_size"], E),
             "matrix"),
            ("embeddings.token_type_embeddings.weight",
             (hf["type_vocab_size"], E), "matrix"),
            ("emb_ln.weight", (E,), "ln_scale"),
            ("emb_ln.bias", (E,), "ln_bias")]
    for i in range(hf["n_layer"]):
        p = f"encoder.layers.{i}."
        spec += [(p + "attn.Wqkv.weight", (3 * E, E), "matrix"),
                 (p + "attn.Wqkv.bias", (3 * E,), "bias"),
                 (p + "attn.out_proj.weight", (E, E), "matrix"),
                 (p + "attn.out_proj.bias", (E,), "bias")]
        for n in ("norm1", "norm2"):
            spec += [(p + n + ".weight", (E,), "ln_scale"),
                     (p + n + ".bias", (E,), "ln_bias")]
        if _moe_layer(hf, i):
            spec += [(p + "mlp.router.layer.weight", (Ex, E), "matrix"),
                     (p + "mlp.experts.mlp.w1", (Ex * F, E), "matrix"),
                     (p + "mlp.experts.mlp.w2", (Ex * F, E), "matrix"),
                     (p + "mlp.experts.bias", (E,), "bias")]
        else:
            spec += [(p + "mlp.fc1.weight", (F, E), "matrix"),
                     (p + "mlp.fc1.bias", (F,), "bias"),
                     (p + "mlp.fc2.weight", (E, F), "matrix"),
                     (p + "mlp.fc2.bias", (E,), "bias")]
    return spec


def quantized(name: str) -> bool:
    """The word table, the attention's and the dense FFN's matmul weights;
    not the router, not the experts."""
    return name == "embeddings.word_embeddings.weight" or name.endswith((
        "attn.Wqkv.weight", "attn.out_proj.weight", "mlp.fc1.weight",
        "mlp.fc2.weight"))


def _moe(x: torch.Tensor, w: dict, p: str, hf: dict) -> torch.Tensor:
    """[T, E] -> [T, E]: softmax router over all experts, the top-k
    probabilities (renormalized only where the config says so), each
    chosen expert's gelu(x w1_e^T) w2_e, the shared bias."""
    E, F, Ex, k = hf["n_embd"], hf["n_inner"], hf["num_experts"], \
        hf["moe_top_k"]
    probs = torch.softmax(x @ w[p + "mlp.router.layer.weight"].T, -1)
    top_w, top_e = torch.topk(probs, k, dim=-1)
    if hf.get("moe_normalize_expert_weights"):
        top_w = top_w / top_w.sum(-1, keepdim=True)
    w1 = w[p + "mlp.experts.mlp.w1"].reshape(Ex, F, E)
    w2 = w[p + "mlp.experts.mlp.w2"].reshape(Ex, F, E)
    out = torch.zeros_like(x)
    for e in range(Ex):
        tok, slot = torch.nonzero(top_e == e, as_tuple=True)
        if tok.numel():
            y = gelu(x[tok] @ w1[e].T) @ w2[e]
            out.index_add_(0, tok, y * top_w[tok, slot][:, None])
    return out + w[p + "mlp.experts.bias"]


def encode(sd: dict, hf: dict, head: dict, seqs: list,
           device) -> torch.Tensor:
    """[len(seqs), E] float32 embeddings of token-id sequences."""
    no_tf32()
    w = {k: (q4_0_roundtrip(v) if quantized(k) else v.float())
         for k, v in sd.items()}
    E, H = hf["n_embd"], hf["n_head"]
    eps = hf.get("layer_norm_epsilon", 1e-12)
    base = float(hf.get("rotary_emb_base", 10000.0))

    def forward(ids, ok):
        B, L = ids.shape
        x = (w["embeddings.word_embeddings.weight"][ids]
             + w["embeddings.token_type_embeddings.weight"][0])
        x = layer_norm(x, w["emb_ln.weight"], w["emb_ln.bias"], eps)
        for i in range(hf["n_layer"]):
            p = f"encoder.layers.{i}."
            qkv = x @ w[p + "attn.Wqkv.weight"].T + w[p + "attn.Wqkv.bias"]
            q, k, v = (t.reshape(B, L, H, -1) for t in qkv.split(E, -1))
            ctx = attention(rotary(q, base), rotary(k, base), v,
                            ok).reshape(B, L, E)
            o = ctx @ w[p + "attn.out_proj.weight"].T \
                + w[p + "attn.out_proj.bias"]
            x = layer_norm(x + o, w[p + "norm1.weight"], w[p + "norm1.bias"],
                           eps)
            if _moe_layer(hf, i):
                y = _moe(x.reshape(B * L, E), w, p, hf).reshape(B, L, E)
            else:
                h = gelu(x @ w[p + "mlp.fc1.weight"].T
                         + w[p + "mlp.fc1.bias"])
                y = h @ w[p + "mlp.fc2.weight"].T + w[p + "mlp.fc2.bias"]
            x = layer_norm(x + y, w[p + "norm2.weight"], w[p + "norm2.bias"],
                           eps)
        return pool(x, ok, head["pooling"], head["normalize"])

    with torch.no_grad():
        return batched(seqs, forward, device)
