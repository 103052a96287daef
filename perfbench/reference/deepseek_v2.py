"""Plain reference of DeepSeek-V2 (``modeling_deepseek.py`` as
DeepSeek-V2-Lite configures it) run as a decoder embedder: causal
attention, the sequence's last token (its appended EOS) pooled, the L2
norm. In float32 from the checkpoint's own tensor names, computed in
blocks so that rows of 4,096 tokens fit beside the weights.

Each layer: h = x + MLA(RMSNorm(x)); x = h + FFN(RMSNorm(h)), FFN a dense
SwiGLU at the first ``first_k_dense_replace`` layers and the MoE after:
a softmax router over ``n_routed_experts``, the top ``num_experts_per_tok``
probabilities (not renormalized where ``norm_topk_prob`` is false) times
``routed_scaling_factor``, each chosen SwiGLU expert's output weighted by
its probability, plus the shared experts (one SwiGLU of
``n_shared_experts * moe_intermediate_size``) on every token. MLA without
q compression: q = u Wq per head [q_nope | q_pe]; [c | k_pe] = u Wkva, c
RMS-normed, [k_nope | v] = c Wkvb per head; q_pe and k_pe (one, shared
by the heads) rotated by YaRN at the token's position; softmax at
qk_head_dim^-0.5 * mscale(factor, mscale_all_dim)^2. The projections,
the dense and shared SwiGLUs and the word table go through the q4_0
codec, as the configuration states; the router, the routed experts and
the norms stay as made.

Departures from ``modeling_deepseek.py``: YaRN's tables are computed in
float64 and rounded once (the module builds them in float32, which at
4,096 positions moves an angle by up to ~2e-4 rad); the rotation pairs
(x_2i, x_2i+1) in place, where the module first permutes them apart and
pairs i with i + d/2, which gives every q . k the same value; the experts
and the router see only the sequences' own tokens (pads are never read by
a real token under the causal mask); the MoE's auxiliary loss, the KV
cache and the LM head are left out. Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch

from .common import batched, no_tf32, q4_0_roundtrip

QUERY_BLOCK = 512  # attention rows a step: [B, H, 512, L] f32 scores


def widths(hf: dict) -> dict:
    """The published config's sizes under common names."""
    return {"hidden_size": hf["hidden_size"],
            "num_hidden_layers": hf["num_hidden_layers"],
            "num_attention_heads": hf["num_attention_heads"],
            "intermediate_size": hf["intermediate_size"],
            "vocab_size": hf["vocab_size"],
            "num_experts": hf["n_routed_experts"],
            "moe_top_k": hf["num_experts_per_tok"],
            "moe_intermediate_size": hf["moe_intermediate_size"],
            "n_shared_experts": hf["n_shared_experts"],
            "first_k_dense_replace": hf["first_k_dense_replace"],
            "kv_lora_rank": hf["kv_lora_rank"],
            "qk_nope_head_dim": hf["qk_nope_head_dim"],
            "qk_rope_head_dim": hf["qk_rope_head_dim"],
            "v_head_dim": hf["v_head_dim"]}


def checkpoint_spec(hf: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of the checkpoint
    (``DeepseekV2ForCausalLM``'s names, without the LM head): no biases
    (``attention_bias`` false), RMSNorm weights as "ln_scale"."""
    E, H = hf["hidden_size"], hf["num_attention_heads"]
    dn, dr, dv = (hf["qk_nope_head_dim"], hf["qk_rope_head_dim"],
                  hf["v_head_dim"])
    r, F, I = hf["kv_lora_rank"], hf["intermediate_size"], \
        hf["moe_intermediate_size"]
    Ex, Fs = hf["n_routed_experts"], hf["n_shared_experts"] * I
    spec = [("model.embed_tokens.weight", (hf["vocab_size"], E), "matrix")]
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        spec += [(p + "input_layernorm.weight", (E,), "ln_scale"),
                 (a + "q_proj.weight", (H * (dn + dr), E), "matrix"),
                 (a + "kv_a_proj_with_mqa.weight", (r + dr, E), "matrix"),
                 (a + "kv_a_layernorm.weight", (r,), "ln_scale"),
                 (a + "kv_b_proj.weight", (H * (dn + dv), r), "matrix"),
                 (a + "o_proj.weight", (E, H * dv), "matrix"),
                 (p + "post_attention_layernorm.weight", (E,), "ln_scale")]
        if i < hf["first_k_dense_replace"]:
            spec += _swiglu(p + "mlp.", E, F)
            continue
        spec.append((p + "mlp.gate.weight", (Ex, E), "matrix"))
        for e in range(Ex):
            spec += _swiglu(f"{p}mlp.experts.{e}.", E, I)
        if Fs:
            spec += _swiglu(p + "mlp.shared_experts.", E, Fs)
    spec.append(("model.norm.weight", (E,), "ln_scale"))
    return spec


def _swiglu(p: str, E: int, F: int) -> list:
    return [(p + "gate_proj.weight", (F, E), "matrix"),
            (p + "up_proj.weight", (F, E), "matrix"),
            (p + "down_proj.weight", (E, F), "matrix")]


def quantized(name: str) -> bool:
    """The word table, the attention projections and the dense and shared
    SwiGLUs; not the router, not the routed experts, not the norms."""
    if name == "model.embed_tokens.weight":
        return True
    if ".mlp.experts." in name:
        return False
    return name.endswith(("_proj.weight", "kv_a_proj_with_mqa.weight"))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _swiglu_apply(x: torch.Tensor, w: dict, p: str) -> torch.Tensor:
    g = x @ w[p + "gate_proj.weight"].T
    u = x @ w[p + "up_proj.weight"].T
    return (torch.nn.functional.silu(g) * u) @ w[p + "down_proj.weight"].T


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_cos_sin(hf: dict, L: int, device) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """[L, d/2] cos and sin of YaRN's angles for positions 0 .. L-1 over
    the rotated width d = qk_rope_head_dim (float64, rounded once)."""
    d, base = hf["qk_rope_head_dim"], float(hf.get("rope_theta", 10000))
    rs = hf.get("rope_scaling") or {}
    i = torch.arange(d // 2, dtype=torch.float64)
    extra = 1.0 / base ** (2 * i / d)
    scale = 1.0
    if rs:
        f = float(rs["factor"])
        orig = float(rs["original_max_position_embeddings"])

        def corr(rot):
            return d * math.log(orig / (rot * 2 * math.pi)) / (
                2 * math.log(base))
        low = max(math.floor(corr(rs.get("beta_fast", 32))), 0)
        high = min(math.ceil(corr(rs.get("beta_slow", 1))), d - 1)
        if low == high:
            high += 0.001
        ramp = ((i - low) / (high - low)).clamp(0, 1)
        extra = extra / f * ramp + extra * (1 - ramp)
        scale = (yarn_mscale(f, rs.get("mscale", 1))
                 / yarn_mscale(f, rs.get("mscale_all_dim", 0)))
    ang = torch.arange(L, dtype=torch.float64)[:, None] * extra
    return ((torch.cos(ang) * scale).float().to(device),
            (torch.sin(ang) * scale).float().to(device))


def rotate_pairs(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x_2i, x_2i+1) of [B, L, h, d] by the position's
    angle i; cos / sin [L, d/2]."""
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], -1).flatten(-2)


def softmax_scale(hf: dict) -> float:
    scale = (hf["qk_nope_head_dim"] + hf["qk_rope_head_dim"]) ** -0.5
    rs = hf.get("rope_scaling") or {}
    if rs.get("mscale_all_dim"):
        m = yarn_mscale(float(rs["factor"]), float(rs["mscale_all_dim"]))
        scale *= m * m
    return scale


def mla(x: torch.Tensor, ok: torch.Tensor, w: dict, p: str, hf: dict,
        cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """[B, L, E] -> [B, L, E]: latent attention, causal and pad-masked,
    the scores QUERY_BLOCK query rows at a time."""
    B, L, _ = x.shape
    H = hf["num_attention_heads"]
    dn, dr, dv, r = (hf["qk_nope_head_dim"], hf["qk_rope_head_dim"],
                     hf["v_head_dim"], hf["kv_lora_rank"])
    a = p + "self_attn."
    q = (x @ w[a + "q_proj.weight"].T).reshape(B, L, H, dn + dr)
    ckv = x @ w[a + "kv_a_proj_with_mqa.weight"].T
    c, k_pe = ckv[..., :r], ckv[..., r:]
    kv = (rms_norm(c, w[a + "kv_a_layernorm.weight"], hf["rms_norm_eps"])
          @ w[a + "kv_b_proj.weight"].T).reshape(B, L, H, dn + dv)
    k_pe = rotate_pairs(k_pe[:, :, None, :], cos, sin)
    qq = torch.cat([q[..., :dn], rotate_pairs(q[..., dn:], cos, sin)], -1)
    kk = torch.cat([kv[..., :dn], k_pe.expand(B, L, H, dr)], -1)
    v = kv[..., dn:]
    scale = softmax_scale(hf)
    pos = torch.arange(L, device=x.device)
    ctx = torch.empty(B, L, H, dv, device=x.device)
    for q0 in range(0, L, QUERY_BLOCK):
        rows = slice(q0, q0 + QUERY_BLOCK)
        s = torch.einsum("blhd,bmhd->bhlm", qq[:, rows], kk) * scale
        allowed = (pos[None, :] <= pos[rows, None])[None, None] \
            & ok[:, None, None, :]
        s = s.masked_fill(~allowed, float("-inf"))
        ctx[:, rows] = torch.einsum("bhlm,bmhd->blhd", torch.softmax(s, -1),
                                    v)
    return ctx.reshape(B, L, H * dv) @ w[a + "o_proj.weight"].T


def moe(x: torch.Tensor, w: dict, p: str, hf: dict) -> torch.Tensor:
    """[T, E] -> [T, E]: the routed experts and the shared experts."""
    Ex, k = hf["n_routed_experts"], hf["num_experts_per_tok"]
    probs = torch.softmax(x @ w[p + "mlp.gate.weight"].T, -1)
    top_w, top_e = torch.topk(probs, k, dim=-1)
    if hf.get("norm_topk_prob"):
        top_w = top_w / top_w.sum(-1, keepdim=True)
    top_w = top_w * hf.get("routed_scaling_factor", 1.0)
    out = torch.zeros_like(x)
    for e in range(Ex):
        tok, slot = torch.nonzero(top_e == e, as_tuple=True)
        if tok.numel():
            y = _swiglu_apply(x[tok], w, f"{p}mlp.experts.{e}.")
            out.index_add_(0, tok, y * top_w[tok, slot][:, None])
    if hf.get("n_shared_experts"):
        out = out + _swiglu_apply(x, w, p + "mlp.shared_experts.")
    return out


def encode(sd: dict, hf: dict, head: dict, seqs: list,
           device) -> torch.Tensor:
    """[len(seqs), E] float32 embeddings of token-id sequences (each
    ending in its EOS): the last token's final hidden state, L2-normed."""
    no_tf32()
    if head["pooling"] != "lasttoken":
        raise ValueError("the decoder embedder pools the last token")
    w = {k: (q4_0_roundtrip(v) if quantized(k) else v.float())
         for k, v in sd.items()}
    eps = hf["rms_norm_eps"]

    def forward(ids, ok):
        B, L = ids.shape
        cos, sin = yarn_cos_sin(hf, L, ids.device)
        x = w["model.embed_tokens.weight"][ids]
        for i in range(hf["num_hidden_layers"]):
            p = f"model.layers.{i}."
            x = x + mla(rms_norm(x, w[p + "input_layernorm.weight"], eps),
                        ok, w, p, hf, cos, sin)
            h = rms_norm(x, w[p + "post_attention_layernorm.weight"], eps)
            if i < hf["first_k_dense_replace"]:
                x = x + _swiglu_apply(h, w, p + "mlp.")
            else:
                y = torch.zeros_like(x)
                y[ok] = moe(h[ok], w, p, hf)
                x = x + y
        x = rms_norm(x, w["model.norm.weight"], eps)
        last = ok.sum(1) - 1
        out = x[torch.arange(B, device=x.device), last]
        if head["normalize"]:
            out = torch.nn.functional.normalize(out, dim=-1)
        return out

    with torch.no_grad():
        return batched(seqs, forward, device)
