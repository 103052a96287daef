"""Faults found in the port against the reference, each held by a test.

(a) Trees the port once refused by name (before it mapped these
    families) now map to the JAX package's tree, leaf for leaf: a 1-layer
    DistilBERT state dict (E=32, 2 heads, DistilBERT names, bare or under
    a ``distilbert.`` prefix) and BERT-named trees under the
    ``roberta.``, ``albert.`` and ``roformer.`` prefixes (not a KeyError
    deep in the mapping, as before the refusal).
(b) The rotary tables agree with the JAX package's, eager and jitted, at
    positions 0 .. 8,191 for theta 1e4, 1.6e5 and 1e6 at D = 64 and 128,
    to 4 f32 ulp of 1 (2.4e-7).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from embeddings_tpu.config import BertConfig as JaxConfig
from embeddings_tpu.models import params as JP
from embeddings_tpu.ops import rotary as jrot

from embeddings_tpu_torch.config import BertConfig
from embeddings_tpu_torch.models import params as P
from embeddings_tpu_torch.ops import rotary as trot

E, HEADS, FF, VOCAB, POS = 32, 2, 64, 100, 64
CFG = dict(vocab_size=VOCAB, hidden_size=E, num_hidden_layers=1,
           num_attention_heads=HEADS, intermediate_size=FF,
           max_position_embeddings=POS, type_vocab_size=1)


def _w(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32) * np.float32(0.02)


def distilbert_sd(prefix: str = "") -> dict:
    """A 1-layer DistilBERT state dict in HF naming."""
    rng = np.random.default_rng(0)
    sd = {"embeddings.word_embeddings.weight": _w(rng, VOCAB, E),
          "embeddings.position_embeddings.weight": _w(rng, POS, E),
          "embeddings.LayerNorm.weight": np.ones(E, np.float32),
          "embeddings.LayerNorm.bias": np.zeros(E, np.float32)}
    p = "transformer.layer.0."
    for name, (o, i) in {"attention.q_lin": (E, E), "attention.k_lin": (E, E),
                         "attention.v_lin": (E, E),
                         "attention.out_lin": (E, E),
                         "ffn.lin1": (FF, E), "ffn.lin2": (E, FF)}.items():
        sd[p + name + ".weight"] = _w(rng, o, i)
        sd[p + name + ".bias"] = np.zeros(o, np.float32)
    for name in ("sa_layer_norm", "output_layer_norm"):
        sd[p + name + ".weight"] = np.ones(E, np.float32)
        sd[p + name + ".bias"] = np.zeros(E, np.float32)
    return {prefix + k: v for k, v in sd.items()}


def bert_sd(prefix: str) -> dict:
    """A 1-layer BERT-named state dict under a backbone prefix."""
    rng = np.random.default_rng(1)
    sd = {"embeddings.word_embeddings.weight": _w(rng, VOCAB, E),
          "embeddings.position_embeddings.weight": _w(rng, POS, E),
          "embeddings.token_type_embeddings.weight": _w(rng, 1, E),
          "embeddings.LayerNorm.weight": np.ones(E, np.float32),
          "embeddings.LayerNorm.bias": np.zeros(E, np.float32)}
    p = "encoder.layer.0."
    for name, (o, i) in {"attention.self.query": (E, E),
                         "attention.self.key": (E, E),
                         "attention.self.value": (E, E),
                         "attention.output.dense": (E, E),
                         "intermediate.dense": (FF, E),
                         "output.dense": (E, FF)}.items():
        sd[p + name + ".weight"] = _w(rng, o, i)
        sd[p + name + ".bias"] = np.zeros(o, np.float32)
    for name in ("attention.output.LayerNorm", "output.LayerNorm"):
        sd[p + name + ".weight"] = np.ones(E, np.float32)
        sd[p + name + ".bias"] = np.zeros(E, np.float32)
    return {prefix + k: v for k, v in sd.items()}


def assert_same_tree(port, ref):
    """The port's tree equals the JAX package's leaf for leaf (keys,
    shapes and values; a quantized leaf's codes, scales, mins and
    layout)."""
    if hasattr(ref, "codes"):
        assert (port.kind, port.block_axis, port.packed) == (
            ref.kind, ref.block_axis, ref.packed)
        for part in ("codes", "scales", "mins"):
            if getattr(ref, part) is None:
                assert getattr(port, part) is None
            else:
                assert_same_tree(getattr(port, part), getattr(ref, part))
        return
    if isinstance(ref, dict):
        assert isinstance(port, dict) and set(port) == set(ref), \
            (sorted(port), sorted(ref))
        for k in ref:
            assert_same_tree(port[k], ref[k])
        return
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_array_equal(port, np.asarray(ref))


@pytest.mark.parametrize("prefix", ["", "distilbert."])
def test_distilbert_tree_is_refused_by_name(prefix):
    """Refused by name before DistilBERT was mapped; now the same dict
    maps to the JAX package's tree (a zeros token-type row included)."""
    sd = distilbert_sd(prefix)
    tree = P.from_hf_state_dict(sd, BertConfig(**CFG))
    ref = JP.from_hf_state_dict(sd, JaxConfig(**CFG))
    assert tree["layers"]["attn"]["q"]["w"].shape == (1, E, E)
    assert_same_tree(tree, ref)
    np.testing.assert_array_equal(
        tree["embeddings"]["token_type"].numpy(), np.zeros((1, E)))


@pytest.mark.parametrize("prefix,family", [("roberta.", "RoBERTa"),
                                           ("albert.", "ALBERT"),
                                           ("roformer.", "RoFormer")])
def test_prefixed_trees_are_refused_by_name(prefix, family):
    """Refused by name before these prefixes were mapped; now each maps
    to the JAX package's tree, and to the ``bert.`` tree of the same
    dict."""
    tree = P.from_hf_state_dict(bert_sd(prefix), BertConfig(**CFG))
    assert_same_tree(tree, JP.from_hf_state_dict(bert_sd(prefix),
                                                 JaxConfig(**CFG)))
    bert = P.from_hf_state_dict(bert_sd("bert."), BertConfig(**CFG))
    assert_same_tree(tree, P.map_tree(lambda t: t.numpy(), bert))


_ROPE_JIT = jax.jit(jrot.rope_tables, static_argnums=(1, 2))


@pytest.mark.parametrize("dim", [64, 128])
@pytest.mark.parametrize("theta", [1e4, 1.6e5, 1e6])
def test_rope_tables_match_jax_at_long_positions(theta, dim):
    pos = np.arange(8192, dtype=np.int32)
    got = trot.rope_tables(torch.from_numpy(pos), dim, theta)
    for ref in (jrot.rope_tables(jnp.asarray(pos), dim, theta),
                _ROPE_JIT(jnp.asarray(pos), dim, theta)):
        for g, r in zip(got, ref):
            assert g.dtype == torch.float32 and g.shape == (8192, dim // 2)
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                       atol=2.4e-7)
