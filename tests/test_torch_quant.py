"""The port's quantization codecs and group-64 packing against the JAX
package: the numpy codecs give bit-identical codes and scales, the packed
layout is byte-identical, and the torch ``dequantize`` / ``gather_rows``
match the JAX ones (f32, same arithmetic: exact up to f32 rounding of the
same products, 1e-7 relative)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from embeddings_tpu.ops import quant as jq
from embeddings_tpu.models import params as JP

from embeddings_tpu_torch.config import BertConfig
from embeddings_tpu_torch.models import params as P
from embeddings_tpu_torch.ops import quant as tq

KINDS = ["q4_0", "q4_1", "q8_0", "nf4"]


def _weights(seed, shape=(2, 128, 96)):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.05)
    w[0, :32, 0] = 0.0  # an all-zero block: the d == 0 branch
    return w


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("block_axis", [-2, -1])
@pytest.mark.parametrize("pack4", [False, True])
def test_quantize_bit_identical(kind, block_axis, pack4):
    w = _weights(KINDS.index(kind))
    if block_axis == -1:
        w = np.swapaxes(w, -1, -2).copy()  # [.., V, E] with E % 64 == 0
        w = np.concatenate([w, w], -1)
    a = jq.quantize(w, kind, block_axis=block_axis, pack4=pack4)
    b = tq.quantize(w, kind, block_axis=block_axis, pack4=pack4)
    assert (a.kind, a.block_axis, a.packed) == (b.kind, b.block_axis,
                                                b.packed)
    np.testing.assert_array_equal(np.asarray(a.codes), b.codes.numpy())
    np.testing.assert_array_equal(np.asarray(a.scales), b.scales.numpy())
    if kind == "q4_1":
        np.testing.assert_array_equal(np.asarray(a.mins), b.mins.numpy())
    else:
        assert a.mins is None and b.mins is None
    ref = np.asarray(jq.dequantize(a))
    got = tq.dequantize(b).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-7, atol=0)


def test_pack_unpack_g64_identical():
    rng = np.random.default_rng(5)
    codes = rng.integers(-8, 8, (3, 128, 40)).astype(np.int8)
    packed = tq.pack_codes_g64(codes)
    np.testing.assert_array_equal(packed, jq.pack_codes_g64(codes))
    np.testing.assert_array_equal(tq.unpack_codes_g64(packed), codes)
    np.testing.assert_array_equal(
        tq._unpack_g64(torch.from_numpy(packed)).numpy(), codes)
    with pytest.raises(ValueError):
        tq.pack_codes_g64(codes[:, :96])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pack4", [False, True])
def test_gather_rows_matches_jax(kind, pack4):
    rng = np.random.default_rng(9)
    table = rng.standard_normal((50, 128), dtype=np.float32)
    ids = rng.integers(0, 50, (3, 7))
    a = jq.quantize(table, kind, block_axis=-1, pack4=pack4)
    b = tq.quantize(table, kind, block_axis=-1, pack4=pack4)
    ref = np.asarray(jq.gather_rows(a, jnp.asarray(ids)))
    got = tq.gather_rows(b, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-7, atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_params_pack_fuse_identical(kind, tiny_config):
    """params.quantize_params / pack_q4_params / fuse_qkv of the port give
    the JAX trees' exact codes on the same weights."""
    import dataclasses
    jcfg = dataclasses.replace(tiny_config, hidden_size=128,
                               num_attention_heads=2)
    jp = JP.init_params(jcfg, 0)
    ref = JP.fuse_qkv(JP.pack_q4_params(JP.quantize_params(jp, kind)))
    got = P.fuse_qkv(P.pack_q4_params(P.quantize_params(
        P.from_jax_params(jp), kind)))
    want = P.from_jax_params(ref)
    flat_got, flat_want = _flatten(got), _flatten(want)
    assert flat_got.keys() == flat_want.keys()
    for k in flat_want:
        assert flat_got[k].dtype == flat_want[k].dtype, k
        assert torch.equal(flat_got[k], flat_want[k]), k


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, tq.QuantizedTensor):
        out[prefix + ".codes"] = tree.codes
        out[prefix + ".scales"] = tree.scales
        if tree.mins is not None:
            out[prefix + ".mins"] = tree.mins
        return out
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


def test_init_params_layout(tiny_config):
    """The port's numpy init builds the JAX tree's layout and shapes."""
    cfg = BertConfig(**tiny_config.to_dict())
    got = _flatten(P.init_params(cfg, 0))
    want = _flatten(P.from_jax_params(JP.init_params(tiny_config, 0)))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and \
            got[k].dtype == want[k].dtype, k
    again = _flatten(P.init_params(cfg, 0))
    assert all(torch.equal(got[k], again[k]) for k in got)  # seeded
