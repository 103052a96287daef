"""The yardstick's arithmetic against the bounds the repository's
kernel table reports (K1 at bge's shapes, M = 128 x 256) and against
sums worked by hand."""

import pytest

from perfbench import costs

M = 128 * 256


@pytest.mark.parametrize("K, N, epi, ms, by", [
    (768, 2304, "bias", 0.1173, "operations"),
    (768, 768, "bias_residual_ln", 0.0452, "bytes"),
    (768, 3072, "bias_gelu", 0.1563, "operations"),
    (3072, 768, "bias_residual_ln", 0.1563, "operations"),
])
def test_k1_bounds_of_the_kernel_table(K, N, epi, ms, by):
    got, bound_by = costs.bound_ms(*costs.k1_cost(M, K, N, epi))
    assert round(got, 4) == ms and bound_by == by


def test_attention_cost_counts_pairs_within_sequences():
    flops, nbytes = costs.attention_cost([3, 5], 8, slots=16,
                                         segmented=False)
    assert flops == 4 * 8 * (9 + 25)
    assert nbytes == 8 * 4 * 8 * 2 + 4 * 2
    _, packed = costs.attention_cost([3, 5], 8, slots=16, segmented=True)
    assert packed == 8 * 4 * 8 * 2 + 4 * 16


def test_model_flops_by_hand():
    w = {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 2}
    dense = 2 * (3 * 16 + 16 + 2 * 4 * 8)
    assert costs.model_flops([3], w) == 3 * 2 * dense + 2 * 4 * 4 * 9
    moe = dict(w, num_experts=4, moe_top_k=2)
    routed = 2 * (3 * 16 + 16 + 4 * 4 + 2 * 2 * 4 * 8)
    assert costs.model_flops([3], moe) == \
        3 * (dense + routed) + 2 * 4 * 4 * 9
