"""The tiny sizes of the DeepSeek-V2 reference for the benchmark's CPU
tests: ``tests/conftest.py``'s ``make_tiny_root`` cuts every configuration
by its reference's entry of ``TINY``, and this adds ``deepseek_v2``'s
before any test runs. Every width is cut; the vocabulary is kept, since
the specials (bos 100000, eos 100001) are its last rows."""

TINY_DEEPSEEK_V2 = dict(
    hidden_size=64, num_attention_heads=4, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32, n_routed_experts=8,
    num_experts_per_tok=3, n_shared_experts=1, moe_intermediate_size=32,
    intermediate_size=96, num_hidden_layers=3)


def pytest_configure(config):
    from perfbench.tests import conftest
    conftest.TINY.setdefault("deepseek_v2", TINY_DEEPSEEK_V2)
