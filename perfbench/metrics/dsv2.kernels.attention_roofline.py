"""dsv2.kernels.attention_roofline: the MLA attention kernel's share of
its roofline: the sum of each launch's bound time
(``costs_deepseek_v2.mla_attention_cost``: the causal pairs of each
sequence's own tokens over 16 heads at 192 + 128 wide, each operand's real
rows once) over the sum of the device times of ``attn_sm90_kernel`` in
the traced stretch. Every layer of a forward launches the kernel once
where its row length is a multiple of 128 (the kernel's shapes, which
every bucket of the cell's Engine is)."""

from perfbench import costs, costs_deepseek_v2
from perfbench.readers import ATTENTION, kernel_ms


def read(rec):
    tr = rec["trace"]
    w = rec["widths"]
    if not tr or "kv_lora_rank" not in w:
        return None
    ms = kernel_ms(tr, ATTENTION)
    bound = 0.0
    for f in tr["forwards"]:
        if f["packed"] or f["L"] % 128:
            continue
        cost = costs_deepseek_v2.mla_attention_cost(f["lengths"], f["B"], w)
        bound += w["num_hidden_layers"] * costs.bound_ms(*cost)[0]
    if not ms or not bound:
        return None
    return 100.0 * bound / ms
