"""dsv2.device.mfu: the whole step's share of the chip's bf16 peak in the
DeepSeek-V2 cell: the operations the model needs for the real tokens of
the traced stretch's forwards (``costs_deepseek_v2.model_flops``: MLA's
projections and causal pairs, the dense and MoE FFNs) over the stretch's
length times 989 TFLOP/s."""

from perfbench import costs, costs_deepseek_v2


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["forwards"] or "kv_lora_rank" not in rec["widths"]:
        return None
    flops = costs_deepseek_v2.model_flops(
        [n for f in tr["forwards"] for n in f["lengths"]], rec["widths"])
    return 100.0 * flops / (tr["window_s"] * costs.PEAK_BF16_FLOPS)
