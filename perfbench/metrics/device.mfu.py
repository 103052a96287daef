"""device.mfu: the whole step's share of the chip's bf16 peak: the
operations the model needs for the real tokens of the traced stretch's
forwards (``costs.model_flops``) over the stretch's length times
989 TFLOP/s."""

from perfbench import costs


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["forwards"]:
        return None
    flops = costs.model_flops(
        [n for f in tr["forwards"] for n in f["lengths"]], rec["widths"])
    return 100.0 * flops / (tr["window_s"] * costs.PEAK_BF16_FLOPS)
