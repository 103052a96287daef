"""kernels.attention_roofline: the attention kernel's share of its
roofline: the sum of each launch's bound time (``costs.attention_cost``:
the (query, key) pairs within each sequence or packed segment of its
forward, each operand's real rows once) over the sum of the device times
of ``attn_sm90_kernel`` in the traced stretch."""

from perfbench import costs
from perfbench.readers import ATTENTION, kernel_ms


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    ms = kernel_ms(tr, ATTENTION)
    E = rec["widths"]["hidden_size"]
    bound = 0.0
    for f in tr["forwards"]:
        cost = costs.attention_cost(f["lengths"], E, f["B"] * f["L"],
                                    f["packed"])
        bound += f["attention"] * costs.bound_ms(*cost)[0]
    if not ms or not bound:
        return None
    return 100.0 * bound / ms
