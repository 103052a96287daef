"""kernels.qmatmul_roofline: K1's share of its roofline: the sum of each
launch's bound time (``costs.k1_cost`` at the M of its forward and its
(K, N, epilogue): the larger of its operations at the bf16 peak and its
bytes at the HBM peak) over the sum of the device times of
``qmm_wgmma_kernel`` in the traced stretch."""

from perfbench import costs
from perfbench.readers import K1, kernel_ms


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    ms = kernel_ms(tr, K1)
    bound = 0.0
    for f in tr["forwards"]:
        for (K, N, epi), n in f["k1"].items():
            bound += n * costs.bound_ms(
                *costs.k1_cost(f["B"] * f["L"], K, N, epi))[0]
    if not ms or not bound:
        return None
    return 100.0 * bound / ms
