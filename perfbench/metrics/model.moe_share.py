"""model.moe_share: device time of the operations launched under the
port's MoE spans (``moe_dispatch``, ``moe_expert_gemm``,
``moe_expert_ops``), over the device's busy time in the traced stretch;
nothing to read where no MoE layer ran."""

from perfbench.readers import op_ms

MOE_SPANS = ("moe_dispatch", "moe_expert_gemm", "moe_expert_ops")


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["busy_s"]:
        return None
    moe = [o for o in tr["device_ops"] if o["span"] in MOE_SPANS]
    if not moe:
        return None
    return 100.0 * op_ms(moe) / 1e3 / tr["busy_s"]
