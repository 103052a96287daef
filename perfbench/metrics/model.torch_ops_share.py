"""model.torch_ops_share: device time of every operation that is not one
of the port's hand-written kernels (the library's kernels, copies and
fills), over the device's busy time in the traced stretch."""

from perfbench.readers import HANDWRITTEN, op_ms


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["busy_s"]:
        return None
    other = [o for o in tr["device_ops"]
             if not any(k in o["name"] for k in HANDWRITTEN)]
    return 100.0 * op_ms(other) / 1e3 / tr["busy_s"]
