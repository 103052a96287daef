"""device.idle_share: 1 - the union of the device's operation intervals
over the traced stretch's length."""


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
