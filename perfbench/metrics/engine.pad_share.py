"""engine.pad_share: 1 - real tokens / device token slots over the traced
stretch's Engine forwards: the slots are each forward's ids shape
(B x L), the real tokens its sequences' (or packed segments') lengths."""


def read(rec):
    fw = (rec["trace"] or {}).get("forwards")
    if not fw:
        return None
    slots = sum(f["B"] * f["L"] for f in fw)
    real = sum(sum(f["lengths"]) for f in fw)
    return 100.0 * (1.0 - real / slots)
