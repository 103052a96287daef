"""tokens_per_s: real input tokens (no padding) of every call completed
in the window, over the window's seconds (host clock)."""


def read(rec):
    if not rec["tokens"]:
        return None
    return sum(rec["tokens"]) / rec["window_s"]
