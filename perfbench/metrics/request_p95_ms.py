"""request_p95_ms: the 95th percentile (nearest rank) of the latency of
every call completed in the window, from the call into the Engine to the
return of its host array (host clock)."""

import math


def read(rec):
    lat = sorted(rec["latencies_s"])
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
