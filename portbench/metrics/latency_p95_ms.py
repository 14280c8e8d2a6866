"""The 95th percentile (nearest rank) over every request of the window of
the time from its scheduled send to the last byte of its response, in ms.
A failed, refused or unfinished request counts as infinitely late; where
more than 5 % are, there is no finite percentile and nothing is read.
Host clock (the load generator's, in its own process)."""

import math


def read(run):
    lat = run.get("latencies_ms")
    if not lat:
        return None
    v = sorted(lat)[max(0, math.ceil(0.95 * len(lat)) - 1)]
    return v if math.isfinite(v) else None
