"""query_p95_ms: the nearest-rank 95th percentile, in ms, of every query
due in the window, each from its due time to its result in the client's
hands; a refused or failed query counts as its wait until the drain's end.
Host clock; open-loop cells."""
import math


def read(r):
    if r.loop != "open" or not r.queries:
        return None
    lat = sorted(q["latency"] for q in r.queries)
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)] * 1e3
