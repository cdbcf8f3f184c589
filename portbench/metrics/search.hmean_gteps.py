"""search.hmean_gteps: Graph500's harmonic mean of per-query TEPS over
the window's completed queries (a query's Graph500 edges over its wall
on the benchmark's clock), in 1e9 a second. Closed-loop cells."""
import statistics


def read(r):
    teps = [s["edges"] / (s["t1"] - s["t0"]) for s in r.searches
            if s["ok"] and s["edges"] > 0]
    if r.loop != "closed" or not teps:
        return None
    return statistics.harmonic_mean(teps) / 1e9
