"""driver.finalize_share.g500: the level driver's `agg_s` (the result's
copy to the host and its mapping, `core.bfs.finalize`) summed over the
window's `LevelDriver.run` spans, as a share of the summed wall of the
window's queries. Closed-loop cells."""


def read(r):
    wall = sum(s["t1"] - s["t0"] for s in r.searches)
    if r.loop != "closed" or not r.driver_runs or wall <= 0:
        return None
    return 100.0 * sum(d["agg_s"] for d in r.driver_runs) / wall
