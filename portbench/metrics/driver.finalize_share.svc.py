"""driver.finalize_share.svc: the level driver's `agg_s` summed over the
`LevelDriver.run` spans that start in the window, as a share of the
summed wall of the server's dispatches that start in it. Open-loop
cells."""


def read(r):
    wall = sum(d["t1"] - d["t0"] for d in r.dispatches)
    if r.loop != "open" or not r.driver_runs or wall <= 0:
        return None
    return 100.0 * sum(d["agg_s"] for d in r.driver_runs) / wall
