"""gteps: Graph500 edges of every search completed in the window over
the window's seconds (its start to the last completion), in 1e9 a
second. Host clock; closed-loop cells."""


def read(r):
    if r.loop != "closed" or not r.searches:
        return None
    edges = sum(s["edges"] for s in r.searches if s["ok"])
    return edges / (r.close - r.start) / 1e9
