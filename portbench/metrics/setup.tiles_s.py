"""setup.tiles_s: the seconds the port's session spent building its ELL
tiles (`GraphSession.runtime_stats()["tiles_s"]`). Every cell."""


def read(r):
    return r.runtime.get("tiles_s")
