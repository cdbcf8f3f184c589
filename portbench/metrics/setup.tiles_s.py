"""setup.tiles_s: the seconds the port's session spent building its ELL
tiles (`GraphSession.runtime_stats()["tiles_s"]`). Every cell of one
chip; None where the session built no tiles (it reads 0.0 then), as
rank 0's on the partitioned path, which builds its partitions instead."""


def read(r):
    return r.runtime.get("tiles_s") or None
