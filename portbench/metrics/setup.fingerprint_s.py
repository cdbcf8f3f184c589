"""setup.fingerprint_s: the seconds the port's session spent hashing the
graph (`GraphSession.runtime_stats()["fingerprint_s"]`). Every cell of
one chip; None where the session never hashed it (it reads 0.0 then),
as rank 0's on the partitioned path."""


def read(r):
    return r.runtime.get("fingerprint_s") or None
