"""setup.fingerprint_s: the seconds the port's session spent hashing the
graph (`GraphSession.runtime_stats()["fingerprint_s"]`). Every cell."""


def read(r):
    return r.runtime.get("fingerprint_s")
