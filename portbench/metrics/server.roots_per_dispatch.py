"""server.roots_per_dispatch: roots the server searched over the
dispatches it made, both counted by `BFSServer.stats()` across the window
(its queries served to the last). Open-loop cells."""


def read(r):
    batches = r.server.get("batches", 0)
    if r.loop != "open" or batches <= 0:
        return None
    return r.server["roots"] / batches
