"""Wall time of a decode-pool chunk: the window's length over the
window's chunks (the pool's ``dispatches``), in ms. Layer: the decode
pool."""

from portbench.readings import delta


def read(run: dict):
    if "pool_dispatches" not in run["counters"]["end"]:
        return None
    chunks = delta(run, "pool_dispatches")
    return 1e3 * run["window_s"] / chunks if chunks > 0 else None
