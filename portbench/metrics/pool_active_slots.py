"""Active slots a decode-pool chunk carries: the pool's occupancy read
through the window, each reading weighted by the chunks run since the one
before. Layer: the decode pool."""


def read(run: dict):
    samples = run["pool_samples"]
    weighted = chunks = 0
    for (d0, _), (d1, active) in zip(samples, samples[1:]):
        weighted += (d1 - d0) * active
        chunks += d1 - d0
    return weighted / chunks if chunks else None
