"""The decode flash forward's share of its roofline: the least time of the
decode steps the program ran inside the traced window (one query row over
the cache it has; bound by bytes: K/V read once, q and out once; placed in
time by each token's arrival, ``readings.window_calls``) over the device
time of the ``flash_fwd_decode`` kernels, in %. Layer: the kernels."""

from portbench.readings import attention_share, window_calls


def read(run: dict):
    if run.get("trace") is None:
        return None
    return attention_share(run, window_calls(run)[1], ("flash_fwd_decode",))
