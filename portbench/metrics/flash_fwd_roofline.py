"""The sm90 flash forward's share of its roofline: the least time of the
prefill slices the program ran inside the traced window (each the larger
of operations over peak and bytes over bandwidth; placed in time by
``readings.window_calls``) over the device time of the ``flash_fwd_sm90``
kernels, in %. Layer: the kernels."""

from portbench.readings import attention_share, window_calls


def read(run: dict):
    if run.get("trace") is None:
        return None
    return attention_share(run, window_calls(run)[0], ("flash_fwd_sm90_kernel",))
