"""The whole step's share of the card's peak: the operations of every
prefill slice and decode step the program ran inside the traced window
(products and causal attention, from each request's lengths, placed in
time by its token arrivals; ``readings.window_calls``) over the traced
window at 989 TFLOP/s bf16, in %. Layer: the model step. Read for any
serving cell (``mfu.<cell>``)."""

from portbench.readings import step_mfu


def read(run: dict):
    return step_mfu(run)
