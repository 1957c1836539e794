"""Prompt rows a prefill forward carries: the prompts sent in the window
over the window's prefill forwards (``_TransformerRunner.prefills``:
batcher batches, chunked slices and prefix tails). Layer: the prefill
batcher and scheduler."""

from portbench.readings import delta


def read(run: dict):
    t0, end = run["t0"], run["t0"] + run["window_s"]
    sent = sum(1 for r in run["records"] if r.get("sent") is not None and t0 <= r["sent"] < end)
    forwards = delta(run, "prefills")
    return sent / forwards if forwards > 0 else None
