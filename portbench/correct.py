"""What decides ``correct`` for a served model: once the window has closed
and the program is freed, a sample of the requests it finished, drawn from
the seed with the longest prompt in it, is run once through the plain
reference over each prompt and its served tokens. Two numbers are taken
over every served token of the sample:

- ``token_gap``: the widest gap by which a served token's logit lies below
  the reference's best at its position (0 where the program chose the
  reference's argmax);
- ``logprob_err``: the widest gap between the logprob the API returned for
  a served token and the reference's log-softmax of it;
- ``logprob_err_mean``: that gap's mean over every served token of the
  sample. It is steady from seed to seed where the widest gaps swing, and
  it separates the program's own float8 KV cache from its sound path.

Each has its limit in ``limits/<cell>.json``, set from sound runs of the
program and from the controls: the reference in float8 weights (the
``control_`` readings) and the program served with its own
lower-precision path (the file's ``program_control`` keys)."""

from __future__ import annotations

import json
from pathlib import Path

import torch

from portbench import draw, spec


def sample(records: list, seed: int, min_tokens: int) -> list:
    """The longest-prompt request, then others in a seeded order until
    the sample holds ``min_tokens`` served tokens."""
    done = sorted((r for r in records if r["status"] == "ok" and r["tokens"]),
                  key=lambda r: r["i"])
    if not done:
        return []
    longest = max(done, key=lambda r: (r["prompt_len"], -r["i"]))
    rest = [r for r in done if r is not longest]
    order = draw.rng(seed, 7).permutation(len(rest))
    picked, tokens = [longest], len(longest["tokens"])
    for j in order:
        if tokens >= min_tokens:
            break
        picked.append(rest[int(j)])
        tokens += len(rest[int(j)]["tokens"])
    return picked


def _inputs(picked: list, prompts: dict) -> tuple:
    seqs, wanted = [], []
    for r in picked:
        p = prompts[r["i"]]
        seqs.append(p + r["tokens"][:-1])
        wanted.append(list(range(len(p) - 1, len(p) - 1 + len(r["tokens"]))))
    return seqs, wanted


def readings(cell: "spec.Cell", m: dict, seed: int, picked: list, prompts: dict,
             device: torch.device, control: bool = False) -> dict:
    """``token_gap`` and ``logprob_err`` of the program's served tokens;
    with ``control``, the same two read from the float8 reference."""
    ref_mod = spec.reference(cell.config["reference"], cell.root)
    seqs, wanted = _inputs(picked, prompts)
    ref = ref_mod.logits_at(m, seed, seqs, wanted, device)
    ctl = ref_mod.logits_at(m, seed, seqs, wanted, device, weights="fp8") if control else None
    out = {"token_gap": 0.0, "logprob_err": 0.0, "tokens": 0}
    if control:
        out.update(control_token_gap=0.0, control_logprob_err=0.0)
    err_sum = 0.0
    for k, r in enumerate(picked):
        toks = torch.as_tensor(r["tokens"], device=device).long()
        logits = ref[k]
        best = logits.max(dim=-1).values
        chosen = logits.gather(1, toks[:, None])[:, 0]
        lsm = torch.log_softmax(logits, dim=-1).gather(1, toks[:, None])[:, 0]
        served = torch.as_tensor([float("nan") if x is None else x for x in r["lps"]],
                                 device=device, dtype=torch.float32)
        out["token_gap"] = max(out["token_gap"], float((best - chosen).max()))
        err = (served - lsm).abs()
        out["logprob_err"] = max(out["logprob_err"],
                                 float("inf") if bool(err.isnan().any()) else float(err.max()))
        out["tokens"] += len(r["tokens"])
        err_sum += float(err.sum())
        if control:
            c = ctl[k]
            top = c.argmax(dim=-1)
            gap = best - logits.gather(1, top[:, None])[:, 0]
            c_lsm = torch.log_softmax(c, dim=-1).gather(1, toks[:, None])[:, 0]
            out["control_token_gap"] = max(out["control_token_gap"], float(gap.max()))
            out["control_logprob_err"] = max(out["control_logprob_err"],
                                             float((c_lsm - lsm).abs().max()))
    out["logprob_err_mean"] = err_sum / max(out["tokens"], 1)
    return out


def _limits_file(cell: "spec.Cell") -> dict:
    path = Path(cell.root) / spec.HERE.name / "limits" / f"{cell.name}.json"
    return json.loads(path.read_text())


def limits(cell: "spec.Cell") -> dict:
    """The cell's limits: ``limits/<cell>.json`` ({number: limit})."""
    return _limits_file(cell)["limits"]


def program_control(cell: "spec.Cell") -> dict:
    """The serving keys that switch on the program's own lower-precision
    path (``program_control`` in the limits file; none: {})."""
    return _limits_file(cell).get("program_control", {})


def verdict(found: dict, lims: dict) -> tuple:
    """(correct, {number: {"value", "limit"}}): every number within its limit."""
    checked = {k: {"value": found.get(k, float("inf")), "limit": v} for k, v in lims.items()}
    return all(c["value"] <= c["limit"] for c in checked.values()), checked
