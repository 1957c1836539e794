"""The plain reference of a pre-norm decoder (RMSNorm, split-half RoPE,
grouped-query attention, SwiGLU, untied output head), as Mistral-7B and
DeepSeek-LLM-7B describe it: plain PyTorch in float32 with TF32 off, no
kernel, cache or batching of the program. It imports nothing of the
program. The weights come from ``portbench/weights.py`` again, group by
group from the seed, so what the program holds is never read.

``logits_at`` is the served model's forward. ``train_steps`` follows the
first training steps: next-token cross-entropy, its gradients (each layer
recomputed in the backward), clipping by the global norm and AdamW
(optax's arithmetic), with the parameters of a later step worked out from
the seed's weights and the earlier steps' gradients, so that the state in
memory is the gradients alone.

``weights="fp8"`` is the control: every weight rounded to float8 e4m3 with
one scale an output channel (a row of the embedding) where it is used, the
next precision below the served bfloat16, and the rest unchanged.
"""

from __future__ import annotations

import contextlib
import math

import torch

from portbench.weights import draw_group

_E4M3_MAX = 448.0
NORMS = ("attn_norm", "mlp_norm")


def _fp8(w: torch.Tensor, axis: int) -> torch.Tensor:
    """``w`` rounded through float8 e4m3, scaled by its absolute maximum
    over ``axis`` (so one scale per column of an [in, out] weight)."""
    scale = w.abs().amax(dim=axis, keepdim=True).clamp_min(1e-12) / _E4M3_MAX
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def _rounded(w: dict, mode: str) -> dict:
    if mode != "fp8":
        return w
    return {k: (v if k in NORMS or k == "norm_f" else _fp8(v, 1 if k == "embed" else 0))
            for k, v in w.items()}


@contextlib.contextmanager
def _full_f32():
    """float32 products in float32 (TF32 off), restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _rms(x: torch.Tensor, w: "torch.Tensor | None", eps: float) -> torch.Tensor:
    y = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)
    return y if w is None else y * w


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Split-half rotation of x [S, H, D] by per-position cos/sin [S, D/2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _trig(m: dict, n: int, device) -> tuple:
    hd = m["dim"] // m["n_heads"]
    inv = 1.0 / (m["rope_theta"] ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                                   device=device) / hd))
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv[None]
    return ang.cos().float(), ang.sin().float()


def _attention(q, k, v, rows: int) -> torch.Tensor:
    """Causal softmax attention of q [S, Hq, D] over k, v [S, Hkv, D], in
    blocks of ``rows`` queries."""
    s, hq, d = q.shape
    groups = hq // k.shape[1]
    kh = k.repeat_interleave(groups, dim=1).transpose(0, 1)  # [Hq, S, D]
    vh = v.repeat_interleave(groups, dim=1).transpose(0, 1)
    pos = torch.arange(s, device=q.device)
    outs = []
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        qb = q[r0:r1].transpose(0, 1)  # [Hq, r, D]
        scores = qb @ kh[:, :r1].transpose(1, 2) / math.sqrt(d)  # [Hq, r, r1]
        mask = pos[None, :r1] > pos[r0:r1, None]
        scores = scores.masked_fill(mask[None], float("-inf"))
        outs.append((torch.softmax(scores, dim=-1) @ vh[:, :r1]).transpose(0, 1))
    return torch.cat(outs, dim=0)


def block(m: dict, h: torch.Tensor, w: dict, trig: tuple, rows: int = 1024) -> torch.Tensor:
    """One layer over one sequence h [S, D] -> its output [S, D]. ``w``
    holds the layer's weights and, when trained, its norms."""
    hd, eps, n = m["dim"] // m["n_heads"], m["norm_eps"], h.shape[0]
    x = _rms(h, w.get("attn_norm"), eps)
    q = (x @ w["wq"]).view(n, m["n_heads"], hd)
    k = (x @ w["wk"]).view(n, m["n_kv_heads"], hd)
    v = (x @ w["wv"]).view(n, m["n_kv_heads"], hd)
    cos, sin = trig[0][:n], trig[1][:n]
    h = h + _attention(_rope(q, cos, sin), _rope(k, cos, sin), v, rows).reshape(n, -1) @ w["wo"]
    x = _rms(h, w.get("mlp_norm"), eps)
    return h + (torch.nn.functional.silu(x @ w["w_gate"]) * (x @ w["w_up"])) @ w["w_down"]


@torch.no_grad()
def logits_at(m: dict, seed: int, seqs: list, wanted: list, device,
              weights: str = "exact", rows: int = 1024) -> list:
    """For each token sequence (a list of ids), float32 logits [n, V] at
    its positions ``wanted`` (a list of ints), from a full causal forward
    of the served model (norms at one)."""
    with _full_f32():
        embed = _rounded(draw_group(m, seed, 0, "embed", device), weights)["embed"]
        hs = [embed[torch.as_tensor(s, device=device).long()] for s in seqs]
        del embed
        trig = _trig(m, max(len(s) for s in seqs), device)
        for layer in range(m["n_layers"]):
            w = _rounded(draw_group(m, seed, 2 + layer, "layer", device), weights)
            hs = [block(m, h, w, trig, rows) for h in hs]
            del w
        head = _rounded(draw_group(m, seed, 1, "head", device), weights)["lm_head"]
        return [_rms(h[torch.as_tensor(p, device=device)], None, m["norm_eps"]) @ head
                for h, p in zip(hs, wanted)]


# -- training --------------------------------------------------------------


def _initial(m: dict, seed: int, group: str, index: int, device) -> dict:
    """A group's step-0 values: the seed's weights, norms at one."""
    kind = "embed" if group == "embed" else "head" if group == "head" else "layer"
    w = draw_group(m, seed, index, kind, device)
    if kind == "layer":
        w.update({n: torch.ones(m["dim"], device=device) for n in NORMS})
    elif kind == "head":
        w["norm_f"] = torch.ones(m["dim"], device=device)
    return w


class _State:
    """Parameters after ``len(grads)`` AdamW steps, worked out group by
    group from the seed and the kept (clipped) gradients."""

    def __init__(self, m: dict, seed: int, opt: dict, device):
        self.m, self.seed, self.opt, self.device = m, seed, opt, device
        self.grads: list = []  # one {leaf name: clipped float32 gradient} a step

    def group(self, group: str, index: int, steps: "int | None" = None) -> dict:
        """{leaf: value} of a group ("embed", "head" or "layer") after
        ``steps`` updates (default all kept)."""
        w = _initial(self.m, self.seed, group, index, self.device)
        prefix = "" if group != "layer" else f"layers.{index - 2}."
        o = self.opt
        for name in list(w):
            key = prefix + name
            p, mu, nu = w[name], None, None
            for t, g in enumerate(self.grads[:steps]):
                g = g[key]
                mu = (1 - o["b1"]) * g if mu is None else o["b1"] * mu + (1 - o["b1"]) * g
                nu = (1 - o["b2"]) * g * g if nu is None else o["b2"] * nu + (1 - o["b2"]) * g * g
                u = (mu / (1 - o["b1"] ** (t + 1))) / ((nu / (1 - o["b2"] ** (t + 1))).sqrt()
                                                       + o["eps"])
                p = p - o["lr"] * (u + o["wd"] * p)
            w[name] = p
        return w


def _loss_and_grads(m: dict, state: _State, tokens: torch.Tensor, mode: str,
                    rows: int) -> tuple:
    """Mean next-token cross-entropy of tokens [B, S+1] at the state's
    parameters, and {leaf: float32 gradient}; each layer is run again in
    the backward (only its input is kept)."""
    dev = state.device
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    b, s = inp.shape
    trig = _trig(m, s, dev)
    grads = {}
    with torch.no_grad():
        emb = _rounded(state.group("embed", 0), mode)["embed"]
        h = emb[inp]
        del emb
        kept = []
        for layer in range(m["n_layers"]):
            kept.append(h)
            w = _rounded(state.group("layer", 2 + layer), mode)
            h = torch.stack([block(m, h[r], w, trig, rows) for r in range(b)])
            del w
    head = {k: v.requires_grad_() for k, v in _rounded(state.group("head", 1), mode).items()}
    h = h.requires_grad_()
    logits = _rms(h, head["norm_f"], m["norm_eps"]) @ head["lm_head"]
    loss = torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                             tgt.reshape(-1))
    loss.backward()
    del logits
    grads["lm_head"], grads["norm_f"] = head["lm_head"].grad, head["norm_f"].grad
    dh = h.grad
    for layer in reversed(range(m["n_layers"])):
        w = {k: v.requires_grad_() for k, v in
             _rounded(state.group("layer", 2 + layer), mode).items()}
        x = kept[layer].requires_grad_()
        out = torch.stack([block(m, x[r], w, trig, rows) for r in range(b)])
        out.backward(dh)
        for k, v in w.items():
            grads[f"layers.{layer}.{k}"] = v.grad
        dh = x.grad
        kept[layer] = None
        del w, out, x
    g_embed = torch.zeros(m["vocab_size"], m["dim"], device=dev)
    g_embed.index_add_(0, inp.reshape(-1), dh.reshape(-1, m["dim"]))
    grads["embed"] = g_embed
    return float(loss.detach()), grads


def train_steps(m: dict, seed: int, batches: list, opt: dict, device, weights: str = "exact",
                rows: int = 1024) -> dict:
    """Follow ``len(batches)`` steps from the seed's weights. -> {"loss":
    each step's, "grad_norm": {leaf: norm of the first clipped gradient},
    "change": {leaf: norm of the parameters' change after the last step}}.
    ``opt``: lr, b1, b2, eps, wd and clip (the global norm's limit)."""
    state = _State(m, seed, opt, device)
    losses = []
    with _full_f32():
        for tokens in batches:
            loss, grads = _loss_and_grads(m, state, torch.as_tensor(tokens, device=device),
                                          weights, rows)
            norm = math.sqrt(sum(float(g.double().pow(2).sum()) for g in grads.values()))
            if norm >= opt["clip"]:  # optax's rule: no epsilon
                for g in grads.values():
                    g.mul_(opt["clip"] / norm)
            state.grads.append(grads)
            losses.append(loss)
        out = {"loss": losses, "grad_norm": {k: float(g.norm()) for k, g in state.grads[0].items()}}
        change = {}
        groups = [("embed", 0), ("head", 1)] + [("layer", 2 + i) for i in range(m["n_layers"])]
        for group, index in groups:
            before = state.group(group, index, steps=0)
            after = state.group(group, index)
            prefix = "" if group != "layer" else f"layers.{index - 2}."
            for name in after:
                change[prefix + name] = float((after[name] - before[name]).norm())
        out["change"] = change
    return out
