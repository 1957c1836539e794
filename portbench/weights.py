"""The cell's weights, made by the benchmark from the seed on the card:
the port's init scheme (a normal truncated to [-3, 3], times fan_in**-0.5,
norms at one) drawn group by group, one large draw a group (the embedding,
the output head, each layer), in float32 and rounded once to the type they
are served in. The same group is drawn again, bit for bit, from
(seed, group) alone: the reference regenerates each layer when it needs it,
and never reads what the program holds."""

from __future__ import annotations

import hashlib
import math

import torch

_TRUNC_LO = 0.5 * (1.0 + math.erf(-3.0 / math.sqrt(2.0)))
_TRUNC_HI = 0.5 * (1.0 + math.erf(3.0 / math.sqrt(2.0)))
LAYER = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def dims(config: dict) -> dict:
    """The decoder's sizes under the port's names, from a configuration
    file (its published keys)."""
    return {
        "vocab_size": int(config["vocab_size"]),
        "dim": int(config["hidden_size"]),
        "n_layers": int(config["num_hidden_layers"]),
        "n_heads": int(config["num_attention_heads"]),
        "n_kv_heads": int(config["num_key_value_heads"]),
        "hidden_dim": int(config["intermediate_size"]),
        "max_seq": int(config["max_position_embeddings"]),
        "rope_theta": float(config["rope_theta"]),
        "norm_eps": float(config["rms_norm_eps"]),
    }


def group_shapes(m: dict, group: str) -> list:
    """(name, [in, out] shape, fan_in) of each matmul weight of a group:
    "embed", "head" or "layer"."""
    d, hd = m["dim"], m["dim"] // m["n_heads"]
    kv = m["n_kv_heads"] * hd
    if group == "embed":
        return [("embed", (m["vocab_size"], d), d)]
    if group == "head":
        return [("lm_head", (d, m["vocab_size"]), d)]
    shapes = {"wq": (d, d), "wk": (d, kv), "wv": (d, kv), "wo": (d, d),
              "w_gate": (d, m["hidden_dim"]), "w_up": (d, m["hidden_dim"]),
              "w_down": (m["hidden_dim"], d)}
    return [(n, shapes[n], shapes[n][0]) for n in LAYER]


def group_seed(seed: int, group: int) -> int:
    """A 63-bit generator seed for (seed, group), any whole seed."""
    h = hashlib.blake2b(f"{int(seed)}:{group}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


def draw_group(m: dict, seed: int, index: int, group: str, device: torch.device) -> dict:
    """Group ``index`` (0 embed, 1 head, 2 + i layer i) in float32, each
    weight rounded through bfloat16 as the served weights are."""
    shapes = group_shapes(m, group)
    total = sum(math.prod(s) for _, s, _ in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(group_seed(seed, index))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.uniform_(2 * _TRUNC_LO - 1, 2 * _TRUNC_HI - 1, generator=gen)
    flat.erfinv_().mul_(math.sqrt(2.0)).clamp_(-3.0, 3.0)
    out, at = {}, 0
    for name, shape, fan_in in shapes:
        n = math.prod(shape)
        w = flat[at:at + n].view(shape).mul_(fan_in ** -0.5)
        out[name] = w.to(torch.bfloat16).float() if w.dtype != torch.bfloat16 else w
        at += n
    return out


def groups(m: dict) -> list:
    """(index, group kind, layer or None) in draw order."""
    return [(0, "embed", None), (1, "head", None)] + [
        (2 + i, "layer", i) for i in range(m["n_layers"])]


@torch.no_grad()
def fill(model: torch.nn.Module, m: dict, seed: int) -> None:
    """Fill a port ``Transformer``'s weights (built empty) from the seed;
    norms at one."""
    dev = model.embed.device
    for index, kind, layer in groups(m):
        for name, w in draw_group(m, seed, index, kind, dev).items():
            owner = model if layer is None else model.layers[layer]
            getattr(owner, name).copy_(w)
            del w
    for p in (model.norm_f, *(getattr(b, n) for b in model.layers
                              for n in ("attn_norm", "mlp_norm"))):
        p.fill_(1.0)
