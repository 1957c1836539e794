"""The yardstick's arithmetic: the card's published peaks, the operations
and bytes a decoder's work needs, and the least time of an attention call.

Frozen here from the port's own sources so a later change to the program
cannot move it: the peaks are NVIDIA's data sheet for the H100 SXM (dense
bf16, HBM3), as ``gofr_tpu_torch/tpu/flops.py`` has them; ``attention_bound``
is ``chip_smoke.py::bound`` (each input byte read once, each output byte
written once, K/V only up to what the call's lengths need, and 4·D
operations a visible (query, key) pair and head); the model term is the
usual 2 operations a matmul weight and token, forward."""

from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12  # dense, H100 SXM
PEAK_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM


def matmul_params(cfg: dict) -> int:
    """Weights that take part in a token's products: every layer's
    projections and the output head (the embedding is a lookup)."""
    d, hd = cfg["dim"], cfg["dim"] // cfg["n_heads"]
    kv = cfg["n_kv_heads"] * hd
    layer = d * (2 * d + 2 * kv) + 3 * d * cfg["hidden_dim"]
    return cfg["n_layers"] * layer + d * cfg["vocab_size"]


def causal_pairs(offset: int, rows: int) -> int:
    """Visible (query, key) pairs of ``rows`` queries at positions
    offset .. offset + rows - 1 over a causal cache that ends at each."""
    return rows * offset + rows * (rows + 1) // 2


def attention_bound_s(rows: int, offset: int, hq: int, hkv: int, d: int, es: int = 2) -> tuple:
    """Least time of one causal attention call of one layer and one
    sequence: ``rows`` queries from position ``offset`` over the keys up to
    each. -> (seconds, operations, bytes)."""
    kv_len = offset + rows
    flops = 4 * d * hq * causal_pairs(offset, rows)
    nbytes = 2 * rows * hq * d * es + 2 * kv_len * hkv * d * es + rows * hq * 4
    return max(flops / PEAK_FLOPS_BF16, nbytes / PEAK_BYTES_PER_S), flops, nbytes


def prefill_calls(length: int, start: int, width: int) -> list:
    """(rows, offset) of each prefill call a prompt's positions start ..
    length - 1 take, in slices of ``width`` (one call when it fits)."""
    calls, at = [], start
    while at < length:
        rows = min(width, length - at)
        calls.append((rows, at))
        at += rows
    return calls


def forward_flops(cfg: dict, rows: int, offset: int) -> float:
    """Operations of a forward over ``rows`` new positions from ``offset``:
    the products and the causal attention over the cache, all layers."""
    hd = cfg["dim"] // cfg["n_heads"]
    attn = 4 * hd * cfg["n_heads"] * causal_pairs(offset, rows) * cfg["n_layers"]
    return 2.0 * matmul_params(cfg) * rows + attn


def train_flops(cfg: dict, batch: int, seq: int) -> float:
    """A training step's operations, recomputation left out: 6·N·T for the
    products, and 3x the causal attention forward (12·L·H·D a pair)."""
    hd = cfg["dim"] // cfg["n_heads"]
    pairs = batch * causal_pairs(0, seq)
    attn = 12.0 * cfg["n_layers"] * cfg["n_heads"] * hd * pairs
    return 6.0 * matmul_params(cfg) * batch * seq + attn

