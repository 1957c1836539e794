"""FLOPs accounting, MFU and MBU (port of ``gofr_tpu/tpu/flops.py``).

Inference MFU uses the ``2·N·tokens`` approximation (one multiply-add a
weight a token; attention products and norms ignored, so it is a floor,
never inflated); training MFU ``6·N·tokens``. MBU is bytes streamed over
elapsed time over the card's memory rate: decode streams every weight a
step, so MBU says how close decode runs to the memory roofline.

The peaks are NVIDIA's data-sheet figures, matched on
``torch.cuda.get_device_name()`` (first substring wins): an H100 SXM
(``NVIDIA H100 80GB HBM3``) does 989e12 dense bf16 FLOP/s and moves
3.35e12 B/s; its int8 tensor cores (``torch._int_mm``, the w8a8 product)
do twice the bf16 rate. A card the table does not know gets a nominal
default (``device_peaks`` labels it ``nominal``), and the CPU a nominal
100 GFLOP/s and 50 GB/s so the arithmetic never divides by zero in tests
(a CPU MFU is not a meaningful number).
"""

from __future__ import annotations

from typing import Any

import torch

# (device-name substring, dense bf16 FLOP/s, memory B/s), from NVIDIA's
# data sheet
_NVIDIA: tuple[tuple[str, float, float], ...] = (("h100", 989e12, 3.35e12),)
# an unknown card: H100 SXM figures, labelled nominal where they are shown
_GPU_DEFAULT = (989e12, 3.35e12)
_CPU_DEFAULT = (100e9, 50e9)


def device_peaks(device_kind: str, platform: str = "gpu") -> tuple[float, float, str]:
    """(peak bf16 FLOP/s, peak memory B/s, source) for the card named
    ``device_kind``: source ``table`` when a data-sheet row matched,
    ``nominal`` otherwise (and always on the CPU)."""
    if platform == "cpu":
        return _CPU_DEFAULT[0], _CPU_DEFAULT[1], "nominal"
    kind = (device_kind or "").lower()
    for needle, flops, bw in _NVIDIA:
        if needle in kind:
            return flops, bw, "table"
    return _GPU_DEFAULT[0], _GPU_DEFAULT[1], "nominal"


def device_peak_flops(device_kind: str, platform: str = "gpu", quant: str = "") -> float:
    """The card's dense bf16 peak; ``quant="w8a8"`` the int8 peak (twice
    bf16 on Hopper's tensor cores), since the w8a8 products run there. The
    one home of that factor: the serving gauge and the profiler agree."""
    flops, _, _ = device_peaks(device_kind, platform)
    if quant == "w8a8" and platform != "cpu":
        flops *= 2.0
    return flops


def device_peak_hbm_bw(device_kind: str, platform: str = "gpu") -> float:
    """The card's memory rate in B/s."""
    return device_peaks(device_kind, platform)[1]


def tree_bytes(tree: Any) -> int:
    """Bytes a step streams from memory: every tensor of a module (its
    parameters and persistent buffers, packs at their packed size: int4 is
    two values a byte in its buffer), a dict or a sequence of them. Each
    tensor counts once however often it is reachable."""
    seen: set = set()
    total = 0

    def add(t: torch.Tensor) -> None:
        nonlocal total
        key = (t.data_ptr(), t.numel(), t.dtype)
        if key in seen:
            return
        seen.add(key)
        total += t.numel() * t.element_size()

    def walk(node: Any) -> None:
        if isinstance(node, torch.Tensor):
            add(node)
        elif isinstance(node, torch.nn.Module):
            for t in node.state_dict(keep_vars=True).values():
                add(t)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(tree)
    return total


def mbu(bytes_streamed: float, seconds: float, peak_bw: float) -> float:
    """Fraction of the memory rate achieved streaming ``bytes_streamed``
    in ``seconds``."""
    if seconds <= 0 or peak_bw <= 0:
        return 0.0
    return bytes_streamed / seconds / peak_bw


def transformer_param_count(cfg: Any) -> int:
    """Parameters of ``models/transformer.py``'s layout: embed, lm_head,
    the final norm, and per layer ``wq``, ``wk``, ``wv``, ``wo``,
    ``w_gate``, ``w_up``, ``w_down`` and two norms (the logical count,
    whatever the packs store)."""
    d, f = cfg.dim, cfg.hidden_dim
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    per_layer = (
        d * d  # wq
        + 2 * d * kv_dim  # wk, wv
        + d * d  # wo
        + 3 * d * f  # w_gate, w_up, w_down
        + 2 * d  # attn_norm, mlp_norm
    )
    return cfg.vocab_size * d + d * cfg.vocab_size + d + cfg.n_layers * per_layer


def bert_param_count(cfg: Any) -> int:
    """Parameters of ``models/bert.py``'s layout: the token and position
    embeddings, the final norm, and per layer ``wqkv``, ``wo``,
    ``w_in``/``b_in``, ``w_out``/``b_out`` and two layer norms (weight and
    bias each)."""
    d, f = cfg.dim, cfg.hidden_dim
    per_layer = (
        d * 3 * d  # wqkv
        + d * d  # wo
        + d * f + f  # w_in, b_in
        + f * d + d  # w_out, b_out
        + 4 * d  # two layer norms
    )
    return cfg.vocab_size * d + cfg.max_seq * d + 2 * d + cfg.n_layers * per_layer


def mfu(n_params: int, tokens: float, seconds: float, peak: float) -> float:
    """Fraction of peak processing ``tokens`` in ``seconds``:
    2·N·tokens / seconds / peak."""
    if seconds <= 0 or peak <= 0:
        return 0.0
    return (2.0 * n_params * tokens) / seconds / peak


def mfu_from_flops(flops: float, seconds: float, peak: float) -> float:
    """MFU from a FLOP count (the cost model's analytic sheet, where one
    exists, in place of the 2·N·tokens floor)."""
    if seconds <= 0 or peak <= 0:
        return 0.0
    return flops / seconds / peak


def mbu_from_bytes(bytes_accessed: float, seconds: float, peak_bw: float) -> float:
    """MBU from a byte count (a cost sheet's), as :func:`mfu_from_flops`."""
    return mbu(bytes_accessed, seconds, peak_bw)


def train_mfu(n_params: int, tokens: float, seconds: float, peak: float) -> float:
    """Training MFU: 6·N·tokens (forward 2N, backward 4N) / seconds /
    peak; recomputed forwards are not counted (model FLOPs)."""
    return 3.0 * mfu(n_params, tokens, seconds, peak)
