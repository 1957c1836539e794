"""Multi-head / grouped-query attention.

Port of ``gofr_tpu/ops/attention.py::attention`` with the semantics of its
``_xla_attention``: GQA without repeating KV heads, causal masking with a
scalar or per-row [B] ``q_offset``, a ``kv_lens`` [B] bound on the valid
key prefix, zeros (not mean(v)) for a row that sees no key, and a lower-
precision K/V upcast to q's dtype at the boundary.

Every call goes through ``ops/flash.py``: on a CUDA tensor that is the
hand-written kernel, for prefill and decode alike (the TPU's
``_pallas_ok`` gate was tuned to v5e timings and does not carry over); on
a CPU tensor it is the kernel's plain PyTorch version.

Layouts: q [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D]; Hq % Hkv == 0.
"""

from __future__ import annotations

from typing import Optional

import torch

from gofr_tpu_torch.ops.flash import flash_attention

FLOAT8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)


def kv_bits(t: torch.Tensor) -> torch.Tensor:
    """A float8 cache tensor as its uint8 bits (the same storage): indexed
    writes, gathers and copies of the cache move bytes through this view,
    so they need no float8 kernel; other dtypes pass through."""
    return t.view(torch.uint8) if t.dtype in FLOAT8_DTYPES else t


def zeros_kv(shape: tuple, dtype: torch.dtype, device: "torch.device | str") -> torch.Tensor:
    """A zeroed cache tensor; a float8 one is zeroed through its bits
    (0x00 is +0.0 in both float8 formats)."""
    if dtype in FLOAT8_DTYPES:
        return torch.zeros(shape, dtype=torch.uint8, device=device).view(dtype)
    return torch.zeros(shape, dtype=dtype, device=device)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_offset=0,
    kv_lens: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    if k.dtype != q.dtype:
        # low-precision KV cache: upcast at the attention boundary
        k = k.to(q.dtype)
        v = v.to(q.dtype)
    return flash_attention(
        q, k, v, causal=causal, q_offset=q_offset, kv_lens=kv_lens, scale=scale
    )
