"""Matmul entry point of the model forwards.

Port of ``gofr_tpu/models/quant.py::mm`` for dense weights only: ``w`` is
a plain [in, out] tensor and the product accumulates in float32 (a bf16
``torch.matmul`` on the card accumulates in f32 once
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` is
off, which the serving device sets). The int8, int4 and w8a8 packs of the
JAX package (dicts with ``q``/``q4``/``q8`` and ``scale``) are not ported
yet and raise.
"""

from __future__ import annotations

from typing import Any

import torch


def mm(x: torch.Tensor, w: Any) -> torch.Tensor:
    if isinstance(w, dict):
        raise NotImplementedError(
            f"quantized weight pack with keys {sorted(w)} is not ported yet "
            "(dense weights only)"
        )
    return torch.matmul(x, w)
