"""PyTorch/CUDA port of gofr_tpu for one NVIDIA H100.

It serves Llama-family decoders over ``POST /v1/completions``, BERT
sentence embeddings over ``POST /v1/embeddings`` and an MLP through
``TPUDevice.infer``: ``new()`` builds the app (``MODEL_NAME`` picks the
model), ``register_openai_routes(app)`` adds the endpoints, and every
attention call on a CUDA tensor runs the hand-written flash-attention
forward kernel (``csrc/flash_fwd.cu``). It trains them
(``training/``), with attention's backward in the hand-written dQ and
dK/dV kernels (``csrc/flash_bwd.cu``). Entry points run on ``cuda``
unless the caller asks for the CPU (``TORCH_DEVICE=cpu``, or
``device="cpu"``), where the kernels' plain PyTorch versions run instead.
"""

from __future__ import annotations

from typing import Any

__all__ = ["new", "App", "register_openai_routes"]


def __getattr__(name: str) -> Any:
    # lazy exports: importing the package must not import the server stack
    if name in ("new", "App"):
        from gofr_tpu_torch import app

        return getattr(app, name)
    if name == "register_openai_routes":
        from gofr_tpu_torch.openai import register_openai_routes

        return register_openai_routes
    raise AttributeError(name)
