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
``new_cmd()`` builds a CLI app over the same container; ``Context`` is
the handler's argument and ``__version__`` the package's version, as in the
JAX package.
"""

from __future__ import annotations

from typing import Any

from gofr_tpu_torch.version import __version__

__all__ = ["new", "new_cmd", "App", "Context", "register_openai_routes", "__version__"]


def __getattr__(name: str) -> Any:
    # lazy exports: importing the package must not import the server stack
    if name in ("new", "new_cmd", "App"):
        from gofr_tpu_torch import app

        return getattr(app, name)
    if name == "Context":
        from gofr_tpu_torch.context import Context

        return Context
    if name == "register_openai_routes":
        from gofr_tpu_torch.openai import register_openai_routes

        return register_openai_routes
    raise AttributeError(name)
