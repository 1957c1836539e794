"""The inference device (``device.py``) and its prefill batcher
(``batcher.py``); the module path is the JAX package's, and so are the
exports: ``TPUDevice`` (it drives a CUDA card or the CPU), ``TPULog`` and
``new_device``. They resolve on first use (PEP 562): the device imports
modules that import this package's leaves, so an eager import would
cycle."""

from typing import Any

__all__ = ["TPUDevice", "TPULog", "new_device"]


def __getattr__(name: str) -> Any:
    if name in __all__:
        from gofr_tpu_torch.tpu import device

        return getattr(device, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
