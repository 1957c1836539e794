"""Dependency container: config, logger, handler thread pool and the
inference device (trimmed copy of ``gofr_tpu/container.py``).

Unlike the JAX package, a device that fails to start is NOT logged and
dropped: the error propagates, so a missing GPU or a failed kernel build
never turns into a server that answers 503s.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

from gofr_tpu_torch.logging import Logger

HANDLER_THREADS = 64


class Container:
    def __init__(self, config: Any, model: Any = None):
        self.config = config
        self.logger = Logger()
        self.tpu: Optional[Any] = None
        self._handler_pool: Optional[ThreadPoolExecutor] = None
        if config.get("MODEL_NAME"):
            from gofr_tpu_torch.tpu.device import TPUDevice

            self.tpu = TPUDevice(config, self.logger, model=model)

    def health(self) -> dict[str, Any]:
        if self.tpu is None:
            return {"status": "UP", "details": {}}
        h = self.tpu.health_check()
        return {"status": h["status"], "details": {"tpu": h}}

    @property
    def handler_executor(self) -> ThreadPoolExecutor:
        """Thread pool for sync handlers, sized for blocking generations."""
        if self._handler_pool is None:
            self._handler_pool = ThreadPoolExecutor(
                max_workers=HANDLER_THREADS, thread_name_prefix="gofr-handler"
            )
        return self._handler_pool

    def close(self) -> None:
        if self.tpu is not None:
            self.tpu.close()
        if self._handler_pool is not None:
            self._handler_pool.shutdown(wait=False)
