"""Datasource layer (copy of ``gofr_tpu/datasource/``): health model,
decoupled logger protocol, and the concrete datasources (SQL, Redis; the
inference device reports the same health).

Parity: GoFr's pkg/gofr/datasource/ — notably the layering rule that
datasources define their own minimal logger protocol instead of importing the
logging package (datasource/logger.go:9-16).
"""

from gofr_tpu_torch.datasource.health import DOWN, UP, Health
from gofr_tpu_torch.datasource.logger import DatasourceLogger

__all__ = ["Health", "UP", "DOWN", "DatasourceLogger"]
