"""Minimal logger protocol consumed by datasources (copy of
``gofr_tpu/datasource/logger.py``).

Parity: GoFr's pkg/gofr/datasource/logger.go:9-16 — datasources
depend on this tiny protocol, not on ``gofr_tpu_torch.logging``, so the logging
package stays free to pretty-print datasource log types without an import
cycle (the consumer-defined-interface rule called out in SURVEY.md §1).
"""

from __future__ import annotations

from typing import Any, Protocol


class DatasourceLogger(Protocol):
    def debug(self, *args: Any) -> None: ...

    def debugf(self, fmt: str, *args: Any) -> None: ...

    def info(self, *args: Any) -> None: ...

    def infof(self, fmt: str, *args: Any) -> None: ...

    def warn(self, *args: Any) -> None: ...

    def error(self, *args: Any) -> None: ...

    def errorf(self, fmt: str, *args: Any) -> None: ...
