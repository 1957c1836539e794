"""Shared health model aggregated by the container's health endpoint
(copy of ``gofr_tpu/datasource/health.py``).

Parity: GoFr's pkg/gofr/datasource/health.go:3-11 — a status string
(UP/DOWN) plus free-form details, aggregated with the inference
device's own health.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

UP = "UP"
DOWN = "DOWN"


@dataclass
class Health:
    status: str = DOWN
    details: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {"status": self.status, "details": self.details}
