"""Checkpoint save and restore, with the JAX package's directory contract.

Port of ``gofr_tpu/training/checkpoint.py``: parameters under
``<path>/params``, training states under ``<path>/state_<step>``, and
``latest_step`` reads the highest complete ``state_<n>``. The file format
is ``torch.save`` of the state dicts (the JAX package writes orbax, a JAX
library). Each save writes a ``<name>.gofr-tmp-<pid>`` directory and
renames it into place, so an interrupted save leaves a name that
``latest_step`` skips, never a half-written ``state_<n>``.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch

_FILE = "state.pt"


def _save(obj: Any, target: str) -> None:
    tmp = f"{target}.gofr-tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(obj, os.path.join(tmp, _FILE))
    shutil.rmtree(target, ignore_errors=True)  # force: a save replaces
    os.replace(tmp, target)


def _load(target: str, device: "torch.device | str") -> Any:
    return torch.load(os.path.join(target, _FILE), map_location=device, weights_only=True)


def save_params(path: str, params: dict) -> None:
    """``params``: a model's ``state_dict()``, or a LoRA adapter artifact
    (``models/lora.py::export_adapter``: nested dicts of tensors, which
    ``restore_params`` reads back under ``weights_only``)."""
    _save(params, os.path.join(os.path.abspath(path), "params"))


def restore_params(path: str, device: "torch.device | str" = "cuda") -> dict:
    return _load(os.path.join(os.path.abspath(path), "params"), device)


def save_train_state(path: str, params: dict, opt_state: Any, step: int) -> None:
    """The full training state for resume: parameters (a state dict), the
    optimizer state and the step."""
    _save(
        {"params": params, "opt_state": opt_state, "step": int(step)},
        os.path.join(os.path.abspath(path), f"state_{int(step)}"),
    )


def latest_step(path: str) -> Optional[int]:
    """Highest ``state_<n>`` under ``path``. Names that are not exactly
    state_<int> (a save cut short leaves ``state_<n>.gofr-tmp-<pid>``) are
    skipped."""
    try:
        names = os.listdir(os.path.abspath(path))
    except OSError:
        return None
    steps = [int(n[6:]) for n in names if n.startswith("state_") and n[6:].isdigit()]
    return max(steps) if steps else None


def restore_train_state(
    path: str, step: Optional[int] = None, device: "torch.device | str" = "cuda"
) -> dict:
    """{"params", "opt_state", "step"} of ``state_<step>`` (default: the
    latest), tensors on ``device``. Resume with ``resume_train_state``."""
    path = os.path.abspath(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no training state under {path}")
    return _load(os.path.join(path, f"state_{step}"), device)


def resume_train_state(state: dict, restored: dict) -> dict:
    """Continue a training state built with the same config and optimizer
    (``init_train_state``) from a restored checkpoint: its parameters are
    loaded into the model; its optimizer state (already on the device it
    was restored to) and step replace the state's."""
    state["model"].load_state_dict(restored["params"])
    state["opt_state"] = restored["opt_state"]
    state["step"] = int(restored["step"])
    return state
