"""Multi-host runtime: the process group a multi-host deployment joins.

Port of ``gofr_tpu/parallel/multihost.py``. The JAX package joins
``jax.distributed`` (one coordinator, N processes) so that ``jax.devices()``
spans every host; the port joins ``torch.distributed`` the same way, with
the address, world size and rank given explicitly (nothing else tells a
process of its cluster):

- ``TPU_COORDINATOR``   host:port of process 0 (unset -> single host)
- ``TPU_NUM_PROCESSES`` world size
- ``TPU_PROCESS_ID``    this process's rank

The backend follows the process's device (``TORCH_DEVICE``): ``gloo`` on
the CPU, ``cpu:gloo,cuda:nccl`` on the card, with NCCL's communicator made
at the join (a card NCCL cannot use fails the boot; nothing falls back to
gloo). NCCL refuses two ranks on one card: each rank needs its own.
Serving within a host stays single-controller (``parallel/serving.py``);
application-level coordination (health fan-out, routing) rides the
framework's own HTTP/gRPC service clients, as in the JAX package.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import torch

from gofr_tpu_torch.parallel.mesh import visible_devices

_lock = threading.Lock()
_initialized = False
_platform: Optional[str] = None
_global_devices: Optional[int] = None


def init_from_config(config: Any, logger: Any = None) -> bool:
    """Join the process group when ``TPU_COORDINATOR`` is configured.
    Returns True when the join ran (or already had). Idempotent; a failed
    join raises (the caller's boot fails)."""
    global _initialized, _platform, _global_devices
    coordinator = config.get("TPU_COORDINATOR")
    if not coordinator:
        return False
    with _lock:
        if _initialized:
            return True
        import torch.distributed as dist

        num_processes = int(config.get_or_default("TPU_NUM_PROCESSES", "1"))
        process_id = int(config.get_or_default("TPU_PROCESS_ID", "0"))
        platform = config.get_or_default("TORCH_DEVICE", "cuda")
        if logger is not None:
            logger.infof(
                "joining multi-host runtime: coordinator=%s process %d/%d",
                coordinator, process_id, num_processes,
            )
        if platform == "cuda":
            # the NCCL communicator made now, so that a card it cannot use
            # fails the join instead of the first collective
            kwargs = {"backend": "cpu:gloo,cuda:nccl",
                      "device_id": torch.device("cuda", torch.cuda.current_device())}
        else:
            kwargs = {"backend": "gloo"}
        dist.init_process_group(init_method=f"tcp://{coordinator}", world_size=num_processes,
                                rank=process_id, **kwargs)
        # the global device count, summed once at the join (every process
        # is here at the same point) over gloo
        total = torch.tensor([len(visible_devices(platform))], dtype=torch.int64)
        dist.all_reduce(total)
        _platform, _global_devices = platform, int(total.item())
        _initialized = True
        return True


def _local_platform() -> str:
    if _platform is not None:
        return _platform
    return "cuda" if torch.cuda.is_available() else "cpu"


def process_info() -> dict[str, int]:
    """Rank, world size and device counts of the joined runtime (health
    details); one process's own when none was joined."""
    import torch.distributed as dist

    local = len(visible_devices(_local_platform()))
    if not (_initialized and dist.is_initialized()):
        return {"process_id": 0, "process_count": 1, "local_devices": local,
                "global_devices": local}
    return {
        "process_id": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": local,
        "global_devices": _global_devices,
    }


def shutdown() -> None:
    global _initialized, _platform, _global_devices
    with _lock:
        if not _initialized:
            return
        import torch.distributed as dist

        try:
            dist.destroy_process_group()
        finally:
            _initialized, _platform, _global_devices = False, None, None


def global_psum_check() -> Optional[float]:
    """One cross-process collective as a liveness probe: the sum of every
    process's local device count, all-reduced on the process's device. It
    equals the global device count iff every process takes part. None at
    one process.

    Every process must call this at the same point (a coordinated startup
    check): called from one process's request handler it waits for its
    peers forever. Per-host liveness belongs on /.well-known/health, fanned
    out over the service layer."""
    import torch.distributed as dist

    if not (_initialized and dist.is_initialized()) or dist.get_world_size() <= 1:
        return None
    platform = _local_platform()
    device = (torch.device("cuda", torch.cuda.current_device()) if platform == "cuda"
              else torch.device("cpu"))
    ones = torch.ones(len(visible_devices(platform)), dtype=torch.float32, device=device)
    total = ones.sum().reshape(1)
    dist.all_reduce(total)
    return float(total.item())
