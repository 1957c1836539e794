"""Flash-attention forward: a hand-written CUDA kernel for Hopper and its
plain PyTorch version.

Port of ``gofr_tpu/ops/flash.py::_flash_fwd_impl`` (the Pallas ``_kernel``).
The kernel (``csrc/flash_fwd.cu``) computes, per (batch, q-head, q-tile),
an online softmax over K/V tiles in float32, maps q-head ``h`` to kv-head
``h // groups`` (GQA without repeated KV), bounds its KV loop by
``kv_lens`` and the causal diagonal, and emits the output in q's dtype
plus a per-row log-sum-exp in float32 (out 0 and LSE +inf on a row with
no visible key).

Layouts: q [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D]; Hq % Hkv == 0.
``q_offset`` (scalar or [B]) is the absolute position of q row 0;
``kv_lens`` ([B], optional) bounds the valid cache prefix.

Dispatch is by the tensor's device: a CPU tensor runs
``flash_attention_ref``; a CUDA tensor launches the kernel or raises.
The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use into
``gofr_tpu_torch/_build/`` and loaded with ``ctypes``; a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

_NEG_INF = -1e30

# must match csrc/flash_fwd.cu
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "flash_fwd.cu"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)


class LaunchCounter:
    """Plain count of kernel launches: the serving path's proof that it
    went through the kernel. Incremented only where the kernel launches."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


launches = LaunchCounter()


class _Built:
    """The loaded kernel library plus what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, seconds: float, log: str):
        self.lib = lib
        self.path = path
        self.seconds = seconds
        self.log = log


_built: Optional[_Built] = None
_build_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME)")


def build() -> _Built:
    """Compile ``csrc/flash_fwd.cu`` (once per process and source hash) and
    load it. Raises RuntimeError with nvcc's output if the build fails."""
    global _built
    with _build_lock:
        if _built is not None:
            return _built
        src = SOURCE.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path = BUILD_DIR / f"libflash_fwd_{tag}.so"
        start = time.perf_counter()
        log = ""
        if not path.exists():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {SOURCE.name}:\n{log}"
                )
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        fn = lib.gofr_flash_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 7
            + [ctypes.c_int] * 5
            + [ctypes.c_int64] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        lib.gofr_cuda_error_string.restype = ctypes.c_char_p
        lib.gofr_cuda_error_string.argtypes = [ctypes.c_int]
        _built = _Built(lib, path, time.perf_counter() - start, log)
        return _built


def _normalize_scalars(
    q: torch.Tensor, k: torch.Tensor, q_offset, kv_lens: Optional[torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor]:
    """[B] int32 offsets and kv lengths on q's device. Lengths past Skv
    are left as given: the kernel and the plain version both stop at Skv."""
    b, skv = q.shape[0], k.shape[1]
    offsets = torch.as_tensor(q_offset, dtype=torch.int32, device=q.device)
    if offsets.ndim == 0:
        offsets = offsets.expand(b)
    if kv_lens is None:
        lens = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    else:
        lens = torch.as_tensor(kv_lens, dtype=torch.int32, device=q.device)
    return offsets.contiguous(), lens.contiguous()


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_offset=0,
    kv_lens: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (out [B,Sq,Hq,D] in q's dtype,
    lse [B,Hq,Sq] float32). Scores and softmax in float32, probabilities
    cast to v's dtype for the P·V product (as the kernel does), masked
    keys at -1e30, a row with no visible key gives out 0 and LSE +inf."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    groups = hq // hkv
    if scale is None:
        scale = d ** -0.5
    offsets, lens = _normalize_scalars(q, k, q_offset, kv_lens)
    k_pos = torch.arange(skv, device=q.device)
    live = k_pos[None, :] < lens[:, None]  # [B, Skv]
    valid = live[:, None, :].expand(b, sq, skv)
    if causal:
        q_pos = offsets[:, None] + torch.arange(sq, device=q.device)[None, :]
        valid = valid & (k_pos[None, None, :] <= q_pos[:, :, None])
    mask = valid[:, None, None]  # [B, 1, 1, Sq, Skv]
    qg = q.reshape(b, sq, hkv, groups, d).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    logits = logits.masked_fill(~mask, _NEG_INF)
    any_valid = mask.any(dim=-1)  # [B, 1, 1, Sq]
    lse = torch.where(
        any_valid, torch.logsumexp(logits, dim=-1), torch.tensor(float("inf"), device=q.device)
    )
    probs = torch.softmax(logits, dim=-1) * mask
    # unwritten cache slots never reach the product (a NaN there would
    # otherwise survive 0 * NaN)
    v_live = v.masked_fill(~live[:, :, None, None], 0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(), v_live.float())
    return out.reshape(b, sq, hq, d).to(q.dtype), lse.reshape(b, hq, sq)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernel takes bf16 or f32 q, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q, k, v need a contiguous head dim")
    if q.dtype == torch.bfloat16:
        # the bf16 kernel loads K/V tiles 16 bytes (8 elements) a thread
        if any(t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]) for t in (k, v)):
            raise ValueError("bf16 k and v need 16-byte aligned rows (pointer and strides)")
    if b > 65535 or hq > 65535:
        raise ValueError("batch and q heads must each be < 65536")


def _launch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, offsets: torch.Tensor,
    lens: torch.Tensor, causal: bool, scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    _check(q, k, v)
    built = build()
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if sq == 0 or b == 0:
        return out, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = built.lib.gofr_flash_fwd(
        _DTYPE_CODES[q.dtype], d,
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        offsets.data_ptr(), lens.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, sq, skv, hq, hkv,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(scale), int(causal), q.device.index or 0, stream,
    )
    if rc != 0:
        msg = built.lib.gofr_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash_fwd launch failed: {msg} (cuda error {rc})")
    launches.add()
    return out, lse


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_offset=0,
    kv_lens: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse). CUDA tensors launch the kernel; CPU tensors run the
    plain version; any other device raises."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, q_offset, kv_lens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    offsets, lens = _normalize_scalars(q, k, q_offset, kv_lens)
    return _launch(q, k, v, offsets, lens, causal, scale)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_offset=0,
    kv_lens: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention output only (see ``flash_attention_fwd``)."""
    return flash_attention_fwd(q, k, v, causal, q_offset, kv_lens, scale)[0]
