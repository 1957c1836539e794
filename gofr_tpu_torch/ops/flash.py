"""Flash attention: hand-written CUDA kernels for Hopper, forward and
backward, their plain PyTorch versions, and the ``autograd.Function``
that joins them.

Port of ``gofr_tpu/ops/flash.py``: the forward ``_flash_fwd_impl`` (the
Pallas ``_kernel``) and the backward ``_flash_bwd_impl`` (``_dq_kernel``
and ``_dkv_kernel``) with its ``custom_vjp``. The forward kernel
(``csrc/flash_fwd.cu``) computes, per (batch, q-head, q-tile), an online
softmax over K/V tiles in float32, maps q-head ``h`` to kv-head
``h // groups`` (GQA without repeated KV), bounds its KV loop by
``kv_lens`` and the causal diagonal, and emits the output in q's dtype
plus a per-row log-sum-exp in float32 (out 0 and LSE +inf on a row with
no visible key). The backward kernels (``csrc/flash_bwd.cu``) recompute
the probabilities from that log-sum-exp: one gives dQ, the other dK and
dV, summed over the GQA group deterministically (no atomics).

Each kernel has variants, picked by shape in pure Python here
(``fwd_variant``, ``dq_variant``, ``dkv_variant``) and launched with the
geometry computed here (``fwd_sm90_grid``, ``fwd_decode_splits``,
``dq_sm90_grid``, ``dkv_sm90_geometry``):
- "sm90", redesigned for Hopper (``wgmma``, TMA tile rings on
  ``mbarrier``s, warp specialisation, longest-first launch order; dK/dV
  sums the GQA group across a thread block cluster), takes bf16 at D = 128
  (the forward: Sq >= 64, so training and serving prefill; dQ and dK/dV:
  every such call, so the training path);
- "decode", the forward's decode route (bf16, D = 128, Sq x groups <= 16):
  the GQA group's query rows packed into one tile, split-KV across a
  thread block cluster, one deterministic merge;
- "mma", the ``mma.sync`` kernels, takes the rest (short tails, f32,
  other head dims) and stays forcible with ``variant="mma"`` for timing.
``launches``, ``launches_dq`` and ``launches_dkv`` count every variant;
``launches_fwd_sm90``, ``launches_fwd_decode``, ``launches_dq_sm90`` and
``launches_dkv_sm90`` one variant each.

Layouts: q [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D]; Hq % Hkv == 0.
``q_offset`` (scalar or [B]) is the absolute position of q row 0;
``kv_lens`` ([B], optional) bounds the valid cache prefix.

Dispatch is by the tensor's device: a CPU tensor runs the plain version
(``flash_attention_ref``, ``flash_attention_bwd_ref``); a CUDA tensor
launches the kernel or raises. Every ``csrc/*.cu`` is compiled with
``nvcc`` for ``sm_90a`` at first use into one library under
``gofr_tpu_torch/_build/`` and loaded with ``ctypes``; a failed build
raises. ``FLASH_DEBUG_BUILD=1`` in the environment builds instead the debug
library (``DEBUG_FLAGS``: the device-side index checks of
``csrc/sm90.cuh::GOFR_DCHECK`` compiled in) into ``_build/debug/``, for
hunting a device fault; the default build is unchanged by it.
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

# must match csrc/flash_fwd.cu and csrc/flash_bwd.cu
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = _PKG_DIR / "csrc"
SOURCE = CSRC / "flash_fwd.cu"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)
# the debug build: NVCC_FLAGS plus the device-side index checks
DEBUG_FLAGS = ("-DGOFR_FLASH_DEBUG",)


def debug_build() -> bool:
    """Whether this process builds (and launches) the debug library."""
    return os.environ.get("FLASH_DEBUG_BUILD", "") == "1"


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


launches = LaunchCounter()  # the forward, every variant
launches_fwd_sm90 = LaunchCounter()  # the forward's sm90 variant alone
launches_fwd_decode = LaunchCounter()  # the forward's decode variant alone
launches_dq = LaunchCounter()  # the backward's dQ kernel, both variants
launches_dq_sm90 = LaunchCounter()  # the dQ kernel's sm90 variant alone
launches_dkv = LaunchCounter()  # the backward's dK/dV kernel, both variants
launches_dkv_sm90 = LaunchCounter()  # the dK/dV kernel's sm90 variant alone

# The redesigned kernels' tiles, as in csrc/flash_fwd.cu and csrc/flash_bwd.cu
FWD_SM90_BLOCK_Q = 128
FWD_SM90_MIN_SQ = 64
FWD_DECODE_ROWS = 16  # packed query rows (Sq x groups): one m16 tile
FWD_DECODE_BLOCK_KV = 64  # keys per tile; a split takes whole tiles
DQ_SM90_BLOCK_Q = 128
DKV_SM90_BLOCK_KV = 128
MAX_CLUSTER = 8  # the portable thread block cluster size
# decode blocks to aim for: two per SM of the H100's 132
DECODE_TARGET_BLOCKS = 264
# each redesigned kernel (its name in ptxas's report) and the library call
# that gives its dynamic shared memory
SMEM_QUERIES = {
    "flash_fwd_sm90_kernel": "gofr_flash_fwd_sm90_smem",
    "flash_fwd_decode_kernel": "gofr_flash_fwd_decode_smem",
    "flash_bwd_dq_sm90_kernel": "gofr_flash_bwd_dq_sm90_smem",
    "flash_bwd_dkv_sm90_kernel": "gofr_flash_bwd_dkv_sm90_smem",
}


def _tma_ok(t: torch.Tensor) -> bool:
    """TMA reads rows whose pointer and strides are multiples of 16 bytes."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all((s * es) % 16 == 0 for s in t.stride()[:3])


def fwd_variant(q: torch.Tensor, k: torch.Tensor) -> str:
    """Which forward kernel takes a call: "decode" for bf16, D = 128 and
    Sq x groups <= 16 (the query rows of one KV head fit one m16 tile:
    Sq <= 4 at llama3-8b's groups of 4, Sq = 1 up to groups of 16; the
    serving path's decode); "sm90" for bf16, D = 128, Sq >= 64 with 16-byte
    aligned q rows (training and serving prefill); "mma", the mma kernel,
    for the rest (short tails, f32, other D)."""
    sq, d = q.shape[1], q.shape[3]
    if q.dtype != torch.bfloat16 or d != 128:
        return "mma"
    if sq * (q.shape[2] // k.shape[2]) <= FWD_DECODE_ROWS:
        return "decode"
    return "sm90" if sq >= FWD_SM90_MIN_SQ and _tma_ok(q) else "mma"


def fwd_sm90_grid(b: int, sq: int, hq: int) -> tuple[int, int, int]:
    """(q heads, batch rows, q tiles): the kernel maps blockIdx.z to the q
    tiles in reverse under the causal mask, longest first."""
    return hq, b, -(-sq // FWD_SM90_BLOCK_Q)


def fwd_decode_splits(b: int, hkv: int, skv: int) -> int:
    """Split-KV blocks per (batch row, KV head): enough for about two
    blocks an SM, at most one per 64-key tile of the cache and at most a
    portable cluster. From shapes alone (no device value): each block
    finds its own key range from its row's kv_len."""
    tiles = -(-skv // FWD_DECODE_BLOCK_KV)
    return max(1, min(MAX_CLUSTER, tiles, -(-DECODE_TARGET_BLOCKS // max(1, b * hkv))))


def dq_variant(q: torch.Tensor) -> str:
    """Which dQ kernel takes a call: "sm90" for bf16, D = 128, Sq >= 1 with
    16-byte aligned q rows (TMA reads them); "mma" for the rest."""
    if q.dtype == torch.bfloat16 and q.shape[-1] == 128 and q.shape[1] >= 1 and _tma_ok(q):
        return "sm90"
    return "mma"


def dq_sm90_grid(b: int, sq: int, hq: int) -> tuple[int, int, int]:
    """(q heads, batch rows, q tiles of 128 rows), the q tiles launched in
    reverse under the causal mask: longest first."""
    return hq, b, -(-sq // DQ_SM90_BLOCK_Q)


def dkv_variant(q: torch.Tensor) -> str:
    """Which dK/dV kernel takes a call: "sm90" for bf16, D = 128 and Sq >= 1
    (the wrapper checks the 16-byte rows TMA needs), "mma" for the rest."""
    if q.dtype == torch.bfloat16 and q.shape[-1] == 128 and q.shape[1] >= 1:
        return "sm90"
    return "mma"


def dkv_sm90_geometry(b: int, skv: int, hq: int, hkv: int) -> dict:
    """Launch geometry of the sm90 dK/dV kernel: clusters of ``cluster``
    blocks (one per q head of a GQA group, the largest divisor of the group
    size up to 8) along x, each block walking ``heads_per_block`` heads;
    key tiles along z in ascending order, the causal mask's longest first."""
    groups = hq // hkv
    cluster = max(c for c in range(1, MAX_CLUSTER + 1) if groups % c == 0)
    return {"grid": (hkv * cluster, b, -(-skv // DKV_SM90_BLOCK_KV)), "cluster": cluster,
            "heads_per_block": groups // cluster}


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


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build() -> _Built:
    """Compile every ``csrc/*.cu`` (one nvcc per source, all at once) and
    link them into one library, once per process and per hash of the
    sources, headers and flags; then load it. Raises RuntimeError with
    nvcc's output if a step fails. Under ``FLASH_DEBUG_BUILD=1`` the
    library is the debug build (``DEBUG_FLAGS``, in ``_build/debug/``)."""
    global _built
    with _build_lock:
        if _built is not None:
            return _built
        flags = NVCC_FLAGS + (DEBUG_FLAGS if debug_build() else ())
        build_dir = BUILD_DIR / "debug" if debug_build() else BUILD_DIR
        sources = _sources()
        digest = hashlib.sha256(" ".join(flags).encode())
        for src in sources + sorted(CSRC.glob("*.cuh")):
            digest.update(src.name.encode() + src.read_bytes())
        tag = digest.hexdigest()[:16]
        build_dir.mkdir(parents=True, exist_ok=True)
        path = build_dir / f"libflash_{tag}.so"
        start = time.perf_counter()
        log = ""
        if not path.exists():
            nvcc = _nvcc()
            tmp = build_dir / f"{tag}.{os.getpid()}"
            tmp.mkdir(exist_ok=True)
            objs = [tmp / f"{src.stem}.o" for src in sources]
            procs = [
                subprocess.Popen(
                    [nvcc, *flags, "-c", "-o", str(obj), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )
                for src, obj in zip(sources, objs)
            ]
            for src, proc in zip(sources, procs):
                log += f"== {src.name}\n{proc.communicate()[0]}"
            failed = [src.name for src, proc in zip(sources, procs) if proc.returncode != 0]
            if not failed:
                link = subprocess.run(
                    [nvcc, *flags, "-shared", "-o", str(tmp / "lib.so"), *map(str, objs)],
                    capture_output=True, text=True,
                )
                log += link.stdout + link.stderr
                if link.returncode != 0:
                    failed = ["link"]
            if failed:
                raise RuntimeError(f"nvcc failed building {', '.join(failed)}:\n{log}")
            path.with_suffix(".log").write_text(log)
            os.replace(tmp / "lib.so", path)
            shutil.rmtree(tmp, ignore_errors=True)
        elif path.with_suffix(".log").exists():
            log = path.with_suffix(".log").read_text()  # what that build reported
        lib = ctypes.CDLL(str(path))
        fwd = lib.gofr_flash_fwd
        fwd.restype = ctypes.c_int
        fwd.argtypes = (
            [ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 7
            + [ctypes.c_int] * 5
            + [ctypes.c_int64] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        bwd = lib.gofr_flash_bwd
        bwd.restype = ctypes.c_int
        bwd.argtypes = (
            [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 11
            + [ctypes.c_int] * 5
            + [ctypes.c_int64] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        fwd90 = lib.gofr_flash_fwd_sm90
        fwd90.restype = ctypes.c_int
        fwd90.argtypes = (
            [ctypes.c_void_p] * 7
            + [ctypes.c_int] * 5
            + [ctypes.c_int64] * 9
            + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        )
        dec = lib.gofr_flash_fwd_decode
        dec.restype = ctypes.c_int
        dec.argtypes = (
            [ctypes.c_void_p] * 7
            + [ctypes.c_int] * 5
            + [ctypes.c_int64] * 9
            + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        )
        dq90 = lib.gofr_flash_bwd_dq_sm90
        dq90.restype = ctypes.c_int
        dq90.argtypes = (
            [ctypes.c_void_p] * 9
            + [ctypes.c_int] * 5
            + [ctypes.c_int64] * 9
            + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        )
        dkv90 = lib.gofr_flash_bwd_dkv_sm90
        dkv90.restype = ctypes.c_int
        dkv90.argtypes = (
            [ctypes.c_void_p] * 10
            + [ctypes.c_int] * 5
            + [ctypes.c_int64] * 9
            + [ctypes.c_float] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        )
        for name in SMEM_QUERIES.values():
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = []
        lib.gofr_cuda_error_string.restype = ctypes.c_char_p
        lib.gofr_cuda_error_string.argtypes = [ctypes.c_int]
        _built = _Built(lib, path, time.perf_counter() - start, log)
        return _built


def build_report(built: _Built) -> dict:
    """Each redesigned kernel (``SMEM_QUERIES``) that ptxas reported in
    this build: {"ptxas": its registers and spills, "smem": its dynamic
    shared memory in bytes, "spills": True unless ptxas said 0 bytes of
    spill stores and loads}, from the log of the build that made the
    library."""
    lines = built.log.splitlines()
    report = {}
    for i, line in enumerate(lines):
        name = next((n for n in SMEM_QUERIES if n in line and "Compiling entry" in line), None)
        if name is None:
            continue
        props = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                 if "spill" in x or "registers" in x]
        text = "; ".join(props)
        report[name] = {"ptxas": text, "smem": getattr(built.lib, SMEM_QUERIES[name])(),
                        "spills": not ("0 bytes spill stores" in text
                                       and "0 bytes spill loads" in text)}
    return report


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


def _visible(
    q: torch.Tensor, k: torch.Tensor, q_offset, kv_lens: Optional[torch.Tensor], causal: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """(live [B, Skv]: keys before kv_len, mask [B, 1, 1, Sq, Skv]: the
    (query, key) pairs that attend)."""
    b, sq, skv = q.shape[0], q.shape[1], k.shape[1]
    offsets, lens = _normalize_scalars(q, k, q_offset, kv_lens)
    k_pos = torch.arange(skv, device=q.device)
    live = k_pos[None, :] < lens[:, None]
    valid = live[:, None, :].expand(b, sq, skv)
    if causal:
        q_pos = offsets[:, None] + torch.arange(sq, device=q.device)[None, :]
        valid = valid & (k_pos[None, None, :] <= q_pos[:, :, None])
    return live, valid[:, None, None]


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
    live, mask = _visible(q, k, q_offset, kv_lens, causal)
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


def _pick(name: str, chosen: str, asked: Optional[str]) -> str:
    """The variant a call takes: the one its shape picks, or ``asked``
    ("mma" always fits; "sm90" and "decode" only where the shape picks
    them)."""
    if asked is None or asked == chosen or asked == "mma":
        return asked or chosen
    raise ValueError(f"{name}: the {asked} variant does not take this call")


def _raise_on(built: _Built, rc: int, name: str) -> None:
    """A launch that CUDA refused raises with CUDA's error string."""
    if rc != 0:
        msg = built.lib.gofr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cuda error {rc})")


def _launch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, offsets: torch.Tensor,
    lens: torch.Tensor, causal: bool, scale: float, variant: Optional[str] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel; ``variant`` overrides the shape's pick (to time
    the mma kernel beside the sm90 and decode variants)."""
    _check(q, k, v)
    built = build()
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if sq == 0 or b == 0:
        return out, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), offsets.data_ptr(), lens.data_ptr(),
            out.data_ptr(), lse.data_ptr())
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    variant = _pick("flash_fwd", fwd_variant(q, k), variant)
    if variant == "sm90":
        rc = built.lib.gofr_flash_fwd_sm90(
            *ptrs, b, sq, skv, hq, hkv, *strides, float(scale), int(causal),
            *fwd_sm90_grid(b, sq, hq), q.device.index or 0, stream,
        )
    elif variant == "decode":
        rc = built.lib.gofr_flash_fwd_decode(
            *ptrs, b, sq, skv, hq, hkv, *strides, float(scale), int(causal),
            fwd_decode_splits(b, hkv, skv), q.device.index or 0, stream,
        )
    else:
        rc = built.lib.gofr_flash_fwd(
            _DTYPE_CODES[q.dtype], d, *ptrs, b, sq, skv, hq, hkv, *strides,
            float(scale), int(causal), q.device.index or 0, stream,
        )
    _raise_on(built, rc, f"flash_fwd ({variant})")
    launches.add()
    if variant == "sm90":
        launches_fwd_sm90.add()
    elif variant == "decode":
        launches_fwd_decode.add()
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


def flash_attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset,
    kv_lens: Optional[torch.Tensor],
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool,
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels, written out as the
    TPU kernels compute it (not autograd through the forward): P = exp(S -
    LSE) in float32 (0 where the key is masked or LSE is +inf), dP = dO·Vᵀ
    and D = rowsum(dO ⊙ O) in float32, dS = P ⊙ (dP − D) rounded to k's
    dtype for dS·K and to q's dtype for dSᵀ·Q, P kept float32 for Pᵀ·dO;
    sums in float32, cast to the inputs' dtypes. -> (dq, dk, dv)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    groups = hq // hkv
    live, mask = _visible(q, k, q_offset, kv_lens, causal)
    # unwritten cache slots never reach a product (0 * NaN would survive)
    tail = ~live[:, :, None, None]
    k_live = k.masked_fill(tail, 0).float()
    v_live = v.masked_fill(tail, 0).float()
    qg = q.reshape(b, sq, hkv, groups, d).float()
    dog = do.reshape(b, sq, hkv, groups, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_live) * scale
    s = s.masked_fill(~mask, _NEG_INF)
    p = torch.exp(s - lse.reshape(b, hkv, groups, sq, 1))  # masked or LSE +inf -> 0
    dvec = (dog * out.reshape(b, sq, hkv, groups, d).float()).sum(-1)  # [B, Sq, Hkv, G]
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v_live)
    ds = p * (dp - dvec.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds.to(k.dtype).float(), k_live) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds.to(q.dtype).float(), qg) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    return dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
               lse: torch.Tensor, dvec: torch.Tensor) -> None:
    _check(q, k, v)
    if do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} must be q's shape {tuple(q.shape)}")
    if do.dtype != q.dtype or do.device != q.device:
        raise TypeError(f"dO must be q's dtype and device, got {do.dtype} on {do.device}")
    if not do.is_contiguous():
        raise ValueError("dO must be contiguous")
    rows = (q.shape[0], q.shape[2], q.shape[1])
    for name, t in (("lse", lse), ("D", dvec)):
        if t.shape != rows or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be [B, Hq, Sq] contiguous float32, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if q.dtype == torch.bfloat16:
        # the bf16 dK/dV kernel loads Q and dO tiles 16 bytes a thread too
        if any(t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]) for t in (q, do)):
            raise ValueError("bf16 q and dO need 16-byte aligned rows (pointer and strides)")


def _launch_bwd_kernel(
    which: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, dvec: torch.Tensor, offsets: torch.Tensor, lens: torch.Tensor,
    causal: bool, scale: float, outputs: tuple[Optional[torch.Tensor], ...],
    variant: Optional[str] = None,
) -> None:
    """``which`` 0 launches the dQ kernel into ``outputs`` = (dq, None,
    None), 1 the dK/dV kernel into (None, dk, dv); each its sm90 variant
    where ``dq_variant`` / ``dkv_variant`` picks it (or ``variant`` says)."""
    _check_bwd(q, k, v, do, lse, dvec)
    built = build()
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    name = ("flash_bwd_dq", "flash_bwd_dkv")[which]
    chosen = (dq_variant, dkv_variant)[which](q)
    ptrs = [None if t is None else t.data_ptr() for t in outputs]
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
              dvec.data_ptr(), offsets.data_ptr(), lens.data_ptr())
    shape = (b, sq, skv, hq, hkv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sm90 = _pick(name, chosen, variant) == "sm90"
    if sm90 and which == 0:
        rc = built.lib.gofr_flash_bwd_dq_sm90(
            *inputs, ptrs[0], *shape, float(scale), int(causal), *dq_sm90_grid(b, sq, hq),
            q.device.index or 0, stream,
        )
    elif sm90:
        geo = dkv_sm90_geometry(b, skv, hq, hkv)
        rc = built.lib.gofr_flash_bwd_dkv_sm90(
            *inputs, *ptrs[1:], *shape, float(scale), int(causal), *geo["grid"],
            geo["cluster"], geo["heads_per_block"], q.device.index or 0, stream,
        )
    else:
        rc = built.lib.gofr_flash_bwd(
            which, _DTYPE_CODES[q.dtype], d, *inputs, *ptrs, *shape, float(scale), int(causal),
            q.device.index or 0, stream,
        )
    _raise_on(built, rc, f"{name} ({'sm90' if sm90 else 'mma'})")
    (launches_dq, launches_dkv)[which].add()
    if sm90:
        (launches_dq_sm90, launches_dkv_sm90)[which].add()


def launch_dq(
    q, k, v, do, lse, dvec, offsets, lens, causal, scale, variant: Optional[str] = None
) -> torch.Tensor:
    """The dQ kernel alone: dq [B, Sq, Hq, D] in q's dtype. ``do`` is
    contiguous; ``dvec`` is D = rowsum(dO ⊙ O) as [B, Hq, Sq] float32.
    ``variant`` overrides the shape's pick (to time the mma kernel)."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.numel():
        _launch_bwd_kernel(0, q, k, v, do, lse, dvec, offsets, lens, causal, scale,
                           (dq, None, None), variant)
    return dq


def launch_dkv(
    q, k, v, do, lse, dvec, offsets, lens, causal, scale, variant: Optional[str] = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel alone: (dk, dv) [B, Skv, Hkv, D] in k's dtype,
    every element written (zeros past kv_len, and everywhere when Sq = 0).
    ``variant`` overrides the shape's pick (to time the mma kernel)."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    if k.numel():
        _launch_bwd_kernel(1, q, k, v, do, lse, dvec, offsets, lens, causal, scale,
                           (None, dk, dv), variant)
    return dk, dv


def _launch_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, offsets: torch.Tensor,
    lens: torch.Tensor, out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    causal: bool, scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both backward kernels on the current stream. dO arrives from
    autograd and may be a non-contiguous view (the gradient of a reshape,
    an expand or a transpose of the output); the kernels read it as
    [B, Sq, Hq, D] rows, so it is made contiguous here."""
    do = do.contiguous()
    # D = rowsum(dO ⊙ O), one plain reduction shared by both kernels (the
    # JAX package computes it outside Pallas too)
    dvec = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()  # [B, Hq, Sq]
    dq = launch_dq(q, k, v, do, lse, dvec, offsets, lens, causal, scale)
    dk, dv = launch_dkv(q, k, v, do, lse, dvec, offsets, lens, causal, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with the fused backward: the counterpart of the JAX
    package's ``custom_vjp`` (``_flash_fwd`` / ``_flash_bwd``). Gradients
    flow to q, k and v; the position tensors get none (JAX's float0)."""

    @staticmethod
    def forward(ctx, q, k, v, offsets, lens, causal: bool, scale: float):
        out, lse = flash_attention_fwd(q, k, v, causal, offsets, lens, scale)
        ctx.save_for_backward(q, k, v, offsets, lens, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, offsets, lens, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = flash_attention_bwd_ref(
                q, k, v, offsets, lens, out, lse, do, ctx.causal, ctx.scale
            )
        else:
            grads = _launch_bwd(q, k, v, offsets, lens, out, lse, do, ctx.causal, ctx.scale)
        return (*grads, None, None, None, None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_offset=0,
    kv_lens: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention output, differentiable through the backward kernels
    (see ``flash_attention_fwd`` for the forward's contract)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    offsets, lens = _normalize_scalars(q, k, q_offset, kv_lens)
    return FlashAttention.apply(q, k, v, offsets, lens, causal, float(scale))
