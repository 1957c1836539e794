"""The native (C++) host library, loaded with ctypes (port of
``gofr_tpu/native/__init__.py``).

The library holds the byte-level BPE encode and decode and the prefill
row packer (``gofr_pack_rows``), all bound as in the JAX package. The port
calls its encode, on every request's path. Decode and the row packer stay
in Python and numpy (``tokenizer.py``, ``tpu/batcher.py``): the packer
lost to numpy's row copies on the card's host, and a native decode must
size its buffer from the same pieces the Python join walks. The source
is the package's own copy of the repo's ``native/tokenizer.cpp``,
``csrc/tokenizer.cpp``. At first use
:func:`load` compiles it with ``g++ -O2 -shared -fPIC -std=c++17`` into
``_build/native/`` beside the kernels (``GOFR_NATIVE_CACHE`` names another
directory), once per hash of the source. g++ runs outside the load lock,
into a file of this process and thread that is renamed into place, so a
reader never sees half a library.

Settings, as in the JAX package: ``GOFR_NATIVE_LIB`` loads a prebuilt
library from that path and builds nothing; ``GOFR_NATIVE_DISABLE`` (any
non-empty value) skips the library. Without the library (no g++, a failed
build, or disabled) :func:`load` returns None and the tokenizer takes its
Python encoder, which gives the same ids. This is host code, not a device
kernel: the fallback hides no device work.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

from gofr_tpu_torch.config import get_env

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "tokenizer.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build" / "native"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _cache_dir() -> Path:
    path = Path(get_env("GOFR_NATIVE_CACHE") or BUILD_DIR)
    path.mkdir(parents=True, exist_ok=True)
    return path


def _build() -> Optional[Path]:
    """The library for this source, compiled if not yet there; None when
    the source cannot be read, the directory cannot be written or g++
    fails or is missing."""
    try:
        source = SOURCE.read_bytes()
        digest = hashlib.sha256(source + " ".join(FLAGS).encode()).hexdigest()[:16]
        out = _cache_dir() / f"libgofr_native_{digest}.so"
    except OSError:
        return None
    if out.exists():
        return out
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (subprocess.SubprocessError, OSError):
        tmp.unlink(missing_ok=True)
        return None


def load() -> Optional[ctypes.CDLL]:
    """The native library, compiled and cached on first use; None when it
    is disabled or cannot be built or loaded (the callers' Python paths
    run). Tried once a process."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    explicit = get_env("GOFR_NATIVE_LIB")
    built = None
    if not explicit and not get_env("GOFR_NATIVE_DISABLE"):
        built = _build()  # outside the lock: a second thread may build too
    with _lock:
        if not _lib_tried:
            path = explicit or (str(built) if built is not None else None)
            try:
                _lib = _bind(ctypes.CDLL(path)) if path else None
            except OSError:
                _lib = None
            _lib_tried = True
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.gofr_tok_new.restype = c.c_void_p
    lib.gofr_tok_new.argtypes = [c.c_char_p, c.c_int64, c.c_int32]
    lib.gofr_tok_free.argtypes = [c.c_void_p]
    lib.gofr_tok_vocab_size.restype = c.c_int32
    lib.gofr_tok_vocab_size.argtypes = [c.c_void_p]
    lib.gofr_tok_encode.restype = c.c_int64
    lib.gofr_tok_encode.argtypes = [
        c.c_void_p, c.c_char_p, c.c_int64, c.POINTER(c.c_int32), c.c_int64,
    ]
    lib.gofr_tok_decode.restype = c.c_int64
    lib.gofr_tok_decode.argtypes = [
        c.c_void_p, c.POINTER(c.c_int32), c.c_int64, c.POINTER(c.c_uint8), c.c_int64,
    ]
    lib.gofr_pack_rows.argtypes = [
        c.POINTER(c.c_int32), c.POINTER(c.c_int64), c.c_int64, c.c_int64,
        c.c_int32, c.POINTER(c.c_int32), c.POINTER(c.c_int32),
    ]
    return lib
