"""Checkpoint ingestion: a safetensors reader and the HF-Llama weight
mapping.

Port of ``gofr_tpu/models/ingest.py``. ``MODEL_PATH`` names a
``.safetensors`` file or an HF checkpoint directory (one file, or shards
with ``model.safetensors.index.json``).

- The reader is an mmap parser of the format (an 8-byte little-endian
  header length, a JSON header, raw little-endian tensor bytes); tensors
  are zero-copy numpy views of the mapped file. numpy has no bfloat16 or
  float8 without ``ml_dtypes``, so ``BF16`` is read as uint16 and
  ``F8_E4M3``/``F8_E5M2`` as uint8, and ``to_tensor`` views those bits as
  ``torch.bfloat16`` / ``torch.float8_e4m3fn`` / ``torch.float8_e5m2``.
- HF Llama names map onto the tree's (``model.layers.N.self_attn.q_proj.
  weight`` -> ``layers/wq`` of layer N), transposed from nn.Linear's
  [out, in] to the [in, out] the forwards multiply by. HF checkpoints use
  the split-half RoPE of ``ops/rope.py``: no permutation.
- ``load_llama_params`` fills a ``Transformer`` on the device one tensor at
  a time (quantized as it lands under ``quantize``, through
  ``quantizer_for_key``): neither the host nor the card ever holds a bf16
  copy of the whole model.
"""

from __future__ import annotations

import json
import mmap
import os
import warnings
from typing import Any, Iterator, Optional

import numpy as np
import torch

from gofr_tpu_torch.models.quant import Pack
from gofr_tpu_torch.models.transformer import Transformer

# safetensors dtype -> (numpy storage dtype, torch view dtype or None)
_DTYPES: dict[str, tuple] = {
    "F64": (np.float64, None), "F32": (np.float32, None), "F16": (np.float16, None),
    "BF16": (np.uint16, torch.bfloat16), "I64": (np.int64, None), "I32": (np.int32, None),
    "I16": (np.int16, None), "I8": (np.int8, None), "U8": (np.uint8, None),
    "BOOL": (np.bool_, None), "F8_E4M3": (np.uint8, torch.float8_e4m3fn),
    "F8_E5M2": (np.uint8, torch.float8_e5m2),
}


def _dtype(name: str) -> tuple:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported safetensors dtype {name!r}") from None


class SafetensorsFile:
    """One ``.safetensors`` file: the parsed header and zero-copy views.

    Format: [u64 little-endian header_len][header JSON][raw tensor data];
    each header entry maps name -> {dtype, shape, data_offsets: [begin,
    end)} relative to the end of the header.
    """

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        header_len = int.from_bytes(self._mm[:8], "little")
        if header_len > len(self._mm) - 8:
            raise ValueError(f"{path}: corrupt safetensors header length {header_len}")
        header = json.loads(self._mm[8 : 8 + header_len].decode("utf-8"))
        self.metadata = header.pop("__metadata__", {})
        self._entries = header
        self._data_start = 8 + header_len

    def names(self) -> list[str]:
        return list(self._entries)

    def dtype_name(self, name: str) -> str:
        return self._entries[name]["dtype"]

    def tensor(self, name: str) -> np.ndarray:
        """Zero-copy read-only view (copy before mutating); BF16 and F8
        tensors come as their uint16 / uint8 bits (``to_tensor`` views
        them as torch's dtype)."""
        try:
            meta = self._entries[name]
        except KeyError:
            raise KeyError(f"{self.path} has no tensor {name!r}") from None
        begin, end = meta["data_offsets"]
        storage, _ = _dtype(meta["dtype"])
        buf = memoryview(self._mm)[self._data_start + begin : self._data_start + end]
        return np.frombuffer(buf, dtype=storage).reshape(meta["shape"])

    def close(self) -> None:
        try:
            self._mm.close()
        except BufferError:
            pass  # tensor views still alive; the map unlinks when they die


class Checkpoint:
    """A checkpoint: one file, or an HF directory with a single
    ``model.safetensors`` or shards and ``model.safetensors.index.json``
    (weight_map: tensor name -> shard file)."""

    def __init__(self, path: str):
        self._files: dict[str, SafetensorsFile] = {}
        self._index: dict[str, str] = {}  # tensor name -> file path
        if os.path.isfile(path):
            self._add(path)
        elif os.path.isdir(path):
            index = os.path.join(path, "model.safetensors.index.json")
            if os.path.exists(index):
                with open(index) as f:
                    weight_map = json.load(f)["weight_map"]
                for name, fname in weight_map.items():
                    self._index[name] = os.path.join(path, fname)
            else:
                shards = sorted(
                    os.path.join(path, n) for n in os.listdir(path) if n.endswith(".safetensors")
                )
                if not shards:
                    raise FileNotFoundError(f"no .safetensors files under {path}")
                for shard in shards:
                    self._add(shard)
        else:
            raise FileNotFoundError(path)

    def _add(self, path: str) -> SafetensorsFile:
        sf = self._files.get(path)
        if sf is None:
            sf = self._files[path] = SafetensorsFile(path)
            for name in sf.names():
                self._index.setdefault(name, path)
        return sf

    def names(self) -> list[str]:
        return list(self._index)

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def _file(self, name: str) -> SafetensorsFile:
        try:
            path = self._index[name]
        except KeyError:
            raise KeyError(f"checkpoint has no tensor {name!r}") from None
        return self._add(path)

    def tensor(self, name: str) -> np.ndarray:
        return self._file(name).tensor(name)

    def torch_tensor(self, name: str) -> torch.Tensor:
        """The tensor as a CPU torch tensor over the mapped bytes (no copy),
        in its own dtype (BF16 and F8 included)."""
        sf = self._file(name)
        return to_tensor(sf.tensor(name), sf.dtype_name(name))

    def close(self) -> None:
        for sf in self._files.values():
            sf.close()


def to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A reader view -> a torch tensor sharing its memory, viewed as the
    safetensors dtype. The map is read-only and torch wants a writable
    buffer: the tensor must only be read (the loader copies it)."""
    _, view = _dtype(dtype_name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the read-only buffer
        t = torch.from_numpy(arr)
    return t.view(view) if view is not None else t


def is_safetensors_path(path: Optional[str]) -> bool:
    """MODEL_PATH routing: a .safetensors file, or a directory holding
    safetensors shards or their index (any other path is a checkpoint of
    ``training/checkpoint.py``)."""
    if not path:
        return False
    if path.endswith(".safetensors"):
        return True
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, "model.safetensors.index.json")):
            return True
        return any(n.endswith(".safetensors") for n in os.listdir(path))
    return False


# -- HF Llama mapping ---------------------------------------------------------

# our per-layer name -> (HF suffix, transpose). HF nn.Linear stores [out, in];
# our forwards compute x @ w with w [in, out].
_LAYER_MAP = {
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "w_gate": ("mlp.gate_proj.weight", True),
    "w_up": ("mlp.up_proj.weight", True),
    "w_down": ("mlp.down_proj.weight", True),
    "attn_norm": ("input_layernorm.weight", False),
    "mlp_norm": ("post_attention_layernorm.weight", False),
}


def _expect_shape(name: str, t: Any, shape: tuple[int, ...]) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(
            f"checkpoint tensor {name!r} has shape {tuple(t.shape)}, "
            f"model config expects {shape}"
        )


def iter_hf_llama_tensors(ckpt: Checkpoint, cfg: Any) -> Iterator[tuple[tuple, torch.Tensor]]:
    """Yield ((tree path), CPU tensor in our layout) for every weight the
    model needs, shape-checked against ``cfg``; tensors are views of the
    mapped file (transposed views for the matmul weights). A missing
    tensor raises KeyError naming the HF tensor; the tied-embedding
    checkpoint (no ``lm_head.weight``) gives the embedding's transpose."""
    d, f, v = cfg.dim, cfg.hidden_dim, cfg.vocab_size
    kv = cfg.n_kv_heads * cfg.head_dim
    embed = ckpt.torch_tensor("model.embed_tokens.weight")
    _expect_shape("model.embed_tokens.weight", embed, (v, d))
    yield ("embed",), embed
    norm = ckpt.torch_tensor("model.norm.weight")
    _expect_shape("model.norm.weight", norm, (d,))
    yield ("norm_f",), norm
    head = ckpt.torch_tensor("lm_head.weight") if "lm_head.weight" in ckpt else embed
    _expect_shape("lm_head.weight", head, (v, d))
    yield ("lm_head",), head.T
    shapes = {
        "wq": (d, d), "wk": (d, kv), "wv": (d, kv), "wo": (d, d),
        "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d),
        "attn_norm": (d,), "mlp_norm": (d,),
    }
    for i in range(cfg.n_layers):
        for ours, (suffix, transpose) in _LAYER_MAP.items():
            name = f"model.layers.{i}.{suffix}"
            t = ckpt.torch_tensor(name)
            if transpose:
                t = t.T
            _expect_shape(name, t, shapes[ours])
            yield ("layers", ours, i), t


@torch.no_grad()
def load_llama_params(path: str, cfg: Any, quantize: Any = None,
                      device: "torch.device | str" = "cuda") -> Transformer:
    """A ``Transformer`` on ``device`` (the card unless the caller asks for
    the CPU) from an HF Llama safetensors checkpoint. Each tensor crosses
    to the device alone, is cast to ``cfg.dtype`` there and, under
    ``quantize`` (a MODEL_QUANT mode), packed at once through
    ``quantizer_for_key`` (embeddings and norms stay dense; w8a8 keeps
    ``lm_head`` int8): the device holds the model plus one dense weight."""
    model = Transformer(cfg, device, quantize)
    dev = model.device
    ckpt = Checkpoint(path)
    try:
        for tree_path, t in iter_hf_llama_tensors(ckpt, cfg):
            if tree_path[0] == "layers":
                _, name, i = tree_path
                owner = model.layers[i]
            else:
                name, owner = tree_path[0], model
            # the mapped bytes cross as they lie (a transposed view keeps its
            # strides); the transpose and the cast happen on the device
            dense = t.to(dev).to(cfg.dtype)
            model.set_weight(owner, name, dense)
            del dense
        return model
    finally:
        ckpt.close()


def export_llama_hf(model: Transformer) -> dict[str, torch.Tensor]:
    """The inverse mapping: a dense model -> the HF tensor dict (CPU
    tensors, [out, in] for the matmul weights), for writing a checkpoint.
    A quantized model must be dequantized first."""
    def host(t: Any) -> torch.Tensor:
        if isinstance(t, Pack):
            raise ValueError("dequantize the model before export")
        return t.detach().cpu()

    out = {
        "model.embed_tokens.weight": host(model.embed),
        "model.norm.weight": host(model.norm_f),
        "lm_head.weight": host(model.lm_head).T.contiguous(),
    }
    for i, block in enumerate(model.layers):
        for ours, (suffix, transpose) in _LAYER_MAP.items():
            t = host(getattr(block, ours))
            out[f"model.layers.{i}.{suffix}"] = t.T.contiguous() if transpose else t
    return out
