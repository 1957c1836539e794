"""gofr_tpu_torch's checkpoint ingestion (``models/ingest.py``) and
``MODEL_PATH`` against the JAX package on the CPU: ``tests/test_ingest.py``'s
cases held against ``gofr_tpu.models.ingest.load_llama_params`` (the
loaded weights bit-equal for f32 and bf16 files, quantize-during-load
bit-equal for every mode, sharded with an index, the tied embedding,
missing tensors and wrong shapes named, ``is_safetensors_path``), a device
booted through ``MODEL_PATH`` (safetensors, and a ``training/checkpoint.py``
directory), and ``generation_config.json``'s EOS ids as default stops.

The writer oracle is the ``safetensors`` package (the reader under test is
an mmap parser of its own); the JAX side loads trees and never compiles a
model forward, except where a device boots."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import ingest as jing
from gofr_tpu.models import quant as jq
from gofr_tpu.models import transformer as jt
from gofr_tpu.models.llama import TINY as JAX_TINY
from gofr_tpu_torch.config import DECLARED_KEYS, EnvFileConfig
from gofr_tpu_torch.logging import Logger
from gofr_tpu_torch.models import ingest
from gofr_tpu_torch.models.convert import transformer_from_tree, tree_from_transformer
from gofr_tpu_torch.models.llama import TINY
from gofr_tpu_torch.tpu.device import TPUDevice, resolve_default_stop_ids

BF16 = dataclasses.replace(TINY, dtype=torch.bfloat16)
JAX_BF16 = dataclasses.replace(JAX_TINY, dtype=jnp.bfloat16)


@pytest.fixture(scope="module")
def jax_params():
    return jt.init_transformer(jax.random.key(7), JAX_TINY)


@pytest.fixture(scope="module")
def hf_dict(jax_params):
    return jing.export_llama_hf(jax_params, JAX_TINY)


def _save(path, tensors):
    from safetensors.numpy import save_file

    save_file({k: np.ascontiguousarray(v) for k, v in tensors.items()}, str(path))


def _save_torch(path, tensors):
    from safetensors.torch import save_file

    save_file({k: v.contiguous() for k, v in tensors.items()}, str(path))


def _tree_np(tree):
    """A JAX tree as numpy with bf16 widened to f32 and int4 one a byte
    (the form ``tree_from_transformer`` gives)."""
    def leaf(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return a.astype(np.float32)
        if a.dtype.name == "int4":
            return a.astype(np.int8)
        return a
    return jax.tree.map(leaf, tree)


def _assert_tree_equal(got, want):
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_got) == len(flat_want)
    for path, arr in flat_got:
        ref = flat_want[path]
        assert arr.shape == ref.shape and arr.dtype == ref.dtype, (path, arr.dtype, ref.dtype)
        np.testing.assert_array_equal(arr, ref, err_msg=str(path))


def test_safetensors_file_reader(tmp_path, hf_dict):
    path = tmp_path / "model.safetensors"
    _save(path, hf_dict)
    sf = ingest.SafetensorsFile(str(path))
    assert set(sf.names()) == set(hf_dict)
    for name, ref in hf_dict.items():
        got = sf.tensor(name)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(KeyError, match="nope"):
        sf.tensor("nope")
    sf.close()


def test_reader_views_bf16_and_f8_as_torch_dtypes(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {"b": torch.randn(3, 5, generator=g).to(torch.bfloat16),
               "f8": torch.randn(4, 2, generator=g).to(torch.float8_e4m3fn),
               "e5": torch.randn(2, 2, generator=g).to(torch.float8_e5m2),
               "i": torch.arange(6, dtype=torch.int32).reshape(2, 3)}
    path = tmp_path / "m.safetensors"
    _save_torch(path, tensors)
    ckpt = ingest.Checkpoint(str(path))
    for name, ref in tensors.items():
        got = ckpt.torch_tensor(name)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert torch.equal(got.view(torch.uint8), ref.view(torch.uint8))
    # the JAX reader gives the same bits (ml_dtypes arrays)
    jf = jing.SafetensorsFile(str(path))
    np.testing.assert_array_equal(ckpt.tensor("b"), np.asarray(jf.tensor("b")).view(np.uint16))
    np.testing.assert_array_equal(ckpt.tensor("f8"), np.asarray(jf.tensor("f8")).view(np.uint8))
    jf.close()
    ckpt.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_bit_equal_to_jax(tmp_path, jax_params, dtype):
    jcfg, cfg = (JAX_TINY, TINY) if dtype == "float32" else (JAX_BF16, BF16)
    params = jax.tree.map(lambda a: a.astype(jcfg.dtype), jax_params)
    hf = jing.export_llama_hf(params, jcfg)
    path = tmp_path / "model.safetensors"
    if dtype == "float32":
        _save(path, hf)
    else:
        _save_torch(path, {k: torch.from_numpy(np.asarray(v).view(np.uint16).copy())
                           .view(torch.bfloat16) for k, v in hf.items()})
    model = ingest.load_llama_params(str(path), cfg, device="cpu")
    assert model.embed.dtype == cfg.dtype
    _assert_tree_equal(tree_from_transformer(model),
                       _tree_np(jing.load_llama_params(str(path), jcfg)))


def test_load_roundtrips_the_forward(tmp_path, jax_params, hf_dict):
    path = tmp_path / "model.safetensors"
    _save(path, hf_dict)
    model = ingest.load_llama_params(str(path), TINY, device="cpu")
    tokens = np.asarray([[5, 3, 8, 1, 9, 2]], np.int32)
    ref = transformer_from_tree(jax.tree.map(np.asarray, jax_params), TINY, device="cpu")
    np.testing.assert_array_equal(model(torch.from_numpy(tokens)).numpy(),
                                  ref(torch.from_numpy(tokens)).numpy())


def test_load_sharded_with_index(tmp_path, hf_dict):
    names = sorted(hf_dict)
    half = len(names) // 2
    shard_of = {}
    for shard, chunk in (("model-00001-of-00002.safetensors", names[:half]),
                         ("model-00002-of-00002.safetensors", names[half:])):
        _save(tmp_path / shard, {n: hf_dict[n] for n in chunk})
        for n in chunk:
            shard_of[n] = shard
    with open(tmp_path / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": shard_of}, f)
    model = ingest.load_llama_params(str(tmp_path), TINY, device="cpu")
    _assert_tree_equal(tree_from_transformer(model),
                       _tree_np(jing.load_llama_params(str(tmp_path), JAX_TINY)))


def test_missing_tensor_named(tmp_path, hf_dict):
    broken = {k: v for k, v in hf_dict.items() if k != "model.layers.1.mlp.down_proj.weight"}
    path = tmp_path / "model.safetensors"
    _save(path, broken)
    with pytest.raises(KeyError, match="model.layers.1.mlp.down_proj.weight"):
        ingest.load_llama_params(str(path), TINY, device="cpu")


def test_shape_mismatch_named(tmp_path, hf_dict):
    path = tmp_path / "model.safetensors"
    _save(path, hf_dict)
    with pytest.raises(ValueError, match="gate_proj"):
        ingest.load_llama_params(str(path), dataclasses.replace(TINY, hidden_dim=96),
                                 device="cpu")


def test_tied_embeddings_fallback(tmp_path, hf_dict):
    tied = {k: v for k, v in hf_dict.items() if k != "lm_head.weight"}
    path = tmp_path / "model.safetensors"
    _save(path, tied)
    model = ingest.load_llama_params(str(path), TINY, device="cpu")
    assert torch.equal(model.lm_head, model.embed.T)
    _assert_tree_equal(tree_from_transformer(model),
                       _tree_np(jing.load_llama_params(str(path), JAX_TINY)))


@pytest.mark.parametrize("mode", ["int8", "int4", "w8a8"])
def test_quantize_during_load_bit_equal_to_jax(tmp_path, hf_dict, mode):
    path = tmp_path / "model.safetensors"
    _save(path, hf_dict)
    model = ingest.load_llama_params(str(path), TINY, quantize=mode, device="cpu")
    assert model.quant == mode
    want = jing.load_llama_params(str(path), JAX_TINY, quantize=mode)
    assert set(want["layers"]["wq"]) == set(model.layers[0].wq.names)
    _assert_tree_equal(tree_from_transformer(model), _tree_np(want))
    # and equal to quantizing the dense load afterwards
    dense = ingest.load_llama_params(str(path), TINY, device="cpu").quantized(mode)
    for (k, a), (_, b) in zip(model.state_dict().items(), dense.state_dict().items()):
        assert torch.equal(a, b), k


def test_iter_covers_full_tree(tmp_path, hf_dict):
    path = tmp_path / "model.safetensors"
    _save(path, hf_dict)
    ckpt = ingest.Checkpoint(str(path))
    paths = [p for p, _ in ingest.iter_hf_llama_tensors(ckpt, TINY)]
    ckpt.close()
    jck = jing.Checkpoint(str(path))
    assert paths == [p for p, _ in jing.iter_hf_llama_tensors(jck, JAX_TINY)]
    jck.close()
    assert len(paths) == 3 + 9 * TINY.n_layers


def test_is_safetensors_path(tmp_path, hf_dict):
    f = tmp_path / "model.safetensors"
    _save(f, hf_dict)
    other = tmp_path / "ckpt"
    other.mkdir()
    for p in (str(f), str(tmp_path), None, "", str(other)):
        assert ingest.is_safetensors_path(p) == jing.is_safetensors_path(p), p
    assert ingest.is_safetensors_path(str(tmp_path)) and not ingest.is_safetensors_path(str(other))


def test_export_equals_jax_export(jax_params, hf_dict):
    model = transformer_from_tree(jax.tree.map(np.asarray, jax_params), TINY, device="cpu")
    out = ingest.export_llama_hf(model)
    assert set(out) == set(hf_dict)
    for name, ref in hf_dict.items():
        np.testing.assert_array_equal(out[name].numpy(), np.asarray(ref), err_msg=name)
    with pytest.raises(ValueError, match="dequantize"):
        ingest.export_llama_hf(model.quantized("int8"))


# -- MODEL_PATH ----------------------------------------------------------------------------

def _with_env(env, fn):
    keys = set(DECLARED_KEYS) | set(env)
    old = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


BASE = {"MODEL_NAME": "tiny", "BATCH_MAX_SIZE": "2", "BATCH_TIMEOUT_MS": "1",
        "DECODE_CHUNK": "4"}


def _port_device(**env):
    return _with_env({**BASE, "TORCH_DEVICE": "cpu", **env},
                     lambda: TPUDevice(EnvFileConfig("/nonexistent"), Logger()))


def _jax_device(**env):
    from gofr_tpu.config import EnvConfig
    from gofr_tpu.logging import Level
    from gofr_tpu.metrics import Registry
    from gofr_tpu.testutil import MockLogger
    from gofr_tpu.tpu.device import new_device

    def build():
        dev = new_device(EnvConfig(), MockLogger(Level.ERROR), Registry())
        dev.wait_ready(600)
        return dev

    return _with_env({**BASE, **env}, build)


@pytest.mark.parametrize("quant", ["", "int8"])
def test_device_boots_from_safetensors(tmp_path, hf_dict, quant):
    path = tmp_path / "model.safetensors"
    _save(path, hf_dict)
    jdev = _jax_device(MODEL_PATH=str(path), MODEL_QUANT=quant, DECODE_POOL="off")
    tdev = _port_device(MODEL_PATH=str(path), MODEL_QUANT=quant)
    try:
        assert tdev.runner.model.quant == (quant or None)
        _assert_tree_equal(tree_from_transformer(tdev.runner.model),
                           _tree_np(jdev.runner.params))
        for prompt in ([5, 3, 8, 1, 9, 2], [40, 41]):
            assert tdev.generate(prompt, 8) == jdev.generate(prompt, max_new_tokens=8)
    finally:
        tdev.close()
        jdev.close()


def test_device_boots_from_a_torch_checkpoint(tmp_path):
    from gofr_tpu_torch.models.transformer import Transformer
    from gofr_tpu_torch.training.checkpoint import save_params

    src = Transformer.random(TINY, "cpu", 11)
    save_params(str(tmp_path / "ck"), src.state_dict())
    dev = _port_device(MODEL_PATH=str(tmp_path / "ck"), MODEL_QUANT="int4", DECODE_POOL="off")
    try:
        want = src.quantized("int4").state_dict()
        for k, v in dev.runner.model.state_dict().items():
            assert torch.equal(v, want[k]), k
    finally:
        dev.close()


def test_an_unreadable_model_path_fails_the_boot(tmp_path):
    with pytest.raises(FileNotFoundError):
        _port_device(MODEL_PATH=str(tmp_path / "missing"))
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes((10 ** 9).to_bytes(8, "little") + b"{}")
    with pytest.raises(ValueError, match="corrupt safetensors header"):
        _port_device(MODEL_PATH=str(bad))


class _Cfg:
    def __init__(self, **values):
        self.values = values

    def get(self, key):
        return self.values.get(key)

    def get_or_default(self, key, default):
        value = self.values.get(key)
        return value if value not in (None, "") else default


class _Tok:
    def special_id(self, name):
        return 255


@pytest.mark.parametrize("eos,want", [(7, {7}), ([128001, 128009], {128001, 128009}),
                                      ("x", {255})], ids=["int", "list", "other"])
def test_generation_config_eos_ids(tmp_path, eos, want):
    from gofr_tpu.tpu.device import _checkpoint_eos_ids

    (tmp_path / "generation_config.json").write_text(json.dumps({"eos_token_id": eos}))
    path = str(tmp_path)
    assert resolve_default_stop_ids(_Cfg(MODEL_PATH=path), _Tok()) == frozenset(want)
    assert set(want) == _checkpoint_eos_ids(path, _Tok())
    # a file MODEL_PATH reads the generation_config.json beside it
    f = str(tmp_path / "model.safetensors")
    assert resolve_default_stop_ids(_Cfg(MODEL_PATH=f), _Tok()) == frozenset(want)
    # GEN_STOP_TOKENS and GEN_STOP_EOS=off win, in the JAX order
    assert resolve_default_stop_ids(_Cfg(MODEL_PATH=path, GEN_STOP_TOKENS="3,4"),
                                    _Tok()) == frozenset({3, 4})
    assert resolve_default_stop_ids(_Cfg(MODEL_PATH=path, GEN_STOP_EOS="off",
                                         GEN_STOP_TOKENS="3"), _Tok()) == frozenset()
    assert resolve_default_stop_ids(_Cfg(), _Tok()) == frozenset({255})


def test_unreadable_generation_config_fails_the_boot(tmp_path, hf_dict):
    _save(tmp_path / "model.safetensors", hf_dict)
    (tmp_path / "generation_config.json").write_text("{not json")
    with pytest.raises(ValueError, match="generation_config.json"):
        _port_device(MODEL_PATH=str(tmp_path))
    # an explicit GEN_STOP_TOKENS never reads it
    dev = _port_device(MODEL_PATH=str(tmp_path), GEN_STOP_TOKENS="9", DECODE_POOL="off")
    try:
        assert dev.default_stop_ids == frozenset({9})
    finally:
        dev.close()


def test_generation_config_stops_a_served_request(tmp_path, hf_dict):
    _save(tmp_path / "model.safetensors", hf_dict)
    probe = _port_device(MODEL_PATH=str(tmp_path), DECODE_POOL="off")
    try:
        ids = probe.generate([5, 3, 8, 1, 9, 2], 8)
    finally:
        probe.close()
    (tmp_path / "generation_config.json").write_text(
        json.dumps({"eos_token_id": [ids[3], 100000]}))
    dev = _port_device(MODEL_PATH=str(tmp_path))
    try:
        assert dev.default_stop_ids == frozenset({ids[3], 100000})
        assert dev.generate([5, 3, 8, 1, 9, 2], 8) == ids[: ids.index(ids[3])]
    finally:
        dev.close()


def test_model_path_and_a_given_model_exclude_each_other(tmp_path, hf_dict):
    from gofr_tpu_torch.models.transformer import Transformer

    _save(tmp_path / "model.safetensors", hf_dict)
    with pytest.raises(ValueError, match="MODEL_PATH"):
        _with_env({**BASE, "TORCH_DEVICE": "cpu", "MODEL_PATH": str(tmp_path)},
                  lambda: TPUDevice(EnvFileConfig("/nonexistent"), Logger(),
                                    model=Transformer.random(TINY, "cpu", 0)))
    assert jq.quantizer_for("int8") is not None  # the JAX package untouched
