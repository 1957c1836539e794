"""The last public names of gofr_tpu in gofr_tpu_torch, each against the
JAX package's.

- ``errors.py``: ``MissingParamError`` (400), ``ForbiddenError`` (403) and
  ``RequestTimeoutError`` (408): status and message equal for the same
  arguments, and over HTTP a handler raising each gets the JAX app's
  status and body.
- ``gofr_tpu_torch.tpu`` exports ``TPUDevice``, ``TPULog`` and
  ``new_device(config, logger, metrics)``; ``gofr_tpu_torch.models`` and
  ``gofr_tpu_torch.ops`` have an ``__all__`` whose names resolve.
- ``deadline.BROWNOUT_LEVELS``, ``ops/sampling.py::sample_logits`` (greedy
  and top-k 1 equal JAX's argmax; a sample lies in the top k),
  ``models/lora.py::is_lora_stack``, ``anomaly.py::AnomalyRing.total`` and
  ``tpu/kv_blocks.py::BlockPool.cache_discard`` (the same pool stats as the
  JAX pool's after the same calls).
"""

import http.client
import json
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gofr_tpu
import gofr_tpu_torch
from gofr_tpu import errors as jerrors
from gofr_tpu.config import DECLARED_KEYS as JAX_KEYS
from gofr_tpu_torch import errors as terrors
from gofr_tpu_torch.config import DECLARED_KEYS

ERRORS = [("MissingParamError", ("id",)), ("MissingParamError", ("id", "name")),
          ("MissingParamError", ()), ("ForbiddenError", ()), ("ForbiddenError", ("no, you",)),
          ("RequestTimeoutError", ()), ("RequestTimeoutError", ("slow upstream",))]


@pytest.mark.parametrize("name,args", ERRORS)
def test_error_status_and_message_equal_jax(name, args):
    want, got = getattr(jerrors, name)(*args), getattr(terrors, name)(*args)
    assert got.status_code == want.status_code
    assert str(got) == str(want) and got.message == want.message
    assert isinstance(got, terrors.GofrError)
    assert terrors.status_from_error(got) == jerrors.status_from_error(want)
    if hasattr(want, "params"):
        assert got.params == want.params


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    built = []
    with pytest.MonkeyPatch.context() as mp:
        for key in set(JAX_KEYS) | set(DECLARED_KEYS):
            mp.delenv(key, raising=False)
        mp.setenv("LOG_LEVEL", "FATAL")
        for pkg, errors in ((gofr_tpu, jerrors), (gofr_tpu_torch, terrors)):
            mp.setenv("HTTP_PORT", str(_free_port()))
            mp.chdir(tmp_path_factory.mktemp("names"))
            app = pkg.new()
            for i, (name, args) in enumerate(ERRORS):
                def handler(ctx, cls=getattr(errors, name), a=args):
                    raise cls(*a)

                app.get(f"/err/{i}", handler)
            app.start()
            built.append(app)
    yield built
    for app in built:
        app.shutdown()


@pytest.mark.parametrize("i", range(len(ERRORS)))
def test_a_raised_error_answers_as_jax(apps, i):
    out = []
    for app in apps:
        conn = http.client.HTTPConnection("127.0.0.1", app.http_port, timeout=10)
        try:
            conn.request("GET", f"/err/{i}")
            resp = conn.getresponse()
            out.append((resp.status, json.loads(resp.read())))
        finally:
            conn.close()
    assert out[1] == out[0]
    assert out[1][0] == getattr(terrors, ERRORS[i][0]).status_code


def test_the_tpu_package_exports_the_device():
    import gofr_tpu.tpu as jtpu
    import gofr_tpu_torch.tpu as ttpu
    from gofr_tpu_torch.config import EnvFileConfig
    from gofr_tpu_torch.logging import Level, Logger
    from gofr_tpu_torch.metrics import Registry
    from gofr_tpu_torch.tpu import device

    assert ttpu.__all__ == jtpu.__all__
    assert ttpu.TPUDevice is device.TPUDevice and ttpu.TPULog is device.TPULog
    with pytest.raises(AttributeError):
        ttpu.not_a_name  # noqa: B018
    with pytest.MonkeyPatch.context() as mp:
        for key in set(JAX_KEYS) | set(DECLARED_KEYS):
            mp.delenv(key, raising=False)
        mp.setenv("MODEL_NAME", "echo")
        metrics = Registry()
        dev = ttpu.new_device(EnvFileConfig("/nonexistent"), Logger(Level.FATAL), metrics)
        try:
            assert isinstance(dev, ttpu.TPUDevice) and dev.metrics is metrics and dev.ready()
        finally:
            dev.close()


def test_package_all_names_resolve():
    import importlib

    for pkg in ("models", "ops"):
        jmod = importlib.import_module(f"gofr_tpu.{pkg}")
        tmod = importlib.import_module(f"gofr_tpu_torch.{pkg}")
        assert tmod.__all__ and all(getattr(tmod, name) is not None for name in tmod.__all__)
        # the functions the port made a class's methods are the Transformer's
        same = set(jmod.__all__) & set(tmod.__all__)
        moved = set(jmod.__all__) - same
        assert moved <= {"init_transformer", "transformer_forward", "prefill", "decode_step",
                         "init_cache"}
        for name in moved:
            assert hasattr(tmod.Transformer, "random" if name == "init_transformer" else name)


def test_brownout_levels_equal_jax():
    from gofr_tpu import deadline as jd
    from gofr_tpu_torch import deadline as td

    assert td.BROWNOUT_LEVELS == jd.BROWNOUT_LEVELS == (0, 1, 2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_logits_matches_jax(seed):
    from gofr_tpu.ops.sampling import sample_logits as jsample
    from gofr_tpu_torch.ops.sampling import sample_logits

    logits = np.random.default_rng(seed).normal(size=(4, 50)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    gen = torch.Generator().manual_seed(seed)
    want = np.asarray(jsample(jnp.asarray(logits), key, 0.0))
    got = sample_logits(torch.from_numpy(logits), gen, 0.0)
    assert got.dtype == torch.int32 and got.tolist() == want.tolist()
    # top_k 1 at temperature 1 is the argmax too, whatever the draw
    want = np.asarray(jsample(jnp.asarray(logits), key, 1.0, 1))
    assert sample_logits(torch.from_numpy(logits), gen, 1.0, 1).tolist() == want.tolist()
    drawn = sample_logits(torch.from_numpy(logits), gen, 0.7, 5)
    top5 = np.argsort(-logits, axis=-1)[:, :5]
    assert all(int(t) in row for t, row in zip(drawn, top5))


def test_is_lora_stack():
    from gofr_tpu.models.lora import is_lora_stack as jis
    from gofr_tpu_torch.models.llama import TINY
    from gofr_tpu_torch.models.lora import (
        LoraStack,
        LoraWeight,
        add_lora,
        build_lora_stack,
        is_lora_stack,
    )
    from gofr_tpu_torch.models.transformer import Transformer

    base = Transformer.random(TINY, "cpu", 0)
    wrapped = add_lora(base, seed=1, rank=2)
    stacked = build_lora_stack(base, {"a": wrapped})
    stacks = [m for m in stacked.modules() if isinstance(m, LoraStack)]
    loras = [m for m in wrapped.modules() if isinstance(m, LoraWeight)]
    assert stacks and all(is_lora_stack(m) for m in stacks)
    assert loras and not any(is_lora_stack(m) for m in loras)
    assert not is_lora_stack(base.lm_head) and not is_lora_stack({"lora_stack_a": 1})
    assert jis({"lora_stack_a": 1}) and not jis({"lora_a": 1})


def test_anomaly_ring_total_equals_jax():
    from gofr_tpu.anomaly import AnomalyRing as JaxRing
    from gofr_tpu_torch.anomaly import AnomalyRing

    rings = (JaxRing(3), AnomalyRing(3))
    for ring in rings:
        assert ring.total() == 0
        for i in range(5):
            ring.record(kind="prefill", cause="slow_dispatch", dispatch_id=i)
    assert rings[1].total() == rings[0].total() == 5
    assert rings[1].stats()["retained"] == 3


def test_block_pool_cache_discard_equals_jax():
    from gofr_tpu.tpu.kv_blocks import BlockPool as JaxPool
    from gofr_tpu_torch.tpu.kv_blocks import BlockPool

    stats = []
    for cls in (JaxPool, BlockPool):
        pool = cls(16, 8, cache_entries=4)
        for key, n in ((b"a", 20), (b"b", 9), (b"c", 30)):
            pool.cache_put(key, pool.reserve(n), {"n": n})
        pool.cache_discard(b"b")
        pool.cache_discard(b"missing")  # no entry: nothing moves
        assert pool.cache_lookup(b"b") is None and pool.cache_lookup(b"a") is not None
        pool.cache_discard(b"a")
        stats.append(pool.stats())
    assert stats[1] == stats[0]
    assert stats[1]["evictions"] == 0
