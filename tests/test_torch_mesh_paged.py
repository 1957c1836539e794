"""Sharded serving on the port (``TPU_MESH``), case for case against the JAX
package's ``tests/test_mesh_paged.py``, ``tests/test_mesh_validation.py``
and the host-mesh cases of ``tests/test_paged_echo.py``.

With ``TPU_MESH=tp=2`` over the CPU's 8 virtual devices (conftest's
``XLA_FLAGS``, which ``parallel/mesh.py::visible_devices`` reads), pooled
decode, solo decode, prefix-cache hits and chunked prefill give the same
greedy ids as the port's unsharded device AND as a JAX ``TPU_MESH=tp=2``
device on the same weights, exactly, with paged KV active (the block
arena's heads split over tp). Validation fails at boot with the JAX
package's messages, naming the axis. The echo runner's host-mesh mode
splits every block's tokens over the tp fake devices.
"""

import os

import jax
import numpy as np
import pytest

from gofr_tpu_torch.config import DECLARED_KEYS, EnvFileConfig
from gofr_tpu_torch.logging import Level
from gofr_tpu_torch.metrics import Registry
from gofr_tpu_torch.models.convert import transformer_from_tree
from gofr_tpu_torch.models.llama import TINY
from gofr_tpu_torch.ops.sampling import Sampler
from gofr_tpu_torch.parallel.sharding import ShardedKV
from gofr_tpu_torch.telemetry import FlightRecorder, activate_record
from gofr_tpu_torch.testutil import MockLogger
from gofr_tpu_torch.tpu.device import TPUDevice, _parse_mesh_request

PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]
# longer than the single bucket (64): the chunked-prefill path
LONG_PROMPT = [(7 * i) % 250 + 1 for i in range(80)]

# the JAX case's configuration: ONE bucket and a 2-slot pool
_BASE = {
    "MODEL_NAME": "tiny", "BATCH_MAX_SIZE": "2", "BATCH_TIMEOUT_MS": "1",
    "MODEL_BUCKETS": "64", "DECODE_SLOTS": "2", "PREFIX_CACHE": "2",
}


def _with_env(env, fn):
    keys = set(DECLARED_KEYS) | set(env)
    old = {k: os.environ.get(k) for k in keys if k != "XLA_FLAGS"}
    for k in old:
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


def _port(model=None, **env):
    return _with_env({**_BASE, "TORCH_DEVICE": "cpu", **env},
                     lambda: TPUDevice(EnvFileConfig("/nonexistent"), MockLogger(Level.INFO),
                                       model=model, metrics=Registry()))


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX package's tp=2 device: the reference ids and the weights."""
    from gofr_tpu.config import EnvConfig
    from gofr_tpu.logging import Level as JaxLevel
    from gofr_tpu.metrics import Registry as JaxRegistry
    from gofr_tpu.testutil import MockLogger as JaxLogger
    from gofr_tpu.tpu.device import new_device

    dev = _with_env({**_BASE, "TPU_MESH": "tp=2"},
                    lambda: new_device(EnvConfig(), JaxLogger(JaxLevel.ERROR), JaxRegistry()))
    dev.wait_ready(600)
    yield dev
    dev.close()


@pytest.fixture(scope="module")
def model(jax_sharded):
    return transformer_from_tree(jax.tree.map(np.asarray, jax_sharded.runner.params), TINY,
                                 device="cpu")


@pytest.fixture(scope="module")
def plain(model):
    d = _port(model)
    yield d
    d.close()


@pytest.fixture(scope="module")
def sharded(model):
    d = _port(model, TPU_MESH="tp=2")
    yield d
    d.close()


def test_paged_kv_active_under_tp_mesh(sharded):
    # KV_PAGED=on is on: no fallback to the slot model under the mesh
    assert sharded.kv_pool is not None
    assert sharded.runner.kv_paged_disabled == ""
    store = sharded.runner._paged_prefix
    assert store is not None
    # the block arena is sharded: k and v hold one head slice per tp device
    for arena in (store.arena.k, store.arena.v):
        assert isinstance(arena, ShardedKV)
        (gid, shards), = arena.groups
        assert len(shards) == 2 and all(t.shape[3] == TINY.n_kv_heads // 2 for t in shards)
    assert store.arena.mesh is sharded.mesh


def test_pooled_bit_identity(plain, sharded, jax_sharded):
    assert sharded.decode_pool is not None
    a = plain.generate(PROMPT, max_new_tokens=8)
    b = sharded.generate(PROMPT, max_new_tokens=8)
    assert a == b == jax_sharded.generate(PROMPT, max_new_tokens=8)


def test_solo_bit_identity(plain, sharded, jax_sharded):
    # a SEEDED greedy sampler bypasses the pool: the solo chunked decode
    from gofr_tpu.ops.sampling import Sampler as JaxSampler

    a = plain.generate(PROMPT, max_new_tokens=8, sampler=Sampler(seed=7))
    b = sharded.generate(PROMPT, max_new_tokens=8, sampler=Sampler(seed=7))
    assert a == b == jax_sharded.generate(PROMPT, max_new_tokens=8, sampler=JaxSampler(seed=7))


def test_prefix_hit_bit_identity(plain, sharded, jax_sharded):
    # the second serve rides the paged prefix cache (blocks gathered from
    # the SHARDED arena) and must not drift
    prompt = [11, 13, 17, 19, 23, 29, 31, 37]
    a1 = plain.generate(prompt, max_new_tokens=8)
    b1 = sharded.generate(prompt, max_new_tokens=8)
    hits_before = sharded.runner.prefix_stats["hits"]
    a2 = plain.generate(prompt, max_new_tokens=8)
    b2 = sharded.generate(prompt, max_new_tokens=8)
    assert a1 == b1 and a2 == b2 and a1 == a2
    assert b1 == jax_sharded.generate(prompt, max_new_tokens=8)
    assert sharded.runner.prefix_stats["hits"] > hits_before


def test_chunked_prefill_bit_identity(plain, sharded, jax_sharded):
    # 80 tokens through the 64-wide bucket: sliced on both topologies
    a = plain.generate(LONG_PROMPT, max_new_tokens=8)
    b = sharded.generate(LONG_PROMPT, max_new_tokens=8)
    assert a == b == jax_sharded.generate(LONG_PROMPT, max_new_tokens=8)


def test_admin_engine_mesh_and_kv_blocks(sharded, jax_sharded):
    snap = sharded.engine_snapshot()
    assert snap["mesh"] == {"axes": {"tp": 2}, "devices": 2}
    assert snap["mesh"] == jax_sharded.engine_snapshot()["mesh"]
    kv = snap["kv_blocks"]
    assert kv is not None and kv["total"] > 0
    assert kv["block_tokens"] == 64
    # the decode pool shares the same ledger and reports its mesh
    assert snap["decode_pool"]["mesh_axes"] == {"tp": 2}
    assert snap["decode_pool"]["kv"]["total"] == kv["total"]
    assert "mesh={'dp': 1, 'fsdp': 1, 'sp': 1, 'pp': 1, 'ep': 1, 'tp': 2}" in sharded.describe()


def test_mesh_axis_gauge_and_flight_record(sharded):
    assert sharded._mesh_axis_gauge.value(axis="tp") == 2.0
    assert sharded._mesh_axis_gauge.value(axis="dp") == 1.0
    recorder = FlightRecorder()
    rec = recorder.start(model="tiny", endpoint="/t")
    try:
        sharded.generate(PROMPT, max_new_tokens=2)
    finally:
        recorder.finish(rec)
        activate_record(None)
    assert rec.mesh_axes == {"tp": 2}
    assert rec.to_dict()["mesh_axes"] == {"tp": 2}


def test_no_mesh_degrade_counted_for_tp_only(sharded, plain):
    for feature in ("kv_paged", "chunked_prefill", "decode_pool"):
        assert sharded._mesh_degrade.value(feature=feature) == 0
        assert plain._mesh_degrade.value(feature=feature) == 0


def test_dp_mesh_degrades_paged_kv_with_metric(model):
    """A dp mesh cannot carry paged KV (one row's cache would split over the
    row groups): it degrades to the row model loudly, reason and count."""
    d = _port(model, TPU_MESH="dp=2")
    try:
        assert d.kv_pool is None
        assert "dp/fsdp" in d.runner.kv_paged_disabled
        assert d._mesh_degrade.value(feature="kv_paged") == 1
        assert len(d.generate(PROMPT, max_new_tokens=4)) == 4
        snap = d.engine_snapshot()
        assert snap["mesh"] == {"axes": {"dp": 2}, "devices": 2}
        assert snap["kv_blocks"] is None
    finally:
        d.close()


# -- validation (tests/test_mesh_validation.py) ---------------------------------

def _boot(**env):
    defaults = {"MODEL_NAME": "echo", "BATCH_MAX_SIZE": "4", "BATCH_TIMEOUT_MS": "1",
                "TORCH_DEVICE": "cpu"}
    defaults.update(env)
    return _with_env(defaults, lambda: TPUDevice(EnvFileConfig("/nonexistent"),
                                                 MockLogger(Level.INFO), metrics=Registry()))


def test_malformed_entry_fails_at_construction():
    with pytest.raises(ValueError, match="tp=abc"):
        _boot(TPU_MESH="tp=abc")


def test_unsupported_axis_names_the_axis():
    with pytest.raises(ValueError, match="'pp' not supported"):
        _boot(TPU_MESH="pp=2")


def test_mesh_larger_than_visible_devices():
    # 8 virtual devices cannot host tp=64: the probe names the counts
    with pytest.raises(ValueError, match="needs 64 devices, have 8"):
        _boot(TPU_MESH="tp=64")


def test_tp_not_dividing_kv_heads_fails_before_params_load(monkeypatch):
    from gofr_tpu_torch.tpu import device as device_mod

    def no_load(*a, **k):
        raise AssertionError("the weights loaded before the mesh was validated")

    monkeypatch.setattr(device_mod, "load_model", no_load)
    with pytest.raises(ValueError, match=r"n_kv_heads=2 not divisible by tp=4"):
        _boot(MODEL_NAME="tiny", TPU_MESH="tp=4,dp=2")


def test_dp_not_dividing_batch_fails_at_boot():
    with pytest.raises(ValueError, match=r"dp\*fsdp=4"):
        _boot(MODEL_NAME="tiny", BATCH_MAX_SIZE="2", TPU_MESH="dp=4")


def test_tp_not_dividing_block_tokens_fails_echo_boot():
    with pytest.raises(ValueError, match="tp=4 does not divide KV_BLOCK_TOKENS=6"):
        _boot(TPU_MESH="tp=4", KV_BLOCK_TOKENS="6", KV_BLOCKS="16")


def test_parse_is_the_single_grammar():
    assert _parse_mesh_request("tp=2,dp=2") == {"tp": 2, "dp": 2}
    assert _parse_mesh_request("") is None
    assert _parse_mesh_request("2x4") is None  # a physical grid
    with pytest.raises(ValueError, match="malformed"):
        _parse_mesh_request("tp=")


# -- host-mesh mode (tests/test_paged_echo.py) -----------------------------------

def _echo(**env):
    return _boot(BATCH_MAX_SIZE="8", BATCH_TIMEOUT_MS="2", **env)


def test_host_mesh_shards_block_tables_bit_identically():
    """TPU_MESH=tp=2 on the echo runner: block tables span 2 fake devices,
    every shard takes writes, and the output equals the unsharded paged
    runner's; the JAX package's host-mesh echo gives the same ids and the
    same writes on each fake device."""
    from gofr_tpu.config import EnvConfig
    from gofr_tpu.logging import Level as JaxLevel
    from gofr_tpu.metrics import Registry as JaxRegistry
    from gofr_tpu.testutil import MockLogger as JaxLogger
    from gofr_tpu.tpu.device import new_device

    env = {"KV_BLOCKS": "64", "KV_BLOCK_TOKENS": "4", "PREFIX_LCP_MIN": "4"}
    meshed = _echo(TPU_MESH="tp=2", **env)
    plain = _echo(**env)
    jax_meshed = _with_env(
        {"MODEL_NAME": "echo", "BATCH_MAX_SIZE": "8", "BATCH_TIMEOUT_MS": "2", "TPU_MESH": "tp=2",
         **env}, lambda: new_device(EnvConfig(), JaxLogger(JaxLevel.ERROR), JaxRegistry()))
    try:
        arena = meshed.runner.paged.arena
        assert arena.shards == 2
        assert meshed.runner.mesh_axes == {"tp": 2}
        for p in ([1, 2, 3, 4, 5], [1, 2, 3, 4, 5], [1, 2, 3, 4, 6, 7, 8, 9]):
            got = meshed.generate(p, max_new_tokens=6)
            assert got == plain.generate(p, max_new_tokens=6)
            assert got == jax_meshed.generate(p, max_new_tokens=6)
        assert all(n > 0 for n in arena.shard_writes)
        assert arena.shard_writes == jax_meshed.runner.paged.arena.shard_writes
    finally:
        jax_meshed.close()
        plain.close()
        meshed.close()


def test_host_mesh_observability_surfaces():
    dev = _echo(TPU_MESH="tp=2", KV_BLOCKS="64", KV_BLOCK_TOKENS="4")
    try:
        snap = dev.engine_snapshot()
        assert snap["mesh"] == {"axes": {"tp": 2}, "devices": 2}
        assert snap["kv_blocks"] is not None and snap["kv_blocks"]["total"] == 64
        assert 'gofr_tpu_mesh_axis_size{axis="tp"} 2' in dev.metrics.expose()
        recorder = FlightRecorder()
        rec = recorder.start(model="echo", endpoint="/m")
        try:
            dev.generate([5, 6, 7, 8], max_new_tokens=4)
        finally:
            recorder.finish(rec)
            activate_record(None)
        assert rec.mesh_axes == {"tp": 2}
        assert rec.to_dict()["mesh_axes"] == {"tp": 2}
    finally:
        dev.close()


def test_host_mesh_kv_exhaustion_still_degrades_cleanly():
    # 4 blocks x 4 tokens: a long generation cannot reserve its budget
    dev = _echo(TPU_MESH="tp=2", KV_BLOCKS="4", KV_BLOCK_TOKENS="4")
    try:
        out = dev.generate([1, 2, 3, 4, 5, 6, 7, 8], max_new_tokens=32)
        assert len(out) == 32  # served despite the reject
        reject = next(
            ln for ln in dev.metrics.expose().splitlines()
            if ln.startswith('gofr_tpu_pool_reject_total{reason="kv_exhausted"}')
        )
        assert float(reject.rsplit(" ", 1)[1]) >= 1
    finally:
        dev.close()
