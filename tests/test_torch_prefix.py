"""The port's ``TPUDevice`` with the JAX package's default serving
configuration (decode pool and paged KV on, here with a prefix cache;
and with KV_PAGED=off, the row store) against the JAX ``TPUDevice`` on the
CPU: the JAX runner's tiny-model
weights cross to the port through ``models/convert.py``, and both devices
must give equal greedy ids for concurrent requests, an exact repeat, a
shared-prefix (LCP) hit, a multi-turn follow-up, a prompt longer than the
largest bucket (prefilled in slices, not clipped) and a prompt over
``PREFILL_CHUNK_TOKENS``. The JAX device's Pallas path is not used: tiny
runs its XLA attention, as the JAX package's own CPU tests do."""

import os
import threading

import jax
import numpy as np
import pytest

from gofr_tpu_torch.config import DECLARED_KEYS, EnvFileConfig
from gofr_tpu_torch.logging import Logger
from gofr_tpu_torch.models.convert import transformer_from_tree
from gofr_tpu_torch.models.llama import TINY
from gofr_tpu_torch.tpu.device import TPUDevice

ENV = {"MODEL_NAME": "tiny", "BATCH_MAX_SIZE": "4", "BATCH_TIMEOUT_MS": "2",
       "DECODE_SLOTS": "4", "DECODE_CHUNK": "4", "MODEL_BUCKETS": "16,32",
       "PREFIX_CACHE": "4", "PREFIX_LCP_MIN": "4", "KV_BLOCK_TOKENS": "16"}
SYSTEM = [7, 3, 9, 2, 11, 5, 8, 1]


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


def _jax_device(env):
    from gofr_tpu.config import EnvConfig
    from gofr_tpu.logging import Level
    from gofr_tpu.metrics import Registry
    from gofr_tpu.testutil import MockLogger
    from gofr_tpu.tpu.device import new_device

    def build():
        dev = new_device(EnvConfig(), MockLogger(Level.ERROR), Registry())
        dev.wait_ready(600)
        return dev

    return _with_env(env, build)


@pytest.fixture(scope="module", params=[
    {}, {"PREFILL_CHUNK_TOKENS": "16"}, {"KV_PAGED": "off"},
], ids=["paged", "paged-chunk-budget-16", "row-store"])
def pair(request):
    """(JAX device, port device) on the same weights and configuration."""
    env = {**ENV, **request.param}
    jdev = _jax_device(env)
    model = transformer_from_tree(jax.tree.map(np.asarray, jdev.runner.params), TINY,
                                  device="cpu")
    tdev = _with_env({**env, "TORCH_DEVICE": "cpu"},
                     lambda: TPUDevice(EnvFileConfig("/nonexistent"), Logger(), model=model))
    paged = request.param.get("KV_PAGED") != "off"
    assert tdev.decode_pool is not None and jdev.decode_pool is not None
    assert (tdev.kv_pool is not None) == (jdev.kv_pool is not None) == paged
    yield jdev, tdev
    tdev.close()
    jdev.close()


def _both(pair, prompt, n=8):
    jdev, tdev = pair
    want = jdev.generate(prompt, max_new_tokens=n)
    got = tdev.generate(prompt, n)
    assert got == want, (prompt, got, want)
    return got


def test_concurrent_requests(pair):
    prompts = [[i + 1, 20 + i, 3, 40 + i] for i in range(4)]
    got = {}
    for k, dev in enumerate(pair):
        out = [None] * 4

        def run(i, dev=dev, out=out):
            out[i] = dev.generate(prompts[i], max_new_tokens=9)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        got[k] = out
    assert got[1] == got[0]
    assert all(len(ids) == 9 for ids in got[1])


def test_exact_repeat_hits_the_prefix_cache(pair):
    prompt = [2, 4, 6, 8, 10, 12]
    first = _both(pair, prompt)
    hits = pair[1].runner.prefix_stats["hits"]
    assert _both(pair, prompt) == first
    assert pair[1].runner.prefix_stats["hits"] == hits + 1


def test_shared_prefix_partial_hit(pair):
    _both(pair, SYSTEM + [21, 22])
    partial = pair[1].runner.prefix_stats["partial_hits"]
    _both(pair, SYSTEM + [31, 32, 33])
    assert pair[1].runner.prefix_stats["partial_hits"] == partial + 1


def test_multi_turn_follow_up(pair):
    reply = _both(pair, SYSTEM + [41], n=6)
    partial = pair[1].runner.prefix_stats["partial_hits"]
    _both(pair, SYSTEM + [41] + reply + [42], n=5)
    # the follow-up resumes from the stored conversation (prompt + reply)
    assert pair[1].runner.prefix_stats["partial_hits"] == partial + 1
    if pair[1].kv_pool is not None:
        assert pair[1].kv_pool.stats()["reserved"] == 0  # every reservation released


def test_prompt_longer_than_the_largest_bucket(pair):
    """70 tokens > bucket 32: sliced through the bucket, never clipped (a
    clipped prompt gives other ids)."""
    prompt = [(i * 7 + 3) % 250 for i in range(70)]
    before = pair[1].runner.prefills
    got = _both(pair, prompt)
    width = pair[1].runner.prefill_chunk_bucket or 32
    assert pair[1].runner.prefills - before == -(-70 // width)
    clipped = pair[1].runner.generate(prompt[-32:], 8)
    assert got != clipped


def test_prompt_over_the_prefill_chunk_budget(pair):
    """24 tokens fit bucket 32; with PREFILL_CHUNK_TOKENS=16 they prefill as
    two slices of 16 (one dispatch through the batcher without it)."""
    prompt = [(i * 5 + 1) % 250 for i in range(24)]
    before = pair[1].runner.prefills
    _both(pair, prompt)
    assert pair[1].runner.prefills - before == (2 if pair[1].runner.prefill_chunk_bucket else 1)
