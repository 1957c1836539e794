"""gofr_tpu_torch's echo runner, host paged store, pooled speculation's
scripted source and the serving metric families, against gofr_tpu's.

- ``MODEL_NAME=echo`` on both devices: the same ids (plain, with logprobs
  and alternatives), the same paged-store hits, partial hits, evictions,
  COW copies and ``kv_exhausted`` rejects, and under ``SPEC_POOLED=on
  SPEC_FAKE_ACCEPT=...`` the same accepted counts and spec gauges; the
  ``ECHO_STEP_MS`` cadence; over HTTP the same ``/v1/completions`` and chat
  texts and frames, streamed and not, then the same ``/metrics`` series
  (names, labels and values; the durations' buckets and sums masked).
- The tiny model (``TORCH_DEVICE=cpu``, JAX's weights carried over) in the
  default configuration: after the same requests the request, token,
  batch-size, prefill-chunk, kv-block and pool-reject series equal the JAX
  app's.
- ``TPU_BOOT=background`` readiness: 503 with the boot's stage until the
  boot ends, then 200; a failed boot (a ``MODEL_PATH`` that does not exist,
  or no card with ``TORCH_DEVICE`` unset) gives 503 ``failed``, health
  DOWN, a completion that fails with the error, and no runner on the CPU.
"""

import json
import re
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import gofr_tpu
import gofr_tpu_torch
from gofr_tpu.config import DECLARED_KEYS as JAX_KEYS
from gofr_tpu.config import EnvConfig
from gofr_tpu.logging import Level as JaxLevel
from gofr_tpu.metrics import Registry as JaxRegistry
from gofr_tpu.testutil import MockLogger
from gofr_tpu.tpu.device import new_device
from gofr_tpu_torch.config import DECLARED_KEYS, EnvFileConfig
from gofr_tpu_torch.logging import Level, Logger
from gofr_tpu_torch.metrics import Registry
from gofr_tpu_torch.models.convert import transformer_from_tree
from gofr_tpu_torch.models.llama import TINY
from gofr_tpu_torch.tpu.device import TPUDevice

PROMPTS = ([5, 6, 7, 8], [9], [3, 1, 4, 1, 5, 9, 2, 6], list(range(40)))
LENS = (17, 6, 1, 33)
BASE = {"MODEL_NAME": "echo", "BATCH_MAX_SIZE": "4", "BATCH_TIMEOUT_MS": "1"}
STAT_KEYS = ("total", "free", "cached", "active", "reserved", "cached_entries", "evictions",
             "cow_copies", "copied_kv_bytes", "kv_exhausted_rejects")


@pytest.fixture
def env(monkeypatch, tmp_path):
    """Every key either package reads cleared; the cwd holds no configs."""
    for key in set(JAX_KEYS) | set(DECLARED_KEYS):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.chdir(tmp_path)
    return monkeypatch


def _pair(env, **extra):
    """(JAX device, port device) under the same settings."""
    for key, value in {**BASE, **extra}.items():
        env.setenv(key, value)
    jax_dev = new_device(EnvConfig(), MockLogger(JaxLevel.FATAL), JaxRegistry())
    port_dev = TPUDevice(EnvFileConfig("/nonexistent"), Logger(Level.FATAL), metrics=Registry())
    return jax_dev, port_dev


def _close(*devs):
    for dev in devs:
        dev.close()


@pytest.mark.parametrize("paged", ["on", "off"])
def test_echo_ids_match_jax(env, paged):
    jdev, tdev = _pair(env, KV_PAGED=paged)
    try:
        assert tdev.device is None and tdev.ready()  # no device touched
        for p, n in zip(PROMPTS, LENS):
            assert tdev.generate(p, n) == jdev.generate(p, n)
            assert tdev.generate(p, n, logprobs=True) == jdev.generate(p, n, logprobs=True)
            got = tdev.generate(p, n, top_logprobs=True)
            want = jdev.generate(p, n, top_logprobs=True)
            assert [list(map(list, x)) if i == 2 else x for i, x in enumerate(got)] == \
                [[list(map(list, t)) for t in x] if i == 2 else x for i, x in enumerate(want)]
        # stop tokens end the stream unemitted
        assert tdev.generate([4, 5, 6], 9, stop_tokens={6}) == \
            jdev.generate([4, 5, 6], 9, stop_tokens={6})
        assert (tdev.kv_pool is None) == (jdev.kv_pool is None) == (paged == "off")
    finally:
        _close(jdev, tdev)


@pytest.mark.parametrize("settings", [
    {"KV_BLOCKS": "64", "KV_BLOCK_TOKENS": "4", "PREFIX_LCP_MIN": "4"},
    {"KV_BLOCKS": "24", "KV_BLOCK_TOKENS": "4", "PREFIX_CACHE": "2"},  # evictions
    {"KV_BLOCKS": "8", "KV_BLOCK_TOKENS": "2"},  # kv_exhausted
], ids=["lcp", "evict", "exhausted"])
def test_paged_store_matches_jax(env, settings):
    jdev, tdev = _pair(env, **settings)
    rng = np.random.default_rng(3)
    prompts = [[11, 12, 13, 14, 15, 16], [11, 12, 13, 14, 15, 16], [11, 12, 13, 14, 99, 98],
               list(rng.integers(1, 200, 9)), [1, 2, 3, 4, 5], list(rng.integers(1, 200, 13)),
               [11, 12, 13, 14, 15, 16, 17, 18]]
    try:
        for i, p in enumerate(prompts):
            n = 4 + (i % 3) * 6
            assert tdev.generate(p, n) == jdev.generate(p, n)
            assert tdev.runner.prefix_stats == jdev.runner.prefix_stats
            t, j = tdev.kv_pool.stats(), jdev.kv_pool.stats()
            assert {k: t[k] for k in STAT_KEYS} == {k: j[k] for k in STAT_KEYS}
        assert tdev.generate([1, 2, 3, 4, 5], 16) == jdev.generate([1, 2, 3, 4, 5], 16)
        series = _families(tdev.metrics.expose(), {"gofr_tpu_kv_blocks",
                                                   "gofr_tpu_kv_evictions_total",
                                                   "gofr_tpu_pool_reject_total",
                                                   "gofr_tpu_prefix_hit_ratio",
                                                   "gofr_tpu_prefix_partial_hit_ratio",
                                                   "gofr_tpu_prefix_entries"})
        assert series == _families(jdev.metrics.expose(), set(_names(series)))
        if settings["KV_BLOCKS"] == "8":
            assert tdev.kv_pool.stats()["kv_exhausted_rejects"] > 0
    finally:
        _close(jdev, tdev)


@pytest.mark.parametrize("schedule", ["0", "3,1,0,2", "1", "0,0,4"])
def test_fake_accept_schedule_matches_jax(env, schedule):
    """Every accept/reject mix emits the plain stream; the accepted
    counts, the spec gauges and the paged store equal JAX's."""
    jdev, tdev = _pair(env, SPEC_POOLED="on", SPEC_FAKE_ACCEPT=schedule,
                       KV_BLOCKS="256", KV_BLOCK_TOKENS="4")
    try:
        for p, n in zip(PROMPTS, LENS):
            out = tdev.generate(p, n)
            assert out == jdev.generate(p, n) == [p[i % len(p)] for i in range(n)]
        assert tdev.runner.spec_stats == jdev.runner.spec_stats
        assert tdev.runner.spec_stats["cycles"] > 0
        t, j = tdev.kv_pool.stats(), jdev.kv_pool.stats()
        assert {k: t[k] for k in STAT_KEYS} == {k: j[k] for k in STAT_KEYS}
        names = {"gofr_tpu_spec_accept_ratio", "gofr_tpu_spec_tokens_per_dispatch",
                 "gofr_tpu_spec_acceptance"}
        got = _families(tdev.metrics.expose(), names)
        assert got == _families(jdev.metrics.expose(), names)
        assert len(got) == 3
    finally:
        _close(jdev, tdev)


def test_ngram_speculation_matches_jax(env):
    jdev, tdev = _pair(env, SPEC_POOLED="on", SPEC_K_MAX="4")
    try:
        for p, n in zip(PROMPTS, LENS):
            assert tdev.generate(p, n) == jdev.generate(p, n)
        assert tdev.runner.spec_stats == jdev.runner.spec_stats
        assert tdev.runner.spec_stats["accepted"] > 0
    finally:
        _close(jdev, tdev)


def test_echo_step_ms_cadence(env):
    """ECHO_STEP_MS: one sleep a prefill and one a decode step, in both
    packages: 6 tokens take at least 7 steps and arrive a step apart."""
    step = 0.02
    jdev, tdev = _pair(env, ECHO_STEP_MS=str(step * 1000), KV_PAGED="off")
    try:
        for dev in (jdev, tdev):
            stamps = []
            t0 = time.perf_counter()
            out = dev.generate([7, 8, 9], 6, on_token=lambda t: stamps.append(time.perf_counter()))
            total = time.perf_counter() - t0
            assert out == [7, 8, 9, 7, 8, 9]
            assert total >= 7 * step
            gaps = np.diff(stamps)
            assert (gaps >= step * 0.9).all() and np.median(gaps) < step * 5
    finally:
        _close(jdev, tdev)


# -- over HTTP ----------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _boot_apps(env, settings, model=None, jax_first=True):
    """A JAX app and a port app (OpenAI routes) under ``settings``."""
    from gofr_tpu.openai import register_openai_routes as jax_routes

    apps = []
    for label in ("jax", "torch"):
        env.setenv("HTTP_PORT", str(_free_port()))
        for key, value in settings.items():
            env.setenv(key, value)
        if label == "jax":
            app = gofr_tpu.new()
            jax_routes(app)
        else:
            env.setenv("TORCH_DEVICE", "cpu")
            if model is not None:
                model = model(apps[0])
            app = gofr_tpu_torch.new(model=model)
            gofr_tpu_torch.register_openai_routes(app)
        app.start()
        apps.append(app)
    return apps


def _url(app, path):
    return f"http://127.0.0.1:{app.http_port}{path}"


def _post(app, path, body):
    req = urllib.request.Request(_url(app, path), data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            raw, status = resp.read().decode(), resp.status
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode())
    if raw.startswith(("data: ", "id: ")):  # the JAX package numbers its frames
        frames = [line[6:] for frame in raw.split("\n\n") for line in frame.split("\n")
                  if line.startswith("data: ")]
        return status, [f if f == "[DONE]" else _strip(json.loads(f)) for f in frames]
    return status, _strip(json.loads(raw))


def _strip(body):
    body.pop("id", None)
    body.pop("created", None)
    return body


def _get(app, path):
    try:
        with urllib.request.urlopen(_url(app, path), timeout=30) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


_SAMPLE = re.compile(r'^([a-z_:]+)(\{[^}]*\})? (\S+)')


def _names(series):
    return {name for name, _ in series}


def _families(text, names):
    """{(sample name, labels): value} for the samples of ``names``; the
    buckets and sums of duration histograms (``*_seconds``) and the cost
    model's residual ratios (an observed duration over a prediction)
    masked."""
    out = {}
    for line in text.splitlines():
        m = _SAMPLE.match(line)
        if not m:
            continue
        sample, labels, value = m.group(1), m.group(2) or "", m.group(3)
        family = re.sub(r"_(bucket|sum|count)$", "", sample)
        if family not in names and sample not in names:
            continue
        if family.endswith("_seconds") and sample.endswith(("_bucket", "_sum")):
            value = "masked"
        if family == "gofr_tpu_dispatch_residual_ratio":
            value = "masked"
        out[(sample, labels)] = value
    return out


def _port_families(text):
    return {re.sub(r"_(bucket|sum|count)$", "", m.group(1)) if m.group(1).endswith(
        ("_bucket", "_sum", "_count")) and "# TYPE" not in line else m.group(1)
        for line in text.splitlines() if (m := _SAMPLE.match(line))} | {
        line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")}


ECHO_HTTP = {**BASE, "TOKENIZER": "byte", "LOG_LEVEL": "FATAL", "SPEC_POOLED": "on",
             "SPEC_FAKE_ACCEPT": "2,0,1", "KV_BLOCK_TOKENS": "8"}


def test_echo_over_http_matches_jax(env):
    # the n = 2 request's candidates decode one after the other
    # (OPENAI_FANOUT_WORKERS=1): with two at once, whether they share a
    # prefill cohort depends on when the second thread reaches the batcher
    # inside the 1 ms window, and the cohort moves the batch-size,
    # prefill-chunk and scheduler families; the cohort of two is compared in
    # test_echo_fanout_cohort_matches_jax
    settings = {**ECHO_HTTP, "OPENAI_FANOUT_WORKERS": "1"}
    japp, tapp = _boot_apps(env, settings)
    try:
        bodies = [
            ("/v1/completions", {"prompt": "hello echo", "max_tokens": 12}),
            ("/v1/completions", {"prompt": "hello echo", "max_tokens": 12, "stream": True}),
            ("/v1/completions", {"prompt": "hello echo, again", "max_tokens": 5, "n": 2}),
            ("/v1/completions", {"prompt": [5, 6, 7], "max_tokens": 4, "logprobs": 2}),
            ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi there"}],
                                      "max_tokens": 9}),
            ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi there"}],
                                      "max_tokens": 9, "stream": True}),
            ("/v1/completions", {"prompt": "", "max_tokens": 3}),
        ]
        for path, body in bodies:
            want, got = _post(japp, path, body), _post(tapp, path, body)
            assert got == want, (path, body)
        for app in (japp, tapp):
            ok = _post(app, "/v1/completions", bodies[0][1])[1]
            assert ok["choices"][0]["text"] == "hello echo" + "he"
            # readiness and health on a device that booted
            assert _get(app, "/.well-known/ready")[0] == 200
            assert json.loads(_get(app, "/.well-known/health")[1])["data"]["status"] == "UP"
        # the same /metrics series on the port's families
        port_text = _get(tapp, "/metrics")[1]
        jax_text = _get(japp, "/metrics")[1]
        names = _port_families(port_text)
        assert names <= _port_families(jax_text)
        got = _families(port_text, names)
        assert got == _families(jax_text, names)
        for family in ("gofr_tpu_requests_total", "gofr_tpu_ttft_seconds_count",
                       "gofr_tpu_batch_size_count", "gofr_tpu_prefill_chunks_total",
                       "gofr_tpu_kv_blocks", "gofr_tpu_spec_accept_ratio",
                       "gofr_http_requests_total", "gofr_tpu_prefill_padded_tokens_total"):
            assert any(sample == family for sample, _ in got), family
    finally:
        tapp.shutdown()
        japp.shutdown()


def test_echo_fanout_cohort_matches_jax(env):
    """The n = 2 request's two candidates at once, in a cohort fixed by the
    batch size: BATCH_MAX_SIZE=2 dispatches the moment the second arrives,
    long before the 5 s window could close, so both packages dispatch one
    prefill of two, whatever the threads' timing."""
    settings = {**ECHO_HTTP, "BATCH_MAX_SIZE": "2", "BATCH_TIMEOUT_MS": "5000"}
    japp, tapp = _boot_apps(env, settings)
    try:
        body = {"prompt": "hello echo, again", "max_tokens": 5, "n": 2}
        want, got = _post(japp, "/v1/completions", body), _post(tapp, "/v1/completions", body)
        assert got == want
        port_text = _get(tapp, "/metrics")[1]
        jax_text = _get(japp, "/metrics")[1]
        names = _port_families(port_text)
        got = _families(port_text, names)
        assert got == _families(jax_text, names)
        assert got[("gofr_tpu_batch_size_count", '{model="echo"}')] == "1"
        assert got[("gofr_tpu_batch_size_sum", '{model="echo"}')] in ("2", "2.0")
    finally:
        tapp.shutdown()
        japp.shutdown()


# -- the serving families on the tiny model --------------------------------------

SERVED = ("gofr_tpu_requests_total", "gofr_tpu_tokens_total", "gofr_tpu_batch_size",
          "gofr_tpu_prefill_chunks_total", "gofr_tpu_kv_blocks", "gofr_tpu_pool_reject_total",
          "gofr_tpu_prefill_padded_tokens_total", "gofr_tpu_kv_evictions_total",
          "gofr_tpu_prefix_hit_ratio", "gofr_tpu_prefix_entries", "gofr_tpu_ttft_seconds",
          "gofr_tpu_decode_slots_active")


def test_tiny_serving_families_match_jax(env):
    settings = {"MODEL_NAME": "tiny", "TOKENIZER": "byte", "BATCH_MAX_SIZE": "4",
                "BATCH_TIMEOUT_MS": "2", "DECODE_CHUNK": "4", "LOG_LEVEL": "FATAL",
                "PREFIX_CACHE": "2", "DECODE_POOL_PENALTIES": "off"}

    def carried(japp):
        params = jax.tree.map(np.asarray, japp.container.tpu.runner.params)
        return transformer_from_tree(params, TINY, device="cpu")

    japp, tapp = _boot_apps(env, settings, model=carried)
    try:
        bodies = [
            {"prompt": "the tiny model", "max_tokens": 9, "temperature": 0},
            {"prompt": "the tiny model", "max_tokens": 9, "temperature": 0},  # exact hit
            {"prompt": [1, 2, 3, 40, 50], "max_tokens": 6, "temperature": 0},
            {"prompt": "penalized", "max_tokens": 5, "temperature": 0,
             "frequency_penalty": 0.5},  # the pool's penalties_off reject: solo
            {"prompt": "streamed", "max_tokens": 7, "temperature": 0, "stream": True},
        ]
        for body in bodies:
            assert _post(tapp, "/v1/completions", body) == _post(japp, "/v1/completions", body)
        port_text = _get(tapp, "/metrics")[1]
        jax_text = _get(japp, "/metrics")[1]
        got = _families(port_text, set(SERVED))
        assert got == _families(jax_text, set(SERVED))
        assert got[("gofr_tpu_pool_reject_total", '{reason="penalties_off"}')] == "1"
        assert float(got[("gofr_tpu_tokens_total", '{model="tiny",op="decode"}')]) > 0
        assert float(got[("gofr_tpu_tokens_total", '{model="tiny",op="prefill"}')]) > 0
    finally:
        tapp.shutdown()
        japp.shutdown()


# -- readiness under TPU_BOOT=background ----------------------------------------------

def _port_app(env, settings):
    for key, value in settings.items():
        env.setenv(key, value)
    env.setenv("HTTP_PORT", str(_free_port()))
    app = gofr_tpu_torch.new()
    gofr_tpu_torch.register_openai_routes(app)
    app.start()
    return app


def test_background_boot_is_503_with_a_stage_then_200(env, monkeypatch):
    from gofr_tpu_torch.tpu import device as tdevice

    release = threading.Event()
    warm = tdevice._TransformerRunner.warmup

    def held_warmup(self, progress):
        progress("warming held by the test")
        release.wait(30)
        warm(self, progress)

    monkeypatch.setattr(tdevice._TransformerRunner, "warmup", held_warmup)
    app = _port_app(env, {"MODEL_NAME": "tiny", "TORCH_DEVICE": "cpu", "TPU_BOOT": "background",
                          "TOKENIZER": "byte", "LOG_LEVEL": "FATAL"})
    try:
        for _ in range(200):
            status, body = _get(app, "/.well-known/ready")
            if json.loads(body).get("detail") == "warming held by the test":
                break
            time.sleep(0.01)
        assert status == 503
        assert json.loads(body) == {"state": "warming", "detail": "warming held by the test"}
        assert json.loads(_get(app, "/.well-known/health")[1])["data"]["status"] == "UP"
        # a request during the boot waits for it
        answer = {}
        waiter = threading.Thread(target=lambda: answer.update(r=_post(
            app, "/v1/completions", {"prompt": "wait", "max_tokens": 3, "temperature": 0})))
        waiter.start()
        time.sleep(0.1)
        assert waiter.is_alive()
        release.set()
        waiter.join(60)
        assert answer["r"][0] == 200 and answer["r"][1]["usage"]["completion_tokens"] == 3
        status, body = _get(app, "/.well-known/ready")
        assert status == 200 and json.loads(body)["state"] == "ready"
    finally:
        release.set()
        app.shutdown()


@pytest.mark.parametrize("chunk", ["0", "32"])
def test_boot_warms_the_prefill_shapes_serving_dispatches(env, monkeypatch, chunk):
    """The boot's prefill warm-up runs the batcher's padded batch at each
    bucket it is sent (under PREFILL_CHUNK_TOKENS up to the chunk bucket)
    and the chunked slice at batch 1; serving then dispatches no other."""
    from gofr_tpu_torch.models.transformer import Transformer

    shapes = []
    real = Transformer.prefill

    def recording(self, tokens, *args, **kwargs):
        shapes.append(tuple(tokens.shape))
        return real(self, tokens, *args, **kwargs)

    monkeypatch.setattr(Transformer, "prefill", recording)
    for key, value in {"MODEL_NAME": "tiny", "TORCH_DEVICE": "cpu", "BATCH_MAX_SIZE": "4",
                       "PREFILL_CHUNK_TOKENS": chunk}.items():
        env.setenv(key, value)
    dev = TPUDevice(EnvFileConfig("/nonexistent"), Logger(Level.FATAL), metrics=Registry())
    try:
        runner = dev.runner
        chunk_b = runner.prefill_chunk_bucket
        expect = [(4, b) for b in runner.buckets if chunk_b is None or b <= chunk_b]
        if chunk_b is not None:
            expect.append((1, chunk_b))
        assert shapes == expect and (chunk_b is None) == (chunk == "0")
        warmed = set(shapes)
        shapes.clear()
        for n in (3, 20, 40, 100):  # several buckets; two past a 32-token budget
            dev.generate(list(range(1, n + 1)), 2)
        assert shapes and set(shapes) <= warmed, (shapes, warmed)
    finally:
        dev.close()


@pytest.mark.parametrize("case", ["missing_model_path", "no_card"])
def test_a_failed_background_boot(env, case, tmp_path):
    settings = {"MODEL_NAME": "tiny", "TPU_BOOT": "background", "TOKENIZER": "byte",
                "LOG_LEVEL": "FATAL"}
    if case == "missing_model_path":
        settings.update(TORCH_DEVICE="cpu", MODEL_PATH=str(tmp_path / "absent"))
        cause = "absent"
    else:
        if torch.cuda.is_available():
            pytest.skip("needs a host without a CUDA device")
        cause = "no CUDA device"  # TORCH_DEVICE unset: the card, which is missing
    app = _port_app(env, settings)
    try:
        dev = app.container.tpu
        dev._ready.wait(60)
        status, body = _get(app, "/.well-known/ready")
        ready = json.loads(body)
        assert status == 503 and ready["state"] == "failed" and cause in ready["detail"]
        health = json.loads(_get(app, "/.well-known/health")[1])["data"]
        assert health["status"] == "DOWN"
        status, body = _post(app, "/v1/completions", {"prompt": "x", "max_tokens": 2})
        assert status == 503 and cause in body["error"]["message"]
        # nothing runs on the CPU in the card's place
        assert dev.runner is None and dev.batcher is None
        if case == "no_card":
            assert dev.device is None
    finally:
        app.shutdown()
