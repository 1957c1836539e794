"""gofr_tpu_torch's server: ``new()`` with TORCH_DEVICE=cpu MODEL_NAME=tiny
TOKENIZER=byte answers POST /v1/completions, stream and non-stream, with
the tokens of the port's ``generate`` and the JAX package's response
shape; weights carried over from JAX give JAX's greedy ids through the
whole HTTP path; config, device selection and the batcher."""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gofr_tpu_torch
from gofr_tpu_torch.config import EnvFileConfig
from gofr_tpu_torch.tpu.batcher import DynamicBatcher, pack_token_rows

PROMPT = "The port serves its first request."


def _env(monkeypatch, tmp_path, port, **extra):
    base = {"TORCH_DEVICE": "cpu", "MODEL_NAME": "tiny", "TOKENIZER": "byte",
            "HTTP_PORT": str(port), "BATCH_MAX_SIZE": "2", "BATCH_TIMEOUT_MS": "2"}
    base.update(extra)
    for key in ("MODEL_MAX_SEQ", "MODEL_BUCKETS", "MODEL_SEED", "DECODE_CHUNK"):
        monkeypatch.delenv(key, raising=False)
    for key, value in base.items():
        if value is None:
            monkeypatch.delenv(key, raising=False)
        else:
            monkeypatch.setenv(key, value)
    monkeypatch.chdir(tmp_path)


@pytest.fixture
def serve(monkeypatch, tmp_path, free_port):
    apps = []

    def _start(model=None, **extra):
        port = free_port()
        _env(monkeypatch, tmp_path, port, **extra)
        app = gofr_tpu_torch.new(model=model)
        gofr_tpu_torch.register_openai_routes(app)
        app.start()
        apps.append(app)
        return app, port

    yield _start
    for app in apps:
        app.shutdown()


def _post(port, body, path="/v1/completions"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def _frames(raw):
    """A stream's data frames; a single stream numbers them (SSE ``id:``
    from 0, one a frame), which is held here too."""
    frames = [f.split("\n") for f in raw.split("\n\n") if f]
    ids = [lines[0][len("id: "):] for lines in frames if lines[0].startswith("id: ")]
    assert ids in ([], [str(i) for i in range(len(frames))])
    return [line[len("data: "):] for lines in frames for line in lines
            if line.startswith("data: ")]


def test_completion_matches_generate(serve):
    app, port = serve()
    dev = app.container.tpu
    status, raw = _post(port, {"prompt": PROMPT, "max_tokens": 12, "temperature": 0})
    assert status == 200
    data = json.loads(raw)
    assert set(data) == {"id", "object", "created", "model", "choices", "usage"}
    assert data["object"] == "text_completion" and data["model"] == "tiny"
    want = dev.generate(PROMPT, 12)
    choice = data["choices"][0]
    assert choice["text"] == dev.tokenizer.decode(want)
    assert choice["index"] == 0 and choice["logprobs"] is None
    assert choice["finish_reason"] == ("length" if len(want) == 12 else "stop")
    assert data["usage"] == {
        "prompt_tokens": len(PROMPT), "completion_tokens": len(want),
        "total_tokens": len(PROMPT) + len(want),
    }


def test_stream_matches_non_stream(serve):
    app, port = serve()
    body = {"prompt": PROMPT, "max_tokens": 10, "temperature": 0}
    _, raw = _post(port, body)
    text = json.loads(raw)["choices"][0]["text"]
    status, raw = _post(port, {**body, "stream": True})
    assert status == 200
    frames = _frames(raw)
    assert frames[-1] == "[DONE]"
    chunks = [json.loads(f) for f in frames[:-1]]
    assert all(c["object"] == "text_completion" for c in chunks)
    assert len({c["id"] for c in chunks}) == 1
    assert "".join(c["choices"][0]["text"] for c in chunks) == text
    assert chunks[-1]["choices"][0]["finish_reason"] in ("length", "stop")
    assert all(c["choices"][0]["finish_reason"] is None for c in chunks[:-1])


def test_id_only_deployment_returns_tokens(serve):
    app, port = serve(TOKENIZER=None)
    prompt = [3, 14, 15, 92, 65]
    status, raw = _post(port, {"prompt": prompt, "max_tokens": 6, "temperature": 0})
    assert status == 200
    data = json.loads(raw)
    assert data["choices"][0]["tokens"] == app.container.tpu.generate(prompt, 6)
    assert data["choices"][0]["text"] == ""
    status, raw = _post(port, {"prompt": prompt, "max_tokens": 3, "temperature": 0,
                               "stream": True})
    ids = [json.loads(f)["choices"][0].get("tokens") for f in _frames(raw)[:-2]]
    assert [t[0] for t in ids] == app.container.tpu.generate(prompt, 3)
    status, _ = _post(port, {"prompt": "text needs a tokenizer"})
    assert status == 400


def test_seeded_sampling_is_reproducible(serve):
    _, port = serve()
    body = {"prompt": PROMPT, "max_tokens": 8, "temperature": 0.9, "top_k": 40, "seed": 11}
    a = json.loads(_post(port, body)[1])["choices"][0]["text"]
    b = json.loads(_post(port, body)[1])["choices"][0]["text"]
    assert a == b


def test_stops_end_generation(serve):
    app, port = serve()
    dev = app.container.tpu
    full = dev.generate(PROMPT, 12)
    status, raw = _post(port, {"prompt": PROMPT, "max_tokens": 12, "temperature": 0,
                               "stop_token_ids": [full[2]]})
    data = json.loads(raw)
    assert status == 200 and data["choices"][0]["finish_reason"] == "stop"
    assert data["usage"]["completion_tokens"] == full.index(full[2])
    text = dev.tokenizer.decode(full)
    stop = next((ch for ch in text[1:] if ch.isprintable() and ch != "�"), None)
    if stop is not None:
        data = json.loads(_post(port, {"prompt": PROMPT, "max_tokens": 12,
                                       "temperature": 0, "stop": stop})[1])
        assert data["choices"][0]["text"] == text[: text.index(stop)]
        assert data["choices"][0]["finish_reason"] == "stop"


@pytest.mark.parametrize(
    "body,status",
    [
        ({"max_tokens": 4}, 400),
        ({"prompt": "x", "n": 17}, 400),  # past the fan-out cap
        ({"prompt": "x", "logprobs": 6}, 400),  # past TOP_LOGPROBS
        ({"prompt": "x", "adapter": "sql-lora"}, 400),
        ({"prompt": "x", "max_tokens": 0}, 400),
        ({"prompt": "x", "temperature": -1}, 400),
        ({"prompt": [], "max_tokens": 2}, 400),
        ({"prompt": [300], "max_tokens": 2}, 400),
        ({"prompt": "x", "model": "llama3-8b"}, 404),
    ],
)
def test_unsupported_or_bad_requests_are_refused(serve, body, status):
    _, port = serve()
    got, raw = _post(port, body)
    assert got == status, raw
    assert "error" in json.loads(raw)


def test_concurrent_requests_share_prefill_batches(serve):
    # a long fill window: the batch closes when its 2 rows arrive
    app, port = serve(BATCH_TIMEOUT_MS="5000")
    dev = app.container.tpu
    before = dev.batcher.dispatches
    results = []
    threads = [
        threading.Thread(target=lambda: results.append(
            _post(port, {"prompt": PROMPT, "max_tokens": 6, "temperature": 0})))
        for _ in range(2)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(results) == 2
    # the same prompt alone, unbatched
    want = dev.runner.generate(dev.tokenizer.encode(PROMPT), 6, stop_tokens=dev.default_stop_ids)
    for status, raw in results:
        assert status == 200
        assert json.loads(raw)["choices"][0]["text"] == dev.tokenizer.decode(want)
    assert dev.batcher.dispatches - before == 1  # one bucket -> one cohort


def test_served_tokens_equal_jax_greedy(serve):
    """JAX weights through the whole HTTP path give JAX's greedy ids."""
    from gofr_tpu.models import transformer as jt
    from gofr_tpu.models.llama import TINY as JAX_TINY
    from gofr_tpu_torch.models.convert import transformer_from_tree
    from gofr_tpu_torch.models.llama import TINY

    params = jt.init_transformer(jax.random.PRNGKey(0), JAX_TINY)
    model = transformer_from_tree(jax.tree.map(np.asarray, params), TINY, device="cpu")
    app, port = serve(model=model, TOKENIZER=None)
    prompt = [7, 1, 200, 45, 99, 3, 18]
    data = json.loads(_post(port, {"prompt": prompt, "max_tokens": 9, "temperature": 0})[1])
    cache = jt.init_cache(JAX_TINY, 1, JAX_TINY.max_seq)
    logits, cache = jt.prefill(params, jnp.asarray([prompt], jnp.int32), cache, JAX_TINY)
    first = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    rest, _ = jt.decode_chunk(params, first, cache, JAX_TINY, 8, jax.random.key(0))
    want = [int(first[0, 0])] + [int(t) for t in np.asarray(rest)[0]]
    assert data["choices"][0]["tokens"] == want


def test_health_and_unknown_route(serve):
    _, port = serve()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/.well-known/health", timeout=30) as r:
        data = json.loads(r.read())
    assert data["data"]["status"] == "UP"
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=30)
    assert exc.value.code == 404


def test_cuda_device_is_required_unless_cpu_is_asked_for(monkeypatch, tmp_path, free_port):
    _env(monkeypatch, tmp_path, free_port(), TORCH_DEVICE=None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gofr_tpu_torch.new()
    monkeypatch.setenv("TORCH_DEVICE", "tpu")
    with pytest.raises(ValueError, match="TORCH_DEVICE"):
        gofr_tpu_torch.new()


def test_config_reads_declared_keys_env_over_file(monkeypatch, tmp_path):
    (tmp_path / ".env").write_text("MODEL_NAME=small\nHTTP_PORT='9001' # c\nexport DECODE_CHUNK=4\n")
    monkeypatch.delenv("HTTP_PORT", raising=False)
    monkeypatch.delenv("DECODE_CHUNK", raising=False)
    monkeypatch.setenv("MODEL_NAME", "tiny")
    cfg = EnvFileConfig(str(tmp_path))
    assert cfg.get("MODEL_NAME") == "tiny"
    assert cfg.get("HTTP_PORT") == "9001"
    assert cfg.get_or_default("DECODE_CHUNK", "8") == "4"
    assert cfg.get_or_default("MODEL_SEED", "0") == "0"
    with pytest.raises(KeyError, match="not read"):
        cfg.get("TPU_MESH")  # a key of the JAX package not ported yet


_LADDER = (16, 32, 64, 128)


def _bucket_of(ids) -> int:
    return next((b for b in _LADDER if int(ids.size) <= b), _LADDER[-1])


@pytest.mark.parametrize("cohort", [True, False])
def test_batcher_dispatches_equal_jax(cohort):
    """``BATCH_COHORT``: for the same burst of mixed-length arrivals, the
    port's batcher dispatches the JAX batcher's batches, in its order,
    with its padded-token count: per-bucket cohorts, or one FIFO batch
    padded to its largest bucket."""
    from gofr_tpu.metrics import Registry as JaxRegistry
    from gofr_tpu.tpu.batcher import DynamicBatcher as JaxBatcher
    from gofr_tpu_torch.metrics import Registry

    runs = []
    for cls, registry in ((JaxBatcher, JaxRegistry()), (DynamicBatcher, Registry())):
        batches = []

        def run(payloads, batches=batches):
            batches.append([int(p.size) for p in payloads])
            return [int(p[0]) for p in payloads]

        b = cls(run, max_batch=8, timeout_ms=60, metrics=registry, name="m",
                bucket_fn=_bucket_of, cohort=cohort)
        try:
            lengths = [4, 120, 8, 100, 12, 90, 6, 110]
            futures = [b.submit(np.arange(1, n + 1, dtype=np.int32)) for n in lengths]
            assert [f.result(timeout=10) for f in futures] == [1] * 8
        finally:
            b.close()
        padded = registry.counter("gofr_tpu_prefill_padded_tokens_total", labels=("model",))
        runs.append((batches, padded.value(model="m")))
    assert runs[1] == runs[0]
    assert len(runs[0][0]) == (2 if cohort else 1)


def test_batch_cohort_off_reaches_the_device_batcher(monkeypatch, tmp_path):
    """``BATCH_COHORT=off`` builds the device's batcher without cohorts;
    unset it forms them."""
    from gofr_tpu_torch.testutil import serving_device

    monkeypatch.chdir(tmp_path)
    with serving_device(TORCH_DEVICE="cpu", BATCH_COHORT="off", LOG_LEVEL="FATAL") as dev:
        dev.wait_ready()
        assert dev.batcher.cohort is False
    monkeypatch.delenv("BATCH_COHORT", raising=False)
    with serving_device(TORCH_DEVICE="cpu", LOG_LEVEL="FATAL") as dev:
        dev.wait_ready()
        assert dev.batcher.cohort is True


def test_batcher_splits_buckets_into_cohorts():
    seen = []

    def run_batch(payloads):
        seen.append(sorted(payloads))
        return [p * 10 for p in payloads]

    b = DynamicBatcher(run_batch, max_batch=4, timeout_ms=200,
                       bucket_fn=lambda p: 0 if p < 5 else 1)
    try:
        futs = [b.submit(p) for p in (1, 7, 2)]
        assert [f.result(10) for f in futs] == [10, 70, 20]
        assert sorted(seen) == [[1, 2], [7]]  # two buckets -> two cohorts
        assert b.dispatches == 2
    finally:
        b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(3)


def test_pack_token_rows_keeps_the_last_tokens():
    rows = [np.array([1, 2, 3]), np.array([4, 5, 6, 7, 8])]
    out, lens = pack_token_rows(rows, 3, 4)
    np.testing.assert_array_equal(out, [[1, 2, 3, 0], [5, 6, 7, 8], [0, 0, 0, 0]])
    np.testing.assert_array_equal(lens, [3, 4, 0])
