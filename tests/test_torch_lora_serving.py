"""Multi-LoRA serving in gofr_tpu_torch on the CPU (``TORCH_DEVICE=cpu``,
``MODEL_NAME=tiny``), each case a port of ``tests/test_multi_lora.py``:
two adapters trained by the JAX package's ``make_lora_train_step`` over
its tiny base, exported with ``export_adapter`` and carried into the
port's artifact format (``save_params``), served over the same weights.
Each adapter's ids equal the JAX package's greedy ids on its merged
weights; base and adapters share pool chunks (each row's ids its solo
ids); runtime loads and unloads rebuild the bank, deferred while an
adapter slot is live; a rank-mismatched set solos; unknown adapters and a
malformed ``LORA_ADAPTERS`` fail; adapters share the base's tensors and
serve over a w8a8 base; the pool's ``penalized_adapter``,
``penalized_mix`` and ``adapter_mix`` rejects; and over HTTP the
``/admin/adapters`` routes under ``ADMIN_TOKEN``, ``/v1/models``,
``model``-name routing and echo scoring under an adapter (against the
JAX package's ``score_tokens`` on the merged weights).
"""

import json
import os
import socket
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import gofr_tpu_torch
from gofr_tpu.models import lora as jlora
from gofr_tpu.models import quant as jquant
from gofr_tpu.models import transformer as jt
from gofr_tpu.models.llama import TINY as JAX_TINY
from gofr_tpu_torch.config import DECLARED_KEYS, EnvFileConfig
from gofr_tpu_torch.errors import InvalidParamError
from gofr_tpu_torch.logging import Logger
from gofr_tpu_torch.models.convert import artifact_from_tree, transformer_from_tree
from gofr_tpu_torch.models.llama import TINY
from gofr_tpu_torch.ops.sampling import Sampler
from gofr_tpu_torch.tpu.device import TPUDevice, parse_lora_adapters
from gofr_tpu_torch.training.checkpoint import save_params

PROMPT = [1, 2, 3]
SCORE_TOL = 2e-5  # one f32 forward


def _with_env(env: dict, fn):
    old = {k: os.environ.get(k) for k in DECLARED_KEYS}
    for k in DECLARED_KEYS:
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


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX base, and two adapters ("calm", "wild") trained differently
    over it by the JAX package, saved in the port's format: {name: (path,
    JAX merged tree)}; plus a rank-2 one ("odd")."""
    root = tmp_path_factory.mktemp("adapters")
    base = jt.init_transformer(jax.random.PRNGKey(0), JAX_TINY)
    out = {}
    for name, seed, steps, rank in (("calm", 5, 6, 4), ("wild", 9, 3, 4), ("odd", 3, 2, 2)):
        wrapped = jlora.add_lora(base, jax.random.key(seed), rank=rank)
        opt = optax.adam(5e-2)
        state = jlora.init_lora_train_state(wrapped, opt)
        step = jlora.make_lora_train_step(JAX_TINY, opt)
        tokens = jnp.asarray(np.random.RandomState(seed).randint(1, 200, (2, 16)), jnp.int32)
        for _ in range(steps):
            state, _ = step(state, tokens)
        path = str(root / name)
        artifact = jax.tree.map(np.asarray, jlora.export_adapter(state))
        save_params(path, artifact_from_tree(artifact))
        out[name] = (path, jlora.merge_lora(jlora.combine_lora(state["adapters"],
                                                               state["rest"])))
    return base, out


def _model(base, mode=None):
    tree = jquant.quantize_params(base, mode) if mode else base
    return transformer_from_tree(jax.tree.map(np.asarray, tree), TINY, device="cpu")


def _device(trained, names=("calm", "wild"), mode=None, **env):
    base, paths = trained
    spec = ",".join(f"{n}={paths[n][0]}" for n in names)
    cfg = {"TORCH_DEVICE": "cpu", "MODEL_NAME": "tiny", "BATCH_MAX_SIZE": "4",
           "BATCH_TIMEOUT_MS": "1", "DECODE_CHUNK": "4", "DECODE_SLOTS": "4"}
    if spec:
        cfg["LORA_ADAPTERS"] = spec
    if mode:
        cfg["MODEL_QUANT"] = mode
    cfg.update(env)
    model = _model(base, mode)
    return _with_env(cfg, lambda: TPUDevice(EnvFileConfig("/nonexistent"), Logger(),
                                            model=model))


def _greedy_reference(params, prompt, n):
    """The JAX package's greedy rollout through the full no-cache forward."""
    toks, out = list(prompt), []
    for _ in range(n):
        logits = jt.transformer_forward(params, jnp.asarray([toks], jnp.int32), JAX_TINY)
        out.append(int(jnp.argmax(logits[0, -1])))
        toks.append(out[-1])
    return out


def _hold_worker(pool):
    """Hold the pool's worker at its next chunk: -> (entered, release)."""
    entered, release = threading.Event(), threading.Event()
    real = pool._run_executable

    def held():
        entered.set()
        release.wait(60)
        return real()

    pool._run_executable = held
    return entered, release, lambda: setattr(pool, "_run_executable", real)


def _open_stream(dev, **kw):
    """A 40-token stream with its first token read (the prefill's): the
    caller waits for its slot to show in the pool."""
    it = dev.generate_stream(PROMPT, 40, **kw)
    next(it)
    return it


def _wait(pred, what):
    import time

    deadline = time.monotonic() + 30
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


# -- the device ----------------------------------------------------------------------

def test_adapter_requests_match_jax_merged_weights(trained):
    _, paths = trained
    dev = _device(trained)
    try:
        base_out = dev.generate(PROMPT, 8)
        outs = {}
        for name in ("calm", "wild"):
            outs[name] = dev.generate(PROMPT, 8, adapter=name)
            assert outs[name] == _greedy_reference(paths[name][1], PROMPT, 8), name
        assert outs["calm"] != base_out or outs["wild"] != base_out
        assert dev.generate(PROMPT, 8) == base_out
        assert dev.decode_pool.lora_chunks > 0
        # the adapter requests skipped the prefix cache and prefilled solo
        assert dev.runner.prefills >= 3
    finally:
        dev.close()


def test_adapters_and_base_share_pool_chunk(trained):
    solo = _device(trained, DECODE_POOL="off")
    try:
        want = {n: solo.generate(PROMPT, 12, adapter=n) for n in (None, "calm", "wild")}
    finally:
        solo.close()
    dev = _device(trained)
    pool = dev.decode_pool
    mixed = []
    real = pool._run_executable

    def seen():
        lora = pool._chunk_lora is not None
        mixed.append((lora, len(pool._lora_slots), len(pool._active)))
        return real()

    pool._run_executable = seen
    got, errs = {}, []
    barrier = threading.Barrier(3)

    def run(name):
        try:
            barrier.wait(timeout=60)
            got[name] = dev.generate(PROMPT, 12, adapter=name)
        except Exception as exc:  # surfaced below
            errs.append((name, exc))

    try:
        threads = [threading.Thread(target=run, args=(n,)) for n in (None, "calm", "wild")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errs, errs
        assert got == want
        assert pool.lora_chunks > 0
        # one adapter chunk carried adapter and base rows together
        assert any(lora and 0 < n_lora < active for lora, n_lora, active in mixed), mixed
        assert pool.occupancy()["lora_slots"] == 0
    finally:
        dev.close()


def test_runtime_loads_rebuild_the_bank_and_defer_while_a_slot_is_live(trained):
    _, paths = trained
    dev = _device(trained, names=())
    pool = dev.decode_pool
    try:
        assert dev.list_adapters() == []
        with pytest.raises(InvalidParamError):
            dev.generate(PROMPT, 4, adapter="calm")
        assert dev.load_adapter("calm", paths["calm"][0]) == ["calm"]
        before = pool.lora_chunks
        calm = dev.generate(PROMPT, 8, adapter="calm")
        assert pool.lora_chunks > before  # pooled, not solo
        # a load while an adapter slot is live waits for it: the slot keeps
        # its bank, new adapter requests solo meanwhile (bank_rebuilding)
        entered, release, restore = _hold_worker(pool)
        it = _open_stream(dev, adapter="calm")
        try:
            assert entered.wait(30)
            _wait(lambda: pool.occupancy()["lora_slots"] == 1, "the adapter slot")
            old_bank = pool._lora_model
            assert dev.load_adapter("wild", paths["wild"][0]) == ["calm", "wild"]
            assert pool._lora_pending is not None and pool._lora_model is old_bank
            rejects = pool.occupancy()["rejects"].get("bank_rebuilding", 0)
            wild = dev.generate(PROMPT, 8, adapter="wild")  # solo
            assert pool.occupancy()["rejects"]["bank_rebuilding"] == rejects + 1
            assert wild == _greedy_reference(paths["wild"][1], PROMPT, 8)
        finally:
            release.set()
            restore()
        rest = list(it)
        assert len(rest) == 39
        _wait(lambda: pool._lora_pending is None, "the deferred bank")
        assert pool._lora_model is not old_bank and pool._lora_ready
        before = pool.lora_chunks
        assert dev.generate(PROMPT, 8, adapter="wild") == wild
        assert pool.lora_chunks > before
        assert dev.unload_adapter("calm") == ["wild"]
        assert dev.generate(PROMPT, 8, adapter="wild") == wild  # after the shrink
        with pytest.raises(InvalidParamError):
            dev.generate(PROMPT, 4, adapter="calm")
        with pytest.raises(InvalidParamError):
            dev.unload_adapter("nope")
        with pytest.raises(InvalidParamError):
            dev.load_adapter("calm", "/no/such/path")
        with pytest.raises(InvalidParamError):
            dev.load_adapter("", paths["calm"][0])
        with pytest.raises(InvalidParamError, match="collides"):
            dev.load_adapter("tiny", paths["calm"][0])
        assert calm == _greedy_reference(paths["calm"][1], PROMPT, 8)
    finally:
        dev.close()


def test_rank_mismatched_set_disables_the_bank_and_solos(trained):
    _, paths = trained
    dev = _device(trained, names=("calm", "odd"))
    try:
        assert dev.list_adapters() == ["calm", "odd"]
        assert not dev.decode_pool._lora_ready
        assert dev.generate(PROMPT, 8, adapter="calm") == _greedy_reference(
            paths["calm"][1], PROMPT, 8)
        assert dev.generate(PROMPT, 8, adapter="odd") == _greedy_reference(
            paths["odd"][1], PROMPT, 8)
        assert dev.decode_pool.lora_chunks == 0  # never pooled
        assert dev.decode_pool.occupancy()["rejects"]["bank_rebuilding"] == 2
        dev.unload_adapter("odd")  # a uniform bank again
        dev.generate(PROMPT, 8, adapter="calm")
        assert dev.decode_pool.lora_chunks > 0
    finally:
        dev.close()


def test_unknown_adapter_and_malformed_spec(trained):
    dev = _device(trained, names=("calm",))
    try:
        with pytest.raises(InvalidParamError, match="adapter 'nope'"):
            dev.generate(PROMPT, 4, adapter="nope")
        with pytest.raises(InvalidParamError, match="adapter 'nope'"):
            dev.generate_stream(PROMPT, 4, adapter="nope")  # before the stream starts
        with pytest.raises(InvalidParamError, match="adapter 'nope'"):
            dev.score(PROMPT, adapter="nope")
    finally:
        dev.close()
    for bad in ("justapath", "a=", "=p", "a=p,,b=q"):
        with pytest.raises(ValueError, match="LORA_ADAPTERS"):
            parse_lora_adapters(bad)
    with pytest.raises(ValueError, match="LORA_ADAPTERS"):
        _device(trained, names=(), LORA_ADAPTERS="justapath")
    assert parse_lora_adapters(" a=/x , b=/y ") == {"a": "/x", "b": "/y"}


def test_adapters_share_the_base_tensors(trained):
    dev = _device(trained, names=("calm", "wild"))
    try:
        base = dev.runner.model
        for name in ("calm", "wild"):
            wrapped = dev.runner.adapters[name]
            assert wrapped.layers[0].wq.w is base.layers[0].wq
            assert wrapped.layers[1].w_down.w.data_ptr() == base.layers[1].w_down.data_ptr()
            assert wrapped.embed.data_ptr() == base.embed.data_ptr()
        # the bank stacks adapters over the same base weight
        assert dev.decode_pool._lora_model.layers[0].wq.w is base.layers[0].wq
    finally:
        dev.close()


def test_adapters_serve_over_a_w8a8_base(trained):
    dev = _device(trained, names=("calm",), mode="w8a8")
    try:
        assert dev.runner.model.layers[0].wq.names == ("q8", "scale")
        base_t, base_lp = dev.generate(PROMPT, 8, logprobs=True)
        ad_t, ad_lp = dev.generate(PROMPT, 8, adapter="calm", logprobs=True)
        assert len(ad_t) == 8
        # a silently ignored adapter would reproduce both exactly
        assert (ad_t, ad_lp) != (base_t, base_lp)
        assert (ad_t, ad_lp) == dev.generate(PROMPT, 8, adapter="calm", logprobs=True)
    finally:
        dev.close()


def test_pool_rejects_keep_adapter_and_penalized_slots_apart(trained):
    solo = _device(trained, DECODE_POOL="off")
    pen = Sampler(repetition_penalty=1.3)
    try:
        want_pen_calm = solo.generate(PROMPT, 8, adapter="calm", sampler=pen)
        want_calm = solo.generate(PROMPT, 8, adapter="calm")
        want_pen = solo.generate(PROMPT, 8, sampler=pen)
    finally:
        solo.close()
    dev = _device(trained, DECODE_POOL_PENALTIES="eager")
    pool = dev.decode_pool

    def rejects(reason):
        return pool.occupancy()["rejects"].get(reason, 0)

    try:
        # a penalized adapter request decodes solo
        assert dev.generate(PROMPT, 8, adapter="calm", sampler=pen) == want_pen_calm
        assert rejects("penalized_adapter") == 1
        # an adapter request while a penalized slot is live: penalized_mix
        entered, release, restore = _hold_worker(pool)
        it = _open_stream(dev, sampler=pen)
        try:
            assert entered.wait(30)
            _wait(lambda: pool.occupancy()["penalized_slots"] == 1, "the penalized slot")
            assert dev.generate(PROMPT, 8, adapter="calm") == want_calm
            assert rejects("penalized_mix") == 1
        finally:
            release.set()
            restore()
        list(it)
        _wait(lambda: pool.occupancy()["active"] == 0, "an idle pool")
        # a penalized request while an adapter slot is live: adapter_mix
        entered, release, restore = _hold_worker(pool)
        it = _open_stream(dev, adapter="calm")
        try:
            assert entered.wait(30)
            _wait(lambda: pool.occupancy()["lora_slots"] == 1, "the adapter slot")
            assert dev.generate(PROMPT, 8, sampler=pen) == want_pen
            assert rejects("adapter_mix") == 1
        finally:
            release.set()
            restore()
        list(it)
    finally:
        dev.close()


# -- HTTP ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def server(trained, tmp_path_factory):
    """A port app on the JAX weights, booted with "calm" and ADMIN_TOKEN."""
    base, paths = trained
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"TORCH_DEVICE": "cpu", "MODEL_NAME": "tiny", "TOKENIZER": "byte",
           "BATCH_MAX_SIZE": "4", "BATCH_TIMEOUT_MS": "1", "DECODE_CHUNK": "4",
           "HTTP_PORT": str(port), "ADMIN_TOKEN": "hunter2",
           "LORA_ADAPTERS": f"calm={paths['calm'][0]}"}
    model = _model(base)
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("app"))

    def build():
        app = gofr_tpu_torch.new(model=model)
        gofr_tpu_torch.register_openai_routes(app)
        return app

    # the admin token is read per request: it stays set while the module runs
    saved = {k: os.environ.get(k) for k in DECLARED_KEYS}
    try:
        for k in DECLARED_KEYS:
            os.environ.pop(k, None)
        os.environ.update(env)
        app = build()
        app.start()
        yield f"http://127.0.0.1:{port}", app, paths
        app.shutdown()
    finally:
        os.chdir(cwd)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _call(url, method, route, payload=None, token="hunter2"):
    req = urllib.request.Request(
        url + route, method=method,
        data=json.dumps(payload).encode() if payload is not None else None,
        headers={"Content-Type": "application/json",
                 **({"Authorization": f"Bearer {token}"} if token else {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            raw = resp.read().decode()
            status = resp.status
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode())
    if raw.startswith(("data: ", "id: ")):  # SSE: each frame's data (after its id: line)
        return status, [line[len("data: "):] for f in raw.split("\n\n")
                        for line in f.split("\n") if line.startswith("data: ")]
    return status, json.loads(raw)


def test_admin_adapter_routes(server):
    url, _, paths = server
    assert _call(url, "GET", "/admin/adapters", token=None)[0] == 401
    assert _call(url, "GET", "/admin/adapters", token="wrong")[0] == 401
    assert _call(url, "GET", "/admin/adapters", token="hé")[0] == 401  # not a 500
    assert _call(url, "GET", "/admin/adapters") == (200, {"data": {"adapters": ["calm"]}})
    status, body = _call(url, "POST", "/admin/adapters", {"name": "wild",
                                                          "path": paths["wild"][0]})
    assert (status, body["data"]["adapters"]) == (200, ["calm", "wild"])
    status, body = _call(url, "GET", "/v1/models")
    assert [m["id"] for m in body["data"]] == ["tiny", "calm", "wild"]
    assert body["data"][2]["root"] == "tiny"
    status, body = _call(url, "DELETE", "/admin/adapters/wild")
    assert (status, body["data"]["adapters"]) == (200, ["calm"])
    assert _call(url, "DELETE", "/admin/adapters/wild")[0] == 400
    assert _call(url, "POST", "/admin/adapters", {"name": "x"})[0] == 400
    status, body = _call(url, "POST", "/admin/adapters", {"name": "tiny",
                                                          "path": paths["wild"][0]})
    assert status == 400 and "collides" in body["error"]["message"]
    assert _call(url, "POST", "/admin/adapters", {"name": "x", "path": "/nope"})[0] == 400


def test_openai_routes_select_and_score_under_an_adapter(server):
    url, app, paths = server
    tok = app.container.tpu.tokenizer
    req = {"prompt": PROMPT, "max_tokens": 6, "temperature": 0, "logprobs": 1}
    via_model = _call(url, "POST", "/v1/completions", {**req, "model": "calm"})[1]
    via_key = _call(url, "POST", "/v1/completions", {**req, "adapter": "calm"})[1]
    plain = _call(url, "POST", "/v1/completions", req)[1]
    assert via_model["model"] == via_key["model"] == "calm" and plain["model"] == "tiny"
    text = tok.decode(_greedy_reference(paths["calm"][1], PROMPT, 6))
    assert via_model["choices"][0]["text"] == text
    assert via_model["choices"][0]["logprobs"] == via_key["choices"][0]["logprobs"]
    assert via_model["choices"][0]["logprobs"] != plain["choices"][0]["logprobs"]
    # streamed: the same text, frames under the adapter's name
    status, frames = _call(url, "POST", "/v1/completions",
                           {"prompt": PROMPT, "max_tokens": 6, "temperature": 0,
                            "model": "calm", "stream": True})
    events = [json.loads(f) for f in frames if f != "[DONE]"]
    assert status == 200 and {e["model"] for e in events} == {"calm"}
    assert "".join(e["choices"][0]["text"] for e in events) == text
    # n = 2 greedy fan-out under the adapter
    fan = _call(url, "POST", "/v1/completions", {**req, "adapter": "calm", "n": 2})[1]
    assert [c["text"] for c in fan["choices"]] == [text] * 2
    # chat under the adapter answers under its name
    chat = _call(url, "POST", "/v1/chat/completions",
                 {"model": "calm", "messages": [{"role": "user", "content": "hi"}],
                  "max_tokens": 4, "temperature": 0})[1]
    assert chat["model"] == "calm"
    # echo + logprobs at max_tokens 0: teacher-forced scores under the adapter
    prompt = [5, 9, 17, 33, 2, 71, 8]
    scored = _call(url, "POST", "/v1/completions",
                   {"prompt": prompt, "max_tokens": 0, "echo": True, "logprobs": 1,
                    "adapter": "calm"})[1]
    got = scored["choices"][0]["logprobs"]["token_logprobs"]
    want = np.asarray(jt.score_tokens(paths["calm"][1], jnp.asarray([prompt], jnp.int32),
                                      JAX_TINY))[0]
    assert got[0] is None
    np.testing.assert_allclose(got[1:], want, atol=SCORE_TOL, rtol=SCORE_TOL)
    base_scored = _call(url, "POST", "/v1/completions",
                        {"prompt": prompt, "max_tokens": 0, "echo": True, "logprobs": 1})[1]
    assert base_scored["choices"][0]["logprobs"]["token_logprobs"] != got
    # errors: an unknown model 404s, an unknown adapter 400s (pure echo too)
    status, body = _call(url, "POST", "/v1/completions", {**req, "model": "ghost"})
    assert status == 404 and "ghost" in body["error"]["message"]
    assert _call(url, "POST", "/v1/completions", {**req, "adapter": "ghost"})[0] == 400
    assert _call(url, "POST", "/v1/completions", {**req, "adapter": 3})[0] == 400
    assert _call(url, "POST", "/v1/completions",
                 {"prompt": prompt, "max_tokens": 0, "echo": True, "adapter": "ghost"})[0] == 400
    assert _call(url, "POST", "/v1/completions",
                 {**req, "adapter": "ghost", "stream": True})[0] == 400
