"""gofr_tpu_torch's dispatch cost model (``tpu/costmodel.py``), anomaly
ring (``anomaly.py``) and fit (``tpu/costcal.py``) against gofr_tpu's
(``tests/test_costmodel.py``, ``tools/costcal.py``).

- On the same sheets and coefficients (the JAX side's sheets labelled
  ``hlo``, the port's ``analytic``, the same flops and bytes), the same
  dispatch records get the same ``predict_ms``, residual ratios, family
  EMAs, drift latch and anomaly events.
- The ring's bounds and filters, and ``fit`` / ``_ols`` on the same records.
- The analytic sheet's flops (``transformer_sheet``) against
  ``torch.utils.flop_counter.FlopCounterMode`` over the tiny model's plain
  CPU prefill and decode step: equal within 1e-9 relative (the counter
  counts the same products; norms, RoPE and softmax are in neither).
- Over HTTP on the port's echo app: healthy traffic raises zero anomalies,
  an injected slow prefill raises one ``slow_dispatch`` (on the ring, the
  counter and the rider's flight record), and ``COSTMODEL=off`` removes
  the surface.
- The port's own rule (the JAX package judges every dispatch): a slow
  prefill run while the profiler traces gets no residual and raises no
  anomaly; the same slow prefill after the trace raises one.
"""

import json
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import gofr_tpu.telemetry as jt
import gofr_tpu_torch
import gofr_tpu_torch.telemetry as tt
from gofr_tpu import anomaly as ja
from gofr_tpu.config import DECLARED_KEYS as JAX_KEYS
from gofr_tpu.tpu import costmodel as jc
from gofr_tpu.tpu.introspect import DispatchRecord as JaxRecord
from gofr_tpu_torch import anomaly as ta
from gofr_tpu_torch.config import DECLARED_KEYS
from gofr_tpu_torch.models.llama import TINY
from gofr_tpu_torch.models.transformer import Transformer
from gofr_tpu_torch.profiling import profiler
from gofr_tpu_torch.tpu import costcal as tcal
from gofr_tpu_torch.tpu import costmodel as tc
from gofr_tpu_torch.tpu.flops import transformer_param_count
from gofr_tpu_torch.tpu.introspect import DispatchRecord


@pytest.fixture(autouse=True)
def _no_leaked_record():
    jt.activate_record(None)
    tt.activate_record(None)
    yield
    jt.activate_record(None)
    tt.activate_record(None)


PROFILE = {"schema": "gofr-costmodel-profile/1", "device_kinds": {
    "testcard": {"eff_flops": 2.0e14, "eff_bw": 1.0e12, "overhead_ms": 0.3, "source": "test"},
}}
# (kind, bucket, batch, flops, bytes) and a synthetic family
SHEETS = [("prefill", 64, 8, 4.0e11, 2.0e9), ("prefill", 128, 8, 9.0e11, 2.5e9),
          ("decode_chunk", 0, 8, 1.0e9, 5.0e10)]


def _models(tmp_path, **kw):
    path = tmp_path / "profile.json"
    path.write_text(json.dumps(PROFILE))
    jm = jc.CostModel(profile_path=str(path), **kw)
    tm = tc.CostModel(profile_path=str(path), **kw)
    for model in (jm, tm):
        model.calibrate("testcard x", "gpu")
    for kind, bucket, batch, flops, nbytes in SHEETS:
        jm.install(jc.CostSheet(kind, bucket=bucket, batch=batch, flops=flops,
                                bytes_accessed=nbytes, source="hlo"))
        tm.install_analytic(kind, bucket, batch, flops, nbytes)
    jm.install_synthetic("prefill_chunk", 5.0)
    tm.install_synthetic("prefill_chunk", 5.0)
    return jm, tm


# (kind, bucket, batch, observed ms, status): steady, a slow one, a drift
# excursion and its return, an error, a family with no sheet
TRAFFIC = ([("prefill", 64, 3, 12.0, "ok")] * 3 + [("prefill", 64, 3, 60.0, "ok")]
           + [("decode_chunk", 0, 8, 600.0, "ok")]
           + [("prefill", 128, 5, 45.0 * 3, "ok")] * 10 + [("prefill", 128, 5, 20.0, "ok")] * 12
           + [("prefill_chunk", 512, 1, 4.0, "ok"), ("prefill_chunk", 512, 1, 80.0, "ok"),
              ("prefill", 64, 2, 300.0, "error"), ("decode_chunk", 0, 4, 2000.0, "ok"),
              ("spec_verify", 0, 8, 50.0, "ok"), ("warmup_compile", 64, 0, 900.0, "ok")])


def _feed(model, record_cls, traffic):
    out = []
    for i, (kind, bucket, batch, ms, status) in enumerate(traffic):
        rec = record_cls(i + 1, kind, bucket=bucket, batch_size=batch)
        model.annotate(rec)
        rec.t_running = 100.0
        rec.t_done = 100.0 + ms / 1e3
        rec.status = status
        model.observe(rec)
        out.append((rec.predicted_ms, rec.cost_source, rec.residual_ratio, rec.anomaly))
    return out


def test_predictions_residuals_and_anomalies_match_jax(tmp_path):
    jm, tm = _models(tmp_path)
    want = _feed(jm, JaxRecord, TRAFFIC)
    got = _feed(tm, DispatchRecord, TRAFFIC)
    # the sources' names differ by design (no HLO in the port)
    assert [(p, r, a) for p, _, r, a in got] == [(p, r, a) for p, _, r, a in want]
    assert [s for _, s, _, _ in got] == [{"hlo": "analytic"}.get(s, s) for _, s, _, _ in want]
    assert tm.residuals() == jm.residuals()
    strip = [{k: v for k, v in e.items() if k not in ("ts", "source")} for e in tm.ring.events()]
    assert strip == [{k: v for k, v in e.items() if k not in ("ts", "source")}
                     for e in jm.ring.events()]
    causes = [e["cause"] for e in tm.ring.events()]
    assert "slow_dispatch" in causes and "ema_drift" in causes
    assert {k: v for k, v in tm.ring.stats().items() if k != "last_ts"} == \
        {k: v for k, v in jm.ring.stats().items() if k != "last_ts"}
    assert tm.overview()["worst_residual_ema"] == jm.overview()["worst_residual_ema"]
    assert tm.calibration["eff_bw"] == jm.calibration["eff_bw"] == 1.0e12


@pytest.mark.parametrize("kind,bucket,batch", [("prefill", 64, 8), ("prefill", 64, 2),
                                               ("prefill", 128, 1), ("decode_chunk", 0, 8),
                                               ("prefill_chunk", 9, 9), ("spec_verify", 0, 1),
                                               ("device_probe", 0, 0)])
def test_predict_ms_matches_jax(tmp_path, kind, bucket, batch):
    jm, tm = _models(tmp_path)
    want = jm.predict_ms(kind, bucket=bucket, batch=batch)
    got = tm.predict_ms(kind, bucket=bucket, batch=batch)
    assert got[0] == want[0]
    assert got[1] == {"hlo": "analytic"}.get(want[1], want[1])
    flops = tm.sheet_flops(kind, bucket, batch)
    assert flops == jm.hlo_flops(kind, bucket, batch)
    sheet = tm.sheet_for(kind, bucket=bucket, batch=batch)
    want_bytes = jm.hlo_bytes(kind, bucket, batch)
    assert (sheet.bytes_accessed if sheet is not None and sheet.source == "analytic"
            else None) == want_bytes


def test_calibration_falls_back_to_the_labelled_nominal(tmp_path):
    tm = tc.CostModel(profile_path=str(tmp_path / "missing.json"))
    tm.calibrate("NVIDIA H100 80GB HBM3", "gpu")
    assert tm.calibration["source"] == "nominal"
    assert tm.eff_flops == 989e12 * tc.NOMINAL_EFFICIENCY
    assert tm.eff_bw == 3.35e12 * tc.NOMINAL_EFFICIENCY
    shipped = tc.CostModel()
    shipped.calibrate("NVIDIA H100 80GB HBM3", "gpu")
    assert shipped.calibration["matched"] == "h100"
    shipped.calibrate("cpu", "cpu")
    assert shipped.calibration["matched"] == "cpu"
    for bad in ({"anomaly_factor": 1.0}, {"min_anomaly_ms": -1}, {"ema_alpha": 0},
                {"ema_band": 1.0}):
        with pytest.raises(ValueError):
            tc.CostModel(**bad)


@pytest.mark.parametrize("query", [{}, {"kind": "prefill"}, {"cause": "ema_drift"},
                                   {"limit": 2}, {"kind": "decode_chunk",
                                                  "cause": "slow_dispatch"}])
def test_anomaly_ring_filters_match_jax(query):
    rings = (ja.AnomalyRing(4), ta.AnomalyRing(4))
    for ring in rings:
        for i in range(6):
            ring.record(kind=("prefill", "decode_chunk")[i % 2],
                        cause=ta.ANOMALY_CAUSES[i % 3], dispatch_id=i)
    want, got = (
        [{k: v for k, v in e.items() if k != "ts"} for e in ring.events(**query)]
        for ring in rings
    )
    assert list(got) == list(want)
    assert rings[1].stats()["retained"] == 4 and rings[1].stats()["total"] == 6
    assert ta.ANOMALY_CAUSES == ja.ANOMALY_CAUSES


def test_fit_matches_costcal():
    """``costcal.fit`` on records of spread-out sizes, as tools/costcal.py
    fits them: the same classes, coefficients and overhead."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "costcal_ref", pathlib.Path(__file__).parent.parent / "tools" / "costcal.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    rng = np.random.default_rng(0)
    records = []
    for i in range(40):
        flops = float(rng.uniform(1e11, 4e13))
        nbytes = float(rng.uniform(1e9, 1e11))
        # the truth at half the data sheet's rates: each record's side of
        # the roofline is the one the nominal peaks give it
        ms = max(flops / 494.5e12, nbytes / 1.675e12) * 1e3 + 2.5 + float(rng.normal(0, 0.05))
        records.append({"flops": flops, "bytes_accessed": nbytes, "observed_ms": ms})
    pts = [(r["flops"], r["observed_ms"]) for r in records]
    assert tcal._ols(pts) == ref._ols(pts)
    assert tcal._ols(pts[:1]) is None and ref._ols(pts[:1]) is None
    row = tcal.fit(records, "NVIDIA H100 80GB HBM3")
    assert row["n_compute_bound"] + row["n_bandwidth_bound"] == 40
    assert row["eff_flops_source"] == row["eff_bw_source"] == "fit"
    # the same least squares over the same classes as the reference's fit
    for name, key in (("eff_flops", "flops"), ("eff_bw", "bytes_accessed")):
        cls = [(r[key], r["observed_ms"]) for r in records
               if (r["flops"] / 989e12 >= r["bytes_accessed"] / 3.35e12) == (name == "eff_flops")]
        slope, _ = ref._ols(cls)
        assert row[name] == pytest.approx(1e3 / slope, rel=1e-12)


def test_fit_without_spread_takes_the_mean_rate():
    records = [{"flops": 1e9, "bytes_accessed": 1.6e10, "duration_s": t}
               for t in (0.35, 0.40, 0.38, 0.41)]
    row = tcal.fit(records, "NVIDIA H100 80GB HBM3")
    assert row["eff_bw_source"] == "mean"
    assert row["eff_bw"] == pytest.approx(1.6e10 / np.mean([350, 400, 380, 410]) * 1e3)
    assert row["eff_flops_source"] == "default" and row["overhead_ms"] == 0.0
    dispatches = [{"kind": "prefill", "bucket": 64, "batch_size": 3, "status": "ok",
                   "duration_s": 0.01}, {"kind": "prefill", "bucket": 64, "batch_size": 3,
                                         "status": "error", "duration_s": 1.0},
                  {"kind": "warmup_compile", "bucket": 64, "status": "ok", "duration_s": 9.0}]
    sheets = [{"kind": "prefill", "bucket": 64, "batch": 8, "flops": 5.0, "bytes_accessed": 7.0}]
    assert tcal.join_records(dispatches, sheets) == [{
        "kind": "prefill", "bucket": 64, "batch_size": 3, "flops": 5.0, "bytes_accessed": 7.0,
        "duration_s": 0.01}]


# -- the analytic flops against torch's counter ------------------------------------------

def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("batch,seq", [(1, 16), (2, 40), (4, 64)])
def test_prefill_flops_match_the_counter(batch, seq):
    """A prefill of ``seq`` tokens a row over a cache window W: the plain
    attention computes every (query, key) pair of the window (the kernel
    reads only the causal ones: the sheet's ``pairs`` for a served prefill
    is ``seq * (seq + 1) / 2``), so the counter is held to the sheet at
    ``pairs = seq * W``. Tolerance 1e-9 relative."""
    model = Transformer.random(TINY, "cpu", 0)
    window = TINY.max_seq
    cache = model.init_cache(batch, window)
    tokens = torch.randint(0, TINY.vocab_size, (batch, seq), dtype=torch.int32)
    lengths = torch.full((batch,), seq, dtype=torch.int32)
    counted = _counted(lambda: model.prefill(tokens, cache, lengths))
    flops, _ = tc.transformer_sheet(TINY, 0.0, 0.0, batch, seq, seq * window, 0)
    assert counted == pytest.approx(flops, rel=1e-9)
    # the matmul part alone is 2·N·tokens less the embedding and the lm_head
    # a position, plus the lm_head a row
    n_mm = transformer_param_count(TINY) - 2 * TINY.vocab_size * TINY.dim - TINY.dim
    attn = 4.0 * TINY.head_dim * TINY.n_heads * TINY.n_layers * batch * seq * window
    norms = 2 * TINY.dim * TINY.n_layers
    assert flops == pytest.approx(2.0 * (n_mm - norms) * batch * seq
                                  + 2.0 * TINY.dim * TINY.vocab_size * batch + attn, rel=1e-12)


@pytest.mark.parametrize("batch", [1, 8])
def test_decode_step_flops_match_the_counter(batch):
    model = Transformer.random(TINY, "cpu", 0)
    cache = model.init_cache(batch, TINY.max_seq)
    cache["lengths"].fill_(17)
    token = torch.zeros((batch, 1), dtype=torch.int32)
    counted = _counted(lambda: model.decode_step(token, cache))
    flops, nbytes = tc.transformer_sheet(TINY, 1000.0, 10.0, batch, 1, TINY.max_seq, 17)
    assert counted == pytest.approx(flops, rel=1e-9)
    assert nbytes == 1000.0 + 10.0 * batch * (17 + 1)


# -- over HTTP on the port's echo app --------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _echo_app(monkeypatch, tmp_path, **extra):
    for key in set(JAX_KEYS) | set(DECLARED_KEYS):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.chdir(tmp_path)
    settings = {"MODEL_NAME": "echo", "TOKENIZER": "byte", "BATCH_MAX_SIZE": "4",
                "BATCH_TIMEOUT_MS": "1", "LOG_LEVEL": "FATAL", "HTTP_PORT": str(_free_port()),
                "WATCHDOG_DISPATCH_TIMEOUT_S": "5", **extra}
    for key, value in settings.items():
        monkeypatch.setenv(key, value)
    app = gofr_tpu_torch.new()
    gofr_tpu_torch.register_openai_routes(app)
    return app.start()


def _call(app, path, body=None):
    url = f"http://127.0.0.1:{app.http_port}{path}"
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_healthy_echo_traffic_raises_no_anomaly_and_a_slow_one_does(monkeypatch, tmp_path):
    app = _echo_app(monkeypatch, tmp_path)
    try:
        for i in range(12):
            assert _call(app, "/v1/completions", {"prompt": f"healthy {i}",
                                                  "max_tokens": 3})[0] == 200
        out = _call(app, "/admin/anomalies")[1]["data"]
        assert out["anomalies"] == [] and out["count"] == 0 and out["stats"]["total"] == 0
        recs = app.container.tpu.timeline.records(kind="prefill")
        assert recs and all(r["predicted_ms"] == 0.2 and r["cost_source"] == "synthetic"
                            and r["residual_ratio"] is not None and r["anomaly"] is None
                            for r in recs)
        page = _call(app, "/admin/costmodel")[1]["data"]
        assert page["calibration"]["matched"] == "cpu"
        assert {s["source"] for s in page["sheets"]} == {"synthetic"}
        assert {"prefill", "decode_chunk"} <= {s["kind"] for s in page["sheets"]}
        assert _call(app, "/admin/engine")[1]["data"]["costmodel"]["sheets"] == 2
        for path in ("/admin/anomalies?limit=0", "/admin/anomalies?limit=x",
                     "/admin/anomalies?cause=nope"):
            assert _call(app, path)[0] == 400
        # one prefill slowed past 4x its prediction and the 50 ms floor
        app.container.tpu.runner.stall_hook = lambda: time.sleep(0.25)
        assert _call(app, "/v1/completions", {"prompt": "slow one", "max_tokens": 2})[0] == 200
        app.container.tpu.runner.stall_hook = None
        events = _call(app, "/admin/anomalies?cause=slow_dispatch")[1]["data"]["anomalies"]
        assert len(events) == 1 and events[0]["kind"] == "prefill"
        slow = [r for r in _call(app, "/admin/requests")[1]["data"]["requests"]
                if r["anomalous_dispatches"]]
        assert [r["anomalous_dispatches"] for r in slow] == [[events[0]["dispatch_id"]]]
        metrics = app.container.metrics.expose()
        assert ('gofr_tpu_dispatch_anomalies_total{kind="prefill",cause="slow_dispatch"} 1'
                in metrics)
        assert app.container.tpu.engine.state == "serving"
    finally:
        app.shutdown()


def test_a_dispatch_under_the_profiler_is_not_judged(monkeypatch, tmp_path):
    app = _echo_app(monkeypatch, tmp_path)
    try:
        dev = app.container.tpu
        # every prefill slowed past 4x its prediction and the 50 ms floor
        dev.runner.stall_hook = lambda: time.sleep(0.25)
        profiler().start(str(tmp_path / "trace"))
        try:
            assert _call(app, "/v1/completions", {"prompt": "traced", "max_tokens": 2})[0] == 200
        finally:
            profiler().stop()
        traced = dev.timeline.records(limit=1, kind="prefill")[0]
        assert traced["predicted_ms"] == 0.2 and traced["duration_s"] >= 0.25
        assert traced["residual_ratio"] is None and traced["anomaly"] is None
        assert _call(app, "/admin/anomalies")[1]["data"]["count"] == 0
        assert _call(app, "/v1/completions", {"prompt": "untraced", "max_tokens": 2})[0] == 200
        dev.runner.stall_hook = None
        events = _call(app, "/admin/anomalies?cause=slow_dispatch")[1]["data"]["anomalies"]
        assert len(events) == 1 and events[0]["kind"] == "prefill"
        assert events[0]["dispatch_id"] > traced["dispatch_id"]
    finally:
        app.shutdown()


def test_costmodel_off_removes_the_surface(monkeypatch, tmp_path):
    app = _echo_app(monkeypatch, tmp_path, COSTMODEL="off")
    try:
        assert _call(app, "/v1/completions", {"prompt": "hi", "max_tokens": 2})[0] == 200
        assert app.container.tpu.costmodel is None
        assert _call(app, "/admin/costmodel")[0] == 503
        # the anomaly surface is the SLO engine's own ring then, as in JAX
        status, body = _call(app, "/admin/anomalies")
        assert status == 200 and body["data"]["anomalies"] == []
        rec = app.container.tpu.timeline.records(kind="prefill")[0]
        assert rec["predicted_ms"] is None and rec["residual_ratio"] is None
        assert _call(app, "/admin/engine")[1]["data"]["costmodel"] is None
    finally:
        app.shutdown()
    app = _echo_app(monkeypatch, tmp_path, COSTMODEL="off", SLO="off")
    try:
        assert _call(app, "/admin/anomalies")[0] == 503
    finally:
        app.shutdown()
