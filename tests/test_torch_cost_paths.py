"""The cost model's serving paths (``tpu/costmodel.py``: ``serving_path``,
per-path profile rows; ``tpu/costcal.py::fit_paths``), the port's own rule
beside the JAX package's cost model, which prices each compiled program.

- A sheet names the path it prices: the weight mode, the KV dtype, solo
  draft or pooled speculation, an adapter slot, the mesh shape.
- ``transformer_sheet`` counts the port's own products: an int8 or int4
  pack's bf16 copy written and read again a step (``quant.cast_params``
  elements), a verify's positions, an adapter slot's gathered rows and
  products.
- A path with no fitted row is predicted (the record keeps its prediction
  and the MFU its flops) but not judged: no residual, no EMA, no anomaly,
  and the snapshot lists it as unfitted. With a fitted row it is judged;
  a dispatch that contending work shared against its prediction plus the
  contenders'.
- ``join_records`` keeps each record's path and ``fit_paths`` fits each
  path from its own records, none with no bandwidth-bound record; the
  committed profile's H100 row judges bf16.
- On the tiny model on the CPU, the device installs its path's sheets:
  int8 and f8 KV, pooled speculation's verify ladder, the adapter path.
"""

import json
import os

import pytest
import torch

from gofr_tpu.config import DECLARED_KEYS as JAX_KEYS
from gofr_tpu_torch.config import DECLARED_KEYS, EnvFileConfig
from gofr_tpu_torch.logging import Level, Logger
from gofr_tpu_torch.metrics import Registry
from gofr_tpu_torch.models.llama import TINY
from gofr_tpu_torch.models.quant import cast_params
from gofr_tpu_torch.models.transformer import Transformer, layer_shapes
from gofr_tpu_torch.tpu import costcal as tcal
from gofr_tpu_torch.tpu import costmodel as tc
from gofr_tpu_torch.tpu.introspect import DispatchRecord, DispatchTimeline

PROFILE = {"schema": "gofr-costmodel-profile/1", "device_kinds": {
    "testcard": {"eff_flops": 2.0e14, "eff_bw": 1.0e12, "overhead_ms": 0.3, "source": "test",
                 "path": "bf16",
                 "paths": {"int8": {"eff_flops": 1.0e14, "eff_bw": 2.0e11, "overhead_ms": 1.0,
                                    "source": "test int8"}}},
}}


@pytest.mark.parametrize("args,kw,name", [
    (("bf16",), {}, "bf16"),
    (("int8",), {"kv_f8": True}, "int8+f8kv"),
    (("bf16",), {"draft": True}, "bf16+draft"),
    (("bf16",), {"spec": True}, "bf16+spec"),
    (("bf16",), {"mesh_axes": {"dp": 1, "fsdp": 1, "tp": 2}}, "bf16/tp2"),
    (("w8a8",), {"mesh_axes": {"dp": 2, "fsdp": 1, "tp": 2}}, "w8a8/dp2,tp2"),
])
def test_a_path_names_its_deployment(args, kw, name):
    assert tc.serving_path(*args, **kw) == name
    head, _, mesh = name.partition("/")
    assert tc.adapter_path(name) == head + "+lora" + ("/" + mesh if mesh else "")


def test_an_int8_sheet_counts_the_bf16_copy():
    model = Transformer.random(TINY, "cpu", 0, quant="int8")
    per_layer = sum(torch.Size(shape).numel() for shape in layer_shapes(TINY).values())
    lm_head = TINY.dim * TINY.vocab_size
    assert cast_params(model) == per_layer * TINY.n_layers + lm_head
    assert cast_params(Transformer.random(TINY, "cpu", 0)) == 0
    stored, kv = float(model.weight_bytes()), 10.0
    flops, nbytes = tc.transformer_sheet(TINY, stored, kv, 8, 1, 64, 64, steps=4,
                                         cast_params=cast_params(model), act_bytes=2)
    plain_flops, plain = tc.transformer_sheet(TINY, stored, kv, 8, 1, 64, 64, steps=4)
    assert flops == plain_flops
    assert nbytes == plain + 4 * 2 * cast_params(model) * 2  # written and read, each step
    assert cast_params(Transformer.random(TINY, "cpu", 0, quant="w8a8")) == lm_head


def test_verify_and_adapter_sheets_count_their_work():
    w, kv = 1.0e6, 10.0
    one, _ = tc.transformer_sheet(TINY, w, kv, 8, 1, 64, 64)
    five, _ = tc.transformer_sheet(TINY, w, kv, 8, 5, 5 * 64, 64, logit_positions=5)
    assert five > 4 * one
    base_f, base_b = tc.transformer_sheet(TINY, w, kv, 8, 1, 64, 64, steps=2)
    lora_f, lora_b = tc.transformer_sheet(TINY, w, kv, 8, 1, 64, 64, steps=2, adapter_params=100,
                                          act_bytes=2)
    assert lora_f - base_f == 2 * (2.0 * 100 * 8 * 1)
    assert lora_b - base_b == 2 * (3.0 * 100 * 8 * 2)


def _model(tmp_path, profile=PROFILE, path="int8"):
    file = tmp_path / "profile.json"
    file.write_text(json.dumps(profile))
    model = tc.CostModel(profile_path=str(file))
    model.calibrate("testcard x", "gpu")
    model.set_path(path)
    return model


def _run(model, kind, ms, adapter=False, tokens=0, bucket=0, batch=8):
    rec = DispatchRecord(1, kind, bucket=bucket, batch_size=batch, tokens=tokens,
                         adapter=adapter)
    model.annotate(rec)
    rec.t_running, rec.t_done, rec.status = 100.0, 100.0 + ms / 1e3, "ok"
    model.observe(rec)
    return rec


@pytest.mark.parametrize("path,adapter", [("int4", False), ("bf16+spec", False),
                                          ("bf16", True), ("bf16/tp2", False)])
def test_an_unfitted_path_is_predicted_not_judged(tmp_path, path, adapter):
    model = _model(tmp_path, path=path)
    sheet_path = tc.adapter_path(path) if adapter else path
    model.install_analytic("decode_chunk", 0, 8, 1.0e9, 5.0e10, path=sheet_path)
    for _ in range(12):
        rec = _run(model, "decode_chunk", 100_000.0, adapter=adapter)
        assert rec.predicted_ms == pytest.approx(5.0e10 / 1.0e12 * 1e3 + 0.3)
        assert rec.cost_path == sheet_path and rec.cost_judged is False
        assert rec.residual_ratio is None and rec.anomaly is None
    assert model.ring.total() == 0 and model.residuals() == {}
    snap = model.snapshot()
    assert snap["unfitted"] == [sheet_path] and not snap["paths"][sheet_path]["fitted"]
    assert rec.to_dict()["cost_path"] == sheet_path and rec.to_dict()["cost_judged"] is False


def test_a_fitted_path_is_judged_on_its_own_row(tmp_path):
    model = _model(tmp_path)
    model.install_analytic("decode_chunk", 0, 8, 1.0e9, 5.0e10, path="int8")
    rec = _run(model, "decode_chunk", 250.0)
    assert rec.predicted_ms == pytest.approx(5.0e10 / 2.0e11 * 1e3 + 1.0)
    assert rec.cost_judged and rec.residual_ratio == pytest.approx(250.0 / 251.0)
    slow = _run(model, "decode_chunk", 4000.0)
    assert slow.anomaly == "slow_dispatch" and model.ring.total() == 1
    snap = model.snapshot()
    assert snap["unfitted"] == [] and snap["paths"]["int8"]["row_source"] == "test int8"
    assert snap["calibration"]["fitted_paths"] == ["bf16", "int8"]
    # the row's own coefficients are its named path's fit: judged too
    model.set_path("bf16")
    model.install_analytic("decode_chunk", 0, 8, 1.0e9, 5.0e10, path="bf16")
    assert _run(model, "decode_chunk", 60.0).cost_judged


def test_a_verify_resolves_its_widths_sheet(tmp_path):
    model = _model(tmp_path, path="int8")
    for width, nbytes in ((2, 1.0e10), (4, 2.0e10), (5, 3.0e10)):
        model.install_analytic("spec_verify", 0, 8, 1.0e9, nbytes, width=width, path="int8")
    for width, nbytes in ((2, 1.0e10), (4, 2.0e10), (5, 3.0e10)):
        rec = _run(model, "spec_verify", 10.0, tokens=width, batch=3)
        assert rec.predicted_ms == pytest.approx(nbytes / 2.0e11 * 1e3 + 1.0)
    assert _run(model, "spec_verify", 10.0, tokens=3).predicted_ms is None  # no such width


def test_fit_paths_fits_each_path_from_its_records():
    sheets = [{"kind": "decode_chunk", "bucket": 0, "batch": 8, "width": 0,
               "flops": 1.0e9, "bytes_accessed": 1.6e10, "path": path}
              for path in ("bf16", "int8")]
    dispatches = [{"kind": "decode_chunk", "bucket": None, "batch_size": 8, "status": "ok",
                   "tokens": 0, "duration_s": d, "cost_path": path}
                  for path, d in (("bf16", 0.40), ("bf16", 0.42), ("int8", 2.0), ("int8", 2.2))]
    records = tcal.join_records(dispatches, sheets)
    assert [r["path"] for r in records] == ["bf16", "bf16", "int8", "int8"]
    rows = tcal.fit_paths(records, "NVIDIA H100 80GB HBM3")
    assert set(rows) == {"bf16", "int8"}
    assert rows["bf16"]["eff_bw"] == pytest.approx(1.6e10 / 410.0 * 1e3)
    assert rows["int8"]["eff_bw"] == pytest.approx(1.6e10 / 2100.0 * 1e3)
    # a path with prefills alone (compute-bound) has no measured chunk rate
    prefills = [{"kind": "prefill", "bucket": 512, "batch_size": 1, "flops": 8.0e12,
                 "bytes_accessed": 1.6e10, "duration_s": d, "path": "bf16+draft"}
                for d in (0.02, 0.03)]
    assert set(tcal.fit_paths(records + prefills, "NVIDIA H100 80GB HBM3")) == {"bf16", "int8"}


def test_the_committed_h100_row_judges_its_fitted_paths():
    """The committed profile's H100 row judges bf16 (its own coefficients,
    phase 17's fit) and each path phases 12-14 and 21 fitted; any other
    path is predicted on the card's row and not judged."""
    model = tc.CostModel()
    model.calibrate("NVIDIA H100 80GB HBM3", "gpu")
    assert model.calibration["source"] == "profile"
    fitted = set(model.calibration["fitted_paths"])
    assert fitted == {"bf16", "int8", "int4", "w8a8", "int8+f8kv", "bf16+spec", "bf16+lora",
                      "bf16/tp2"}
    # the tiny model's f32 paths and solo draft (prefills alone) stay unfitted
    unfitted = ["f16", "f32", "f32+spec", "f32+draft", "bf16+draft"]
    for path in sorted(fitted) + unfitted:
        model.install_analytic("prefill", 64, 8, 1.0e12, 1.0e10, path=path)
        assert model._coefficients(path)[3] is (path not in unfitted)
    assert model.snapshot()["unfitted"] == sorted(unfitted)


@pytest.fixture
def env(monkeypatch, tmp_path):
    for key in set(JAX_KEYS) | set(DECLARED_KEYS):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.chdir(tmp_path)
    for key, value in {"MODEL_NAME": "tiny", "TORCH_DEVICE": "cpu", "MODEL_BUCKETS": "64",
                       "BATCH_MAX_SIZE": "2", "BATCH_TIMEOUT_MS": "1",
                       "DECODE_SLOTS": "2"}.items():
        monkeypatch.setenv(key, value)
    return monkeypatch


def _device():
    from gofr_tpu_torch.tpu.device import TPUDevice

    return TPUDevice(EnvFileConfig(os.getcwd()), Logger(Level.FATAL), metrics=Registry())


def test_a_quantized_device_prices_its_path_unjudged(env):
    env.setenv("MODEL_QUANT", "int8")
    env.setenv("MODEL_KV_DTYPE", "f8")
    dev = _device()
    try:
        path = dev.cost_path()
        assert path == dev.costmodel.path == "int8+f8kv"
        sheets = dev.costmodel.sheets()
        assert {s["path"] for s in sheets} == {path}
        assert {s["kind"] for s in sheets} == {"prefill", "prefill_chunk", "decode_chunk"}
        dev.generate([1, 2, 3], max_new_tokens=3)
        recs = [r for r in dev.timeline.records(limit=50)
                if r["kind"] in ("prefill", "decode_chunk")]
        assert recs and all(r["predicted_ms"] is not None and r["residual_ratio"] is None
                            and r["cost_path"] == path and r["cost_judged"] is False
                            for r in recs)
        assert dev.costmodel.snapshot()["unfitted"] == [path]
    finally:
        dev.close()


def test_pooled_speculation_installs_the_verify_ladder(env):
    env.setenv("SPEC_POOLED", "on")
    env.setenv("SPEC_K_MAX", "4")
    dev = _device()
    try:
        assert dev.cost_path() == "f32+spec"
        widths = sorted(s["width"] for s in dev.costmodel.sheets() if s["kind"] == "spec_verify")
        assert widths == [2, 4, 5]
    finally:
        dev.close()


def test_an_adapter_installs_its_paths_sheets(env):
    from gofr_tpu_torch.models.lora import add_lora

    dev = _device()
    try:
        dev.runner.adapters["a"] = add_lora(dev.runner.model, seed=1, rank=2)
        dev._refresh_pool_lora()
        by_path = {}
        for s in dev.costmodel.sheets():
            by_path.setdefault(s["path"], set()).add(s["kind"])
        assert by_path == {"f32": {"prefill", "prefill_chunk", "decode_chunk"},
                           "f32+lora": {"prefill_chunk", "decode_chunk"}}
        base = dev.costmodel.sheet_for("decode_chunk", batch=2, path="f32")
        lora = dev.costmodel.sheet_for("decode_chunk", batch=2, path="f32+lora")
        assert lora.flops > base.flops and lora.bytes_accessed > base.bytes_accessed
    finally:
        dev.close()


def test_a_timeline_record_of_an_adapter_dispatch_takes_the_adapter_path(tmp_path):
    model = _model(tmp_path, path="bf16")
    model.install_analytic("decode_chunk", 0, 8, 1.0e9, 5.0e10, path="bf16")
    model.install_analytic("decode_chunk", 0, 8, 2.0e9, 6.0e10, path="bf16+lora")
    timeline = DispatchTimeline(costmodel=model)
    base = timeline.begin("decode_chunk", batch_size=8)
    lora = timeline.begin("decode_chunk", batch_size=8, adapter=True)
    assert (base.cost_path, lora.cost_path) == ("bf16", "bf16+lora")
    assert base.cost_judged and not lora.cost_judged


def _timeline(tmp_path, path):
    model = _model(tmp_path, path=path)
    for p in (path, tc.adapter_path(path)):
        model.install_analytic("prefill_chunk", 64, 1, 1.0e9, 5.0e9, path=p)
        model.install_analytic("decode_chunk", 0, 8, 1.0e9, 5.0e10, path=p)
    return model, DispatchTimeline(costmodel=model)


def _close(timeline, rec, ms):
    timeline.finish(rec)
    rec.t_running, rec.t_done = 100.0, 100.0 + ms / 1e3
    rec.residual_ratio = None
    timeline.costmodel.observe(rec)


def test_contending_prefills_are_judged_with_each_others_work(tmp_path):
    """Two prefills in flight at once each wait for the other's work: each
    is judged against its own prediction plus the other's
    (``cost_shared_ms``); the time that is in the band beside the other is
    an anomaly alone."""
    model, timeline = _timeline(tmp_path, "int8")
    a = timeline.begin("prefill_chunk", bucket=64, batch_size=1)
    b = timeline.begin("prefill_chunk", bucket=64, batch_size=1)
    assert a.predicted_ms == pytest.approx(26.0) and a.cost_judged  # 5e9 B at 2e11 B/s + 1
    assert a.cost_shared_ms == b.predicted_ms and b.cost_shared_ms == a.predicted_ms
    _close(timeline, a, 150.0)
    assert a.residual_ratio == pytest.approx(150.0 / 52.0) and a.anomaly is None
    _close(timeline, b, 10_000.0)
    assert b.anomaly == "slow_dispatch"
    event, = [e for e in model.ring.events() if e["dispatch_id"] == b.dispatch_id]
    assert event["shared_ms"] == pytest.approx(26.0)
    assert event["predicted_ms"] == pytest.approx(52.0)
    alone = timeline.begin("prefill_chunk", bucket=64, batch_size=1)
    assert alone.cost_shared_ms == 0.0
    _close(timeline, alone, 150.0)
    assert alone.residual_ratio == pytest.approx(150.0 / 26.0) and alone.anomaly == "slow_dispatch"
    assert alone.to_dict()["cost_shared_ms"] == 0.0
    assert a.to_dict()["cost_shared_ms"] == pytest.approx(26.0)


def test_a_prefill_and_the_chunks_beside_it_price_each_other(tmp_path):
    """Pool chunks beside each other (pipelining, the mix a row is fitted
    on) are priced alone; a prefill, of the base path or an adapter's,
    adds its prediction to each dispatch in flight beside it, and theirs to
    its own."""
    _, timeline = _timeline(tmp_path, "int8")
    chunk = timeline.begin("decode_chunk", batch_size=8)
    piped = timeline.begin("decode_chunk", batch_size=8)
    assert chunk.cost_shared_ms == piped.cost_shared_ms == 0.0
    prefill = timeline.begin("prefill_chunk", bucket=64, batch_size=1)
    assert prefill.cost_shared_ms == pytest.approx(chunk.predicted_ms + piped.predicted_ms)
    assert chunk.cost_shared_ms == piped.cost_shared_ms == prefill.predicted_ms
    adapter = timeline.begin("prefill_chunk", bucket=64, batch_size=1, adapter=True)
    assert adapter.cost_path == "int8+lora"
    assert adapter.cost_shared_ms == pytest.approx(
        chunk.predicted_ms + piped.predicted_ms + prefill.predicted_ms)
    assert chunk.cost_shared_ms == pytest.approx(prefill.predicted_ms + adapter.predicted_ms)
    assert prefill.cost_shared_ms == pytest.approx(
        chunk.predicted_ms + piped.predicted_ms + adapter.predicted_ms)
    # sheets without a path (the echo runner's, the JAX package's) are
    # judged as the JAX package judges them, concurrent or not
    model = tc.CostModel(profile_path=str(tmp_path / "none.json"))
    model.calibrate("cpu", "cpu")
    model.install_synthetic("prefill", 1.0)
    timeline = DispatchTimeline(costmodel=model)
    a, b = (timeline.begin("prefill", bucket=64, batch_size=1) for _ in range(2))
    assert a.cost_shared_ms == b.cost_shared_ms == 0.0 and a.cost_path is None
    assert "cost_shared_ms" not in a.to_dict()


def test_join_records_leaves_shared_dispatches_out():
    sheets = [{"kind": "prefill", "bucket": 64, "batch": 8, "width": 0,
               "flops": 1.0e12, "bytes_accessed": 1.0e9, "path": "int8"}]
    dispatches = [{"kind": "prefill", "bucket": 64, "batch_size": 8, "status": "ok",
                   "tokens": 0, "duration_s": d, "cost_path": "int8", "cost_shared_ms": shared}
                  for d, shared in ((0.1, 0.0), (5.0, 26.0))]
    assert [r["duration_s"] for r in tcal.join_records(dispatches, sheets)] == [0.1]
