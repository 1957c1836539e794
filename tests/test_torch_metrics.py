"""gofr_tpu_torch's metrics against gofr_tpu's: the same registrations
and observations give the same exposition byte for byte, in text 0.0.4
and in OpenMetrics 1.0 (exemplar timestamps pinned); the cardinality
guard counts its overflow; and the port's metric families follow
tests/test_metric_naming.py's convention and are the JAX package's own
(name, kind and labels)."""

import math
import pathlib
import re

import numpy as np
import pytest

import gofr_tpu
import gofr_tpu_torch
from gofr_tpu import metrics as jm
from gofr_tpu_torch import metrics as tm

PORT_DIR = pathlib.Path(gofr_tpu_torch.__file__).parent
JAX_DIR = pathlib.Path(gofr_tpu.__file__).parent
# tests/test_metric_naming.py's scan and rule
_REGISTRATION = re.compile(r'\.(counter|gauge|histogram)\(\s*\n?\s*"([^"]+)"', re.MULTILINE)
_COUNTER_SUFFIXES = ("_total",)
_HISTOGRAM_SUFFIXES = ("_seconds", "_bytes", "_size")
_GAUGE_SUFFIXES = (
    "_seconds", "_bytes", "_total", "_depth", "_ratio", "_entries",
    "_active", "_acceptance", "_state", "_blocks", "_size", "_level",
    "_per_dispatch", "_rate", "_remaining",
)
_GAUGE_ALLOWLIST = {"gofr_tpu_mfu", "gofr_tpu_mbu"}


def _drive(m, seed, provider=None, max_series=1000):
    """One scripted workload against a package's metrics module."""
    rng = np.random.default_rng(seed)
    reg = m.Registry(max_series=max_series, exemplar_provider=provider)
    plain = reg.counter("gofr_plain_total", "a counter without labels")
    plain.inc()
    plain.inc(2.5)
    reg.counter("gofr_untouched_total", "")
    reqs = reg.counter("gofr_http_requests_total", "HTTP requests",
                       labels=("method", "path", "status"))
    for method, path, status in (("GET", "/a", "200"), ("POST", "/b/{id}", "500"),
                                 ("GET", "/a", "200"), ("GET", 'q"uo\\te\nnl', "404")):
        reqs.inc(method=method, path=path, status=status)
    g = reg.gauge("gofr_depth", 'help with \\ backslash\nand newline', labels=("model",))
    g.set(7, model="x")
    g.dec(0.25, model="x")
    g.set(float(rng.standard_normal()), model="y")
    g.set(1e-7, model="tiny")
    g.set(12345678901.0, model="big")
    g.set(math.inf, model="inf")
    lat = reg.histogram("gofr_latency_seconds", "latency", labels=("path",))
    for v in rng.exponential(0.05, 40):
        lat.observe(float(v), path="/a")
    lat.observe(0.1 + 0.2, path="/b")
    lat.observe(99.0, exemplar={"trace_id": "ab" * 16}, path="/b")
    lat.observe(0.004, exemplar={"trace_id": "x" * 200, "other": "y"}, path="/b")
    sizes = reg.histogram("gofr_batch_size", "batch sizes", labels=("model",),
                          buckets=(1, 2, 4, 8, 16))
    for n in (1, 3, 8, 20):
        sizes.observe(n, model="m")
    with m.Timer(reg.histogram("gofr_timer_seconds", "")):
        pass
    capped = reg.gauge("gofr_capped_ratio", "", labels=("k",))
    for i in range(max_series + 3):
        capped.set(i, k=str(i))
    return reg


@pytest.mark.parametrize("openmetrics", [False, True], ids=["text-0.0.4", "openmetrics-1.0"])
@pytest.mark.parametrize("seed", [0, 1])
def test_exposition_is_byte_equal(monkeypatch, seed, openmetrics):
    monkeypatch.setattr(jm.time, "time", lambda: 1760000000.25)
    monkeypatch.setattr(jm.time, "perf_counter", lambda: 5.0)  # the Timer's clock
    assert tm.time is jm.time  # one clock pinned for both packages

    def provider():
        return {"trace_id": "cd" * 16}

    want = _drive(jm, seed, provider, max_series=5)
    got = _drive(tm, seed, provider, max_series=5)
    text = got.expose(openmetrics=openmetrics)
    assert text == want.expose(openmetrics=openmetrics)
    assert text.endswith("# EOF\n") == openmetrics
    if openmetrics:
        assert '# {trace_id="' + "cd" * 16 + '"}' in text  # provider exemplars
        assert '# {trace_id="' + "ab" * 16 + '"} 99 1760000000.250' in text
    # the guard: 5 label-sets admitted, the rest counted as dropped
    assert got._dropped.value(metric="gofr_capped_ratio") == 3
    assert len(got.collect()["gofr_capped_ratio"]["series"]) == 5
    assert got.collect() == want.collect()


def test_percentiles_and_formatting_agree():
    jh = jm.Histogram("gofr_h_seconds", "", buckets=(0.1, 0.5, 1.0))
    th = tm.Histogram("gofr_h_seconds", "", buckets=(0.1, 0.5, 1.0))
    for v in (0.05, 0.06, 0.2, 0.7, 2.0):
        jh.observe(v)
        th.observe(v)
    for q in (0.1, 0.5, 0.9, 0.99):
        for interp in (False, True):
            assert th.percentile(q, interp) == jh.percentile(q, interp)
    for v in (0.0, 1.0, 2.5, 1e-9, 3e20, math.inf, -4.0, 0.30000000000000004):
        assert tm._fmt_value(v) == jm._fmt_value(v)
        assert tm._fmt_le_openmetrics(v) == jm._fmt_le_openmetrics(v)


def test_registry_reuse_and_type_conflict():
    reg = tm.Registry()
    assert reg.counter("gofr_x_total") is reg.counter("gofr_x_total")
    with pytest.raises(TypeError):
        reg.gauge("gofr_x_total")


def _registrations(root):
    found = []
    for path in sorted(root.rglob("*.py")):
        for kind, name in _REGISTRATION.findall(path.read_text(encoding="utf-8")):
            found.append((str(path.relative_to(root)), kind, name))
    return found


def test_every_port_metric_follows_the_naming_convention():
    regs = _registrations(PORT_DIR)
    names = {name for _, _, name in regs}
    assert {"gofr_http_requests_total", "gofr_tpu_ttft_seconds", "gofr_tpu_batch_size",
            "gofr_tpu_decode_slots_active", "gofr_tpu_kv_blocks",
            "gofr_tpu_spec_accept_ratio", "gofr_tpu_pool_reject_total"} <= names
    problems = []
    for where, kind, name in regs:
        if not name.startswith("gofr_"):
            problems.append(f"{where}: {name} missing gofr_ prefix")
        elif not re.fullmatch(r"[a-z][a-z0-9_]*", name) or "__" in name:
            problems.append(f"{where}: {name} is not snake_case")
        elif kind == "counter" and not name.endswith(_COUNTER_SUFFIXES):
            problems.append(f"{where}: counter {name} must end in _total")
        elif kind == "histogram" and not name.endswith(_HISTOGRAM_SUFFIXES):
            problems.append(f"{where}: histogram {name} needs a unit suffix")
        elif (kind == "gauge" and name not in _GAUGE_ALLOWLIST
              and not name.endswith(_GAUGE_SUFFIXES)):
            problems.append(f"{where}: gauge {name} needs a unit/dimension suffix")
    assert not problems, "\n".join(problems)


def test_every_port_family_is_a_jax_family():
    """By the source scan, every name the port registers is one the JAX
    package registers, with the same kind."""
    jax_kinds = {}
    for _, kind, name in _registrations(JAX_DIR):
        jax_kinds.setdefault(name, set()).add(kind)
    for where, kind, name in _registrations(PORT_DIR):
        assert kind in jax_kinds.get(name, ()), f"{where}: {kind} {name} is not the JAX package's"


def _wired(m, middleware, batcher_mod, sched_mod, pool_mod, spec_mod, deadline):
    """Every registration site of a package, on one registry."""
    reg = m.Registry()
    middleware.metrics_middleware(reg)
    sched_mod.InterferenceScheduler(metrics=reg, model="m")
    b = batcher_mod.DynamicBatcher(lambda x: x, metrics=reg, name="m", bucket_fn=len)
    b.close()
    pool_mod.BlockPool(4, 2, metrics=reg)
    spec_mod.PoolSpecConfig(metrics=reg, model="m")
    deadline.deadline_exceeded_counter(reg)
    deadline.cancellations_counter(reg)
    deadline.pool_reject_counter(reg)
    reg.gauge("gofr_tpu_decode_slots_active", "active decode slots")
    return reg


def test_families_have_the_jax_kind_and_labels():
    """At run time: the device's, the middleware's, the batcher's, the
    scheduler's, the paged pool's and the spec config's families, each
    with the JAX package's kind, labels and buckets."""
    from gofr_tpu import deadline as jdl
    from gofr_tpu.http import middleware as jmw
    from gofr_tpu.tpu import batcher as jb
    from gofr_tpu.tpu import kv_blocks as jkv
    from gofr_tpu.tpu import scheduler as js
    from gofr_tpu.tpu import spec_pool as jsp
    from gofr_tpu_torch import deadline as tdl
    from gofr_tpu_torch.http import middleware as tmw
    from gofr_tpu_torch.tpu import batcher as tb
    from gofr_tpu_torch.tpu import kv_blocks as tkv
    from gofr_tpu_torch.tpu import scheduler as ts
    from gofr_tpu_torch.tpu import spec_pool as tsp
    from gofr_tpu_torch.tpu.device import TPUDevice

    want = _wired(jm, jmw, jb, js, jkv, jsp, jdl).collect()
    got = _wired(tm, tmw, tb, ts, tkv, tsp, tdl).collect()
    # the device's own families: registered by its constructor alone
    dev = TPUDevice.__new__(TPUDevice)
    reg = tm.Registry()
    dev._init_metrics(reg)
    jreg = jm.Registry()
    jax_device_families = {
        "gofr_tpu_requests_total", "gofr_tpu_ttft_seconds", "gofr_tpu_device_memory_bytes",
        "gofr_tpu_tokens_total", "gofr_tpu_spec_acceptance", "gofr_tpu_prefix_hit_ratio",
        "gofr_tpu_prefix_partial_hit_ratio", "gofr_tpu_prefix_entries",
        "gofr_tpu_mfu", "gofr_tpu_compile_seconds", "gofr_tpu_compiles_total",
        "gofr_tpu_cache_events_total", "gofr_tpu_kv_transfer_total",
        "gofr_tpu_mesh_axis_size", "gofr_tpu_mesh_degrade_total",
    }
    from gofr_tpu.tpu.device import TPUDevice as JaxDevice

    jdev = JaxDevice.__new__(JaxDevice)
    JaxDevice._init_metrics(jdev, jreg)
    want.update({k: v for k, v in jreg.collect().items() if k in jax_device_families})
    got.update({k: v for k, v in reg.collect().items() if k != "gofr_tpu_metrics_dropped_series_total"})
    assert set(got) <= set(want)
    for name, fam in got.items():
        w = want[name]
        assert (fam["kind"], fam["label_names"], fam["buckets"]) == \
            (w["kind"], w["label_names"], w["buckets"]), name
