"""The port's container wiring (``gofr_tpu_torch/container.py``), case for
case with ``tests/test_container.py``, then the datasources through a
running app (``ctx.redis``, ``ctx.db``, ``ctx.get_http_service``) and the
health aggregation beside the JAX package's container."""

from gofr_tpu_torch.config import EnvFileConfig as EnvConfig
from gofr_tpu_torch.container import Container, new_container


def test_no_datasources_by_default(monkeypatch):
    for key in ("REDIS_HOST", "DB_NAME", "DB_HOST", "TPU_ENABLED", "MODEL_NAME"):
        monkeypatch.delenv(key, raising=False)
    c = new_container(EnvConfig())
    assert c.redis is None and c.db is None and c.tpu is None
    health = c.health()
    assert health["status"] == "UP"
    assert health["details"] == {}


def test_invalid_redis_host_degrades(monkeypatch):
    monkeypatch.setenv("REDIS_HOST", "256.0.0.1")
    monkeypatch.setenv("REDIS_PORT", "1")
    monkeypatch.delenv("DB_NAME", raising=False)
    monkeypatch.delenv("DB_HOST", raising=False)
    monkeypatch.delenv("TPU_ENABLED", raising=False)
    monkeypatch.delenv("MODEL_NAME", raising=False)
    c = Container(EnvConfig())  # must not raise
    assert c.redis is None


def test_get_http_service_nil_safe():
    c = Container(EnvConfig(), wire=False)
    assert c.get_http_service("missing") is None
    sentinel = object()
    c.services["x"] = sentinel
    assert c.get_http_service("x") is sentinel


def test_health_aggregates_down(monkeypatch):
    c = Container(EnvConfig(), wire=False)

    class FakeSource:
        def health_check(self):
            from gofr_tpu_torch.datasource.health import DOWN, Health

            return Health(DOWN, {"err": "x"})

    c.redis = FakeSource()
    health = c.health()
    assert health["status"] == "DOWN"
    assert health["details"]["redis"]["status"] == "DOWN"


# -- the datasources, the service client and health, beside the JAX package --

import json  # noqa: E402
import urllib.request  # noqa: E402

import pytest  # noqa: E402


def _scrub(monkeypatch):
    for key in ("REDIS_HOST", "REDIS_PORT", "DB_NAME", "DB_HOST", "DB_DIALECT",
                "DB_PORT", "DB_USER", "DB_PASSWORD", "TPU_ENABLED", "MODEL_NAME"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("LOG_LEVEL", "FATAL")
    monkeypatch.setenv("TIMEBASE_ENABLED", "off")


def _shape(health):
    """A health body without its measured values (latency, addresses)."""
    return {
        "status": health["status"],
        "details": {name: {"status": d["status"], "keys": sorted(d.get("details", {}))}
                    for name, d in health["details"].items()},
    }


def test_health_aggregation_equals_jax(monkeypatch, tmp_path):
    """Redis (the port's MiniRedis) and sql (a sqlite file) wired from the
    same settings in both packages' containers give the same health, UP
    and then, with redis gone, DOWN."""
    from gofr_tpu.config import EnvConfig as JaxEnvConfig
    from gofr_tpu.container import Container as JaxContainer
    from gofr_tpu_torch.datasource.miniredis import MiniRedis

    _scrub(monkeypatch)
    mini = MiniRedis().run()
    monkeypatch.setenv("REDIS_HOST", "127.0.0.1")
    monkeypatch.setenv("REDIS_PORT", str(mini.port))
    monkeypatch.setenv("DB_NAME", str(tmp_path / "app.db"))
    containers = [JaxContainer(JaxEnvConfig()), Container(EnvConfig())]
    try:
        up = [_shape(c.health()) for c in containers]
        assert up[1] == up[0]
        assert up[0]["status"] == "UP" and set(up[0]["details"]) == {"redis", "sql"}
        assert containers[1].db.select_value("SELECT 2+2") == 4
        assert containers[1].redis.set("k", "v") == "OK"
        mini.close()
        down = [_shape(c.health()) for c in containers]
        assert down[1] == down[0]
        assert down[0]["status"] == "DOWN"
        assert down[0]["details"]["redis"]["status"] == "DOWN"
        assert down[0]["details"]["sql"]["status"] == "UP"
    finally:
        for c in containers:
            c.close()
        mini.close()


def test_app_serves_the_datasources_and_a_service(monkeypatch, tmp_path, free_port):
    """A running app: handlers reach ``ctx.redis``, ``ctx.db`` and a
    registered service (``add_http_service``, here the app itself), and
    ``/.well-known/health`` lists the datasources; a redis that stops
    degrades health and the other routes still answer."""
    import gofr_tpu_torch
    from gofr_tpu_torch.datasource.miniredis import MiniRedis

    _scrub(monkeypatch)
    mini = MiniRedis().run()
    port = free_port()
    monkeypatch.setenv("HTTP_PORT", str(port))
    monkeypatch.setenv("REDIS_HOST", "127.0.0.1")
    monkeypatch.setenv("REDIS_PORT", str(mini.port))
    monkeypatch.setenv("DB_DIALECT", "sqlite")
    monkeypatch.setenv("DB_NAME", ":memory:")
    monkeypatch.chdir(tmp_path)
    app = gofr_tpu_torch.new()
    app.add_http_service("self", f"http://127.0.0.1:{port}")
    app.get("/redis", lambda ctx: ctx.redis.get("greeting"))
    app.get("/mysql", lambda ctx: ctx.db.select_value("SELECT 2+2"))
    app.get("/via", lambda ctx: ctx.get_http_service("self").get("redis").json())
    app.get("/host", lambda ctx: [ctx.host_name() != "", ctx.params("a")])
    app.start()

    def get(path):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read())

    try:
        app.container.redis.set("greeting", "hi")
        assert get("/redis") == (200, {"data": "hi"})
        assert get("/mysql") == (200, {"data": 4})
        assert get("/via") == (200, {"data": {"data": "hi"}})
        assert get("/host?a=1&a=2") == (200, {"data": [True, ["1", "2"]]})
        status, body = get("/.well-known/health")
        assert status == 200 and body["data"]["status"] == "UP"
        assert {k: v["status"] for k, v in body["data"]["details"].items()} == {
            "redis": "UP", "sql": "UP"}
        mini.close()
        status, body = get("/.well-known/health")
        assert body["data"]["status"] == "DOWN"
        assert body["data"]["details"]["redis"]["status"] == "DOWN"
        assert get("/mysql") == (200, {"data": 4})
    finally:
        app.shutdown()
        mini.close()
    assert app.container.redis is not None  # closed, not dropped


@pytest.mark.parametrize("key,value", [
    ("REDIS_HOST", "127.0.0.1"), ("DB_NAME", ":memory:"), ("GRPC_PORT", "9999"),
    ("BATCH_COHORT", "off"), ("OPENAI_ACCEPT_UNKNOWN_MODEL", "on"),
])
def test_moved_keys_boot_without_a_warning(monkeypatch, tmp_path, key, value):
    """The datasource keys, ``GRPC_PORT``, ``BATCH_COHORT`` and
    ``OPENAI_ACCEPT_UNKNOWN_MODEL`` are honored: a boot with one set
    neither refuses nor warns about it."""
    from gofr_tpu_torch.testutil import stdout_output_for

    _scrub(monkeypatch)
    monkeypatch.setenv("LOG_LEVEL", "WARN")
    monkeypatch.setenv("REDIS_PORT", "1")  # nothing listens: a degraded boot
    monkeypatch.setenv(key, value)
    monkeypatch.chdir(tmp_path)
    built = []
    out = stdout_output_for(lambda: built.append(Container(EnvConfig())))
    built[0].close()
    assert "does not honor" not in out
