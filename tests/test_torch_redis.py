"""The port's RESP client and in-process redis server
(``gofr_tpu_torch/datasource/redis.py``, ``miniredis.py``), case for case
with ``tests/test_redis.py``, then beside the JAX package's: each client
against the other package's server, the bytes both ways on the wire (the
JAX client's and server's exactly), and the fleet quota's redis path
across the packages."""

import threading
import time

import pytest

from gofr_tpu_torch.datasource.miniredis import MiniRedis
from gofr_tpu_torch.datasource.redis import RedisClient, RedisError, RedisServerError, new_client
from gofr_tpu_torch.logging import Level
from gofr_tpu_torch.testutil import MockLogger


@pytest.fixture(scope="module")
def mini():
    server = MiniRedis().run()
    yield server
    server.close()


@pytest.fixture
def client(mini):
    logger = MockLogger(Level.DEBUG)
    c = new_client("127.0.0.1", mini.port, logger)
    c.flushdb()
    yield c, logger
    c.close()


def test_set_get_roundtrip(client):
    c, logger = client
    assert c.set("greeting", "hello") == "OK"
    assert c.get("greeting") == "hello"
    assert c.get("missing") is None
    # logged command with duration (parity: redis_test.go:49-51)
    assert "SET greeting hello" in logger.output
    assert "duration_us" in logger.output


def test_set_with_expiry(client):
    c, _ = client
    c.set("temp", "x", ex=100)
    assert 0 < c.ttl("temp") <= 100
    assert c.ttl("no-such-key") == -2


def test_incr_del_exists(client):
    c, _ = client
    assert c.incr("counter") == 1
    assert c.incr("counter") == 2
    assert c.exists("counter") == 1
    assert c.delete("counter") == 1
    assert c.exists("counter") == 0


def test_hash_and_list_ops(client):
    c, _ = client
    assert c.hset("h", "field", "v") == 1
    assert c.hget("h", "field") == "v"
    c.lpush("l", "a", "b")
    assert c.rpop("l") == "a"


def test_keys_pattern(client):
    c, _ = client
    c.set("user:1", "a")
    c.set("user:2", "b")
    c.set("other", "c")
    assert sorted(c.keys("user:*")) == ["user:1", "user:2"]


def test_server_error_keeps_connection(client):
    c, _ = client
    c.lpush("alist", "x")
    with pytest.raises(RedisServerError):
        c.get("alist")  # WRONGTYPE
    assert c.ping()  # connection still usable


def test_health_check(client, mini):
    c, _ = client
    h = c.health_check()
    assert h.status == "UP"
    assert h.details["redis_version"] == "7.0.0-mini"
    assert "latency_us" in h.details


def test_connect_failure_raises():
    with pytest.raises(OSError):
        RedisClient("127.0.0.1", 1, timeout=0.2)


def test_concurrent_clients(client):
    c, _ = client
    errors = []

    def work(i):
        try:
            c.set(f"k{i}", str(i))
            assert c.get(f"k{i}") == str(i)
        except Exception as exc:
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors


# -- pipelining (parity: redis/hook.go:38-58 pipeline logging) ----------------

def test_pipeline_one_round_trip_in_order(client):
    c, logger = client
    p = c.pipeline()
    p.set("pa", "1").incr("pc").get("pa").command("ECHO", "hi")
    assert len(p) == 4
    results = p.execute()
    assert results == ["OK", 1, "1", "hi"]
    assert p.results == results
    assert len(p) == 0  # queue drained
    assert "pipeline[4]" in logger.output  # batched RedisLog entry


def test_pipeline_context_manager(client):
    c, _ = client
    with c.pipeline() as p:
        p.set("cm", "x")
        p.get("cm")
    assert p.results == ["OK", "x"]


def test_pipeline_error_drains_and_raises(client):
    c, _ = client
    p = c.pipeline()
    p.set("pe", "v").command("INCR", "pe").get("pe")
    with pytest.raises(RedisServerError):
        p.execute()
    # all replies were drained: the connection stays usable
    assert c.get("pe") == "v"


def test_pipeline_errors_returned_when_not_raising(client):
    c, _ = client
    p = c.pipeline()
    p.set("pr", "v").command("INCR", "pr").get("pr")
    results = p.execute(raise_on_error=False)
    assert results[0] == "OK"
    assert isinstance(results[1], RedisServerError)
    assert results[2] == "v"


def test_empty_pipeline(client):
    c, _ = client
    assert c.pipeline().execute() == []


# -- the two packages on one wire --------------------------------------------

import socket  # noqa: E402

from gofr_tpu.datasource import miniredis as jax_miniredis  # noqa: E402
from gofr_tpu.datasource import redis as jax_redis  # noqa: E402
from gofr_tpu_torch.datasource import miniredis as torch_miniredis  # noqa: E402
from gofr_tpu_torch.datasource import redis as torch_redis  # noqa: E402


class _Tap:
    """A TCP relay to ``target_port`` that records, per connection, the
    bytes each direction carried."""

    def __init__(self, target_port):
        self.target_port = target_port
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.port = self.sock.getsockname()[1]
        self.conns = []
        self._pumps = []
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                client, _ = self.sock.accept()
            except OSError:
                return
            upstream = socket.create_connection(("127.0.0.1", self.target_port))
            record = {"up": bytearray(), "down": bytearray()}
            self.conns.append(record)
            for src, dst, key in ((client, upstream, "up"), (upstream, client, "down")):
                t = threading.Thread(target=self._pump, args=(src, dst, record[key]),
                                     daemon=True)
                t.start()
                self._pumps.append(t)

    @staticmethod
    def _pump(src, dst, into):
        try:
            while True:
                chunk = src.recv(65536)
                if not chunk:
                    break
                into += chunk
                dst.sendall(chunk)
        except OSError:
            pass
        finally:
            for sock in (src, dst):
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    def close(self):
        for t in self._pumps:
            t.join(timeout=5)
        self.sock.close()
        return [(bytes(c["up"]), bytes(c["down"])) for c in self.conns]


def _scripted_session(client_mod, port):
    """One connection's worth of the client's surface: strings with
    expiry, counters, hashes, lists, patterns, a WRONGTYPE error, a
    pipeline with an error left in its results, and INFO."""
    c = client_mod.new_client("127.0.0.1", port, None)
    out = [
        c.flushdb(),
        c.set("greeting", "héllo wörld 🎉"),
        c.get("greeting"),
        c.get("missing"),
        c.set("temp", "x", ex=100),
        c.ttl("temp"),
        c.incr("counter"),
        c.incr("counter"),
        c.exists("counter"),
        c.delete("counter"),
        c.hset("h", "field", "v"),
        c.hget("h", "field"),
        c.lpush("l", "a", "b"),
        c.rpop("l"),
        sorted(c.keys("*")),
    ]
    try:
        c.get("l")
    except Exception as exc:
        out.append((type(exc).__name__, str(exc)))
    p = c.pipeline()
    p.set("pa", "1").incr("pc").get("pa").command("ECHO", "hi").command("INCR", "pa\r\nx")
    out.append([repr(r) if isinstance(r, Exception) else r
                for r in p.execute(raise_on_error=False)])
    out.append(c.ping())
    health = c.health_check()
    out.append((health.status, health.details.get("redis_version")))
    c.close()
    return out


@pytest.mark.parametrize("server_name", ["jax", "torch"])
@pytest.mark.parametrize("client_name", ["jax", "torch"])
def test_wire_bytes_equal_the_jax_client_and_server(client_name, server_name):
    """Each client against each server, through a recording relay: the
    answers and both directions' bytes equal the JAX client's against the
    JAX server."""
    servers = {"jax": jax_miniredis, "torch": torch_miniredis}
    clients = {"jax": jax_redis, "torch": torch_redis}
    runs = []
    for c_name, s_name in (("jax", "jax"), (client_name, server_name)):
        server = servers[s_name].MiniRedis().run()
        tap = _Tap(server.port)
        try:
            answers = _scripted_session(clients[c_name], tap.port)
        finally:
            conns = tap.close()
            server.close()
        assert len(conns) == 1
        runs.append((conns[0], answers))
    (ref_wire, ref_answers), (wire, answers) = runs
    assert ref_answers[2] == "héllo wörld 🎉" and ref_answers[-1][0] == "UP"
    assert answers == ref_answers
    assert wire[0] == ref_wire[0]
    assert wire[1] == ref_wire[1]


def test_redis_log_equals_jax():
    """The command log: the same entries for the same commands (the
    command text, the datasource; not the durations)."""
    import json

    from gofr_tpu.testutil import MockLogger as JaxMockLogger

    server = torch_miniredis.MiniRedis().run()
    entries = []
    try:
        for mod, logger in ((jax_redis, JaxMockLogger(Level.DEBUG)),
                            (torch_redis, MockLogger(Level.DEBUG))):
            c = mod.new_client("127.0.0.1", server.port, logger)
            c.set("k", "v", ex=5)
            c.get("k")
            p = c.pipeline()
            p.incr("n").get("k")
            p.execute()
            c.close()
            lines = []
            for line in logger.lines:
                message = json.loads(line)["message"]
                message.pop("duration_us", None)
                lines.append(message)
            entries.append(lines)
    finally:
        server.close()
    assert entries[1] == entries[0] and len(entries[0]) == 4  # the connect PING too


def test_port_quota_over_the_jax_miniredis():
    """The fleet's quota table of the port over the JAX package's redis
    server (the port's client between): the pipelined HGET/HSET/EXPIRE
    bucket is shared by two tables (two routers), a JAX table over the
    same server sees the same spent bucket, and idle tenants expire."""
    from gofr_tpu.fleet.admission import QuotaTable as JaxQuotaTable
    from gofr_tpu_torch.fleet.admission import QuotaTable

    mini = jax_miniredis.MiniRedis().run()
    client = torch_redis.new_client("127.0.0.1", mini.port, MockLogger())
    jax_client = jax_redis.new_client("127.0.0.1", mini.port, None)
    try:
        table = QuotaTable(rate_rps=0.001, burst=1.0, redis=client)
        assert table.take("t")[0]
        sibling = QuotaTable(rate_rps=0.001, burst=1.0, redis=client)
        ok, retry_after = sibling.take("t")
        assert not ok and retry_after > 0
        jax_table = JaxQuotaTable(rate_rps=0.001, burst=1.0, redis=jax_client)
        jax_ok, jax_retry = jax_table.take("t")
        assert not jax_ok and jax_retry > 0
        assert table.stats()["backend"] == "redis"
        assert client.ttl("fleet:quota:t") > 0
    finally:
        client.close()
        jax_client.close()
        mini.close()
