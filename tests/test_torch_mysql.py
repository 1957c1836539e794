"""The port's MySQL wire-protocol client and its in-process server
(``gofr_tpu_torch/datasource/mysql.py``, ``minimysql.py``), case for case
with ``tests/test_mysql.py``, then beside the JAX package's: each client
against the other package's server, and the bytes both ways on the wire,
which must be the JAX client's and server's exactly."""

import dataclasses
import threading

import pytest

from gofr_tpu_torch.datasource.minimysql import MiniMySQL
from gofr_tpu_torch.datasource.mysql import (
    MySQLDB,
    MySQLError,
    escape_literal,
    interpolate,
    native_password_token,
)


@pytest.fixture(scope="module")
def server():
    with MiniMySQL(user="gofr", password="s3cret") as srv:
        yield srv


@pytest.fixture()
def db(server):
    d = MySQLDB("127.0.0.1", server.port, "gofr", "s3cret", "test")
    yield d
    d.close()


def test_handshake_and_ping(db):
    h = db.health_check()
    assert h.status == "UP"
    assert h.details["dialect"] == "mysql"
    assert "minimysql" in h.details["server_version"]


def test_wrong_password_denied(server):
    with pytest.raises(MySQLError, match="Access denied"):
        MySQLDB("127.0.0.1", server.port, "gofr", "wrong", "test")


def test_wrong_user_denied(server):
    with pytest.raises(MySQLError, match="Access denied"):
        MySQLDB("127.0.0.1", server.port, "intruder", "s3cret", "test")


def test_ddl_dml_and_text_resultset(db):
    db.execute("DROP TABLE IF EXISTS users")
    db.execute("CREATE TABLE users (id INTEGER, full_name TEXT, score REAL)")
    n = db.execute("INSERT INTO users VALUES (?, ?, ?)", 1, "Ada Lovelace", 9.5)
    assert n == 1
    db.execute_many("INSERT INTO users VALUES (?, ?, ?)",
                    [(2, "Grace Hopper", 8.25), (3, None, None)])
    rows = db.query("SELECT id, full_name, score FROM users ORDER BY id")
    assert [tuple(r) for r in rows] == [
        (1, "Ada Lovelace", 9.5), (2, "Grace Hopper", 8.25), (3, None, None),
    ]
    assert rows[0]["full_name"] == "Ada Lovelace"
    assert rows[0].keys() == ["id", "full_name", "score"]


def test_escaping_survives_round_trip(db):
    db.execute("DROP TABLE IF EXISTS notes")
    db.execute("CREATE TABLE notes (body TEXT)")
    evil = "Robert'); DROP TABLE notes;-- \" \\ \n über 🎉"
    db.execute("INSERT INTO notes VALUES (?)", evil)
    assert db.select_value("SELECT body FROM notes") == evil
    assert db.select_value("SELECT COUNT(*) FROM notes") == 1  # not dropped


def test_blob_bytes_vs_text_str(db):
    """BLOB (charset 63) round-trips as bytes; TEXT shares the wire type
    but decodes to str."""
    db.execute("DROP TABLE IF EXISTS b_t")
    db.execute("CREATE TABLE b_t (data BLOB)")
    blob = bytes(range(256))
    db.execute("INSERT INTO b_t VALUES (?)", blob)
    assert db.select_value("SELECT data FROM b_t") == blob


def test_connection_recovers_after_io_error(db, server):
    """An I/O error discards the desynced connection; the next call
    reconnects instead of reading stale packets."""
    db.execute("DROP TABLE IF EXISTS r_t")
    db.execute("CREATE TABLE r_t (v INTEGER)")
    db.execute("INSERT INTO r_t VALUES (1)")
    db._get_conn().sock.close()  # simulate a dropped connection
    with pytest.raises(Exception):
        db.query("SELECT v FROM r_t")
    assert db.select_value("SELECT v FROM r_t") == 1  # fresh connection


def test_connections_are_per_thread(db):
    """Transactions are connection-scoped in MySQL; per-thread connections
    keep one handler's BEGIN from swallowing another handler's statements
    (the sqlite DB uses the same strategy)."""
    conns = {}

    def grab(i):
        conns[i] = db._get_conn()
        db.select_value("SELECT 1")

    threads = [threading.Thread(target=grab, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert conns[0] is not conns[1]
    assert conns[0] is not db._get_conn()  # main thread has its own too


def test_select_into_dataclass(db):
    @dataclasses.dataclass
    class User:
        id: int = 0
        full_name: str = ""
        ignored: str = dataclasses.field(default="", metadata={"db": "nope"})

    db.execute("DROP TABLE IF EXISTS users2")
    db.execute("CREATE TABLE users2 (id INTEGER, full_name TEXT, extra TEXT)")
    db.execute("INSERT INTO users2 VALUES (?, ?, ?)", 7, "Katherine", "x")
    users = db.select(User, "SELECT * FROM users2")
    assert users == [User(id=7, full_name="Katherine")]
    one = db.select_one(User, "SELECT * FROM users2 WHERE id = ?", 7)
    assert one.full_name == "Katherine"
    assert db.select_one(User, "SELECT * FROM users2 WHERE id = ?", 404) is None


def test_transaction_commit_and_rollback(db):
    db.execute("DROP TABLE IF EXISTS tx_t")
    db.execute("CREATE TABLE tx_t (v INTEGER)")
    with db.begin() as tx:
        tx.execute("INSERT INTO tx_t VALUES (1)")
    assert db.select_value("SELECT COUNT(*) FROM tx_t") == 1
    with pytest.raises(RuntimeError, match="boom"):
        with db.begin() as tx:
            tx.execute("INSERT INTO tx_t VALUES (2)")
            raise RuntimeError("boom")
    assert db.select_value("SELECT COUNT(*) FROM tx_t") == 1  # rolled back


def test_sql_error_propagates(db):
    with pytest.raises(MySQLError, match="1064"):
        db.query("SELEKT broken")


def test_concurrent_queries_serialize_safely(db):
    db.execute("DROP TABLE IF EXISTS c_t")
    db.execute("CREATE TABLE c_t (v INTEGER)")
    errors = []

    def worker(i):
        try:
            db.execute("INSERT INTO c_t VALUES (?)", i)
            db.query("SELECT * FROM c_t")
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert db.select_value("SELECT COUNT(*) FROM c_t") == 8


def test_interpolation_and_escaping_units():
    assert interpolate("SELECT ?", [1]) == "SELECT 1"
    assert interpolate("SELECT '?', ?", ["x"]) == "SELECT '?', 'x'"
    assert escape_literal(None) == "NULL"
    assert escape_literal(True) == "1"
    assert escape_literal(b"\x01\xff") == "x'01ff'"
    assert escape_literal("a'b") == r"'a\'b'"
    with pytest.raises(MySQLError, match="not enough"):
        interpolate("? ?", [1])


def test_native_password_token_shape():
    tok = native_password_token("pw", b"\x01" * 20)
    assert len(tok) == 20
    assert native_password_token("", b"\x01" * 20) == b""


def test_container_wires_mysql(server, monkeypatch):
    """DB_DIALECT=mysql end-to-end through config+container."""
    from gofr_tpu_torch.config import EnvFileConfig as EnvConfig
    from gofr_tpu_torch.container import Container

    monkeypatch.setenv("DB_DIALECT", "mysql")
    monkeypatch.setenv("DB_HOST", "127.0.0.1")
    monkeypatch.setenv("DB_PORT", str(server.port))
    monkeypatch.setenv("DB_USER", "gofr")
    monkeypatch.setenv("DB_PASSWORD", "s3cret")
    monkeypatch.setenv("DB_NAME", "test")
    monkeypatch.delenv("REDIS_HOST", raising=False)
    monkeypatch.delenv("MODEL_NAME", raising=False)
    monkeypatch.delenv("TPU_ENABLED", raising=False)
    c = Container(EnvConfig())
    assert c.db is not None
    assert c.db.execute("SELECT 1") == 0  # resultset path exercised below
    assert c.db.select_value("SELECT 41 + 1") == 42
    health = c.health()
    assert health["details"]["sql"]["status"] == "UP"
    c.close()


def test_container_degrades_on_bad_mysql(monkeypatch):
    from gofr_tpu_torch.config import EnvFileConfig as EnvConfig
    from gofr_tpu_torch.container import Container

    monkeypatch.setenv("DB_DIALECT", "mysql")
    monkeypatch.setenv("DB_HOST", "127.0.0.1")
    monkeypatch.setenv("DB_PORT", "1")  # nothing listens
    monkeypatch.setenv("DB_NAME", "test")
    monkeypatch.delenv("REDIS_HOST", raising=False)
    monkeypatch.delenv("MODEL_NAME", raising=False)
    monkeypatch.delenv("TPU_ENABLED", raising=False)
    c = Container(EnvConfig())
    assert c.db is None  # logged, not fatal (container.go:80-85 parity)
    c.close()


# -- caching_sha2_password (MySQL 8 default) -----------------------------------

def test_sha2_fast_auth_is_the_default():
    """The fixture server advertises caching_sha2_password (stock MySQL 8),
    so the happy path above already runs the sha2 scramble; this pins it."""
    with MiniMySQL(user="u", password="pw") as srv:
        assert srv.auth_plugin == "caching_sha2_password"
        db = MySQLDB("127.0.0.1", srv.port, "u", "pw", "")
        assert db.health_check().status == "UP"
        db.close()


def test_sha2_full_auth_rsa_exchange():
    """Cache-miss path: server demands perform_full_authentication; the
    client fetches the RSA key and sends the nonce-whitened password
    encrypted — over plain TCP, as go-sql-driver does without TLS."""
    with MiniMySQL(user="u", password="hunter2", full_auth=True) as srv:
        db = MySQLDB("127.0.0.1", srv.port, "u", "hunter2", "")
        assert db.select_value("select 41 + 1") == 42
        db.close()


def test_sha2_full_auth_wrong_password_denied():
    with MiniMySQL(user="u", password="right", full_auth=True) as srv:
        with pytest.raises(MySQLError) as exc:
            MySQLDB("127.0.0.1", srv.port, "u", "wrong", "")
        assert exc.value.code == 1045


def test_auth_switch_to_native_password():
    """Server advertises caching_sha2 but switches the account to
    mysql_native_password — the client must check the plugin NAME in the
    AuthSwitchRequest, not resend the old plugin's token."""
    with MiniMySQL(user="u", password="pw",
                   switch_to="mysql_native_password") as srv:
        db = MySQLDB("127.0.0.1", srv.port, "u", "pw", "")
        assert db.select_value("select 7") == 7
        db.close()


def test_auth_switch_to_sha2():
    with MiniMySQL(user="u", password="pw",
                   auth_plugin="mysql_native_password",
                   switch_to="caching_sha2_password") as srv:
        db = MySQLDB("127.0.0.1", srv.port, "u", "pw", "")
        assert db.select_value("select 7") == 7
        db.close()


def test_unknown_plugin_rejected_with_clear_error():
    with MiniMySQL(user="u", password="pw",
                   auth_plugin="sha256_password") as srv:
        with pytest.raises(MySQLError) as exc:
            MySQLDB("127.0.0.1", srv.port, "u", "pw", "")
        assert exc.value.code == 2059
        assert "sha256_password" in str(exc.value)


def test_sha2_empty_password():
    with MiniMySQL(user="u", password="") as srv:
        db = MySQLDB("127.0.0.1", srv.port, "u", "", "")
        assert db.select_value("select 1") == 1
        db.close()


# -- the two packages on one wire --------------------------------------------

import socket  # noqa: E402
import types  # noqa: E402

from gofr_tpu.datasource import minimysql as jax_minimysql  # noqa: E402
from gofr_tpu.datasource import mysql as jax_mysql  # noqa: E402
from gofr_tpu_torch.datasource import minimysql as torch_minimysql  # noqa: E402
from gofr_tpu_torch.datasource import mysql as torch_mysql  # noqa: E402

_SERVERS = {"jax": jax_minimysql, "torch": torch_minimysql}
_CLIENTS = {"jax": jax_mysql, "torch": torch_mysql}


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
    """One connection's worth of the client's surface: DDL, escaped and
    binary literals, a multi-row insert, resultsets with NULLs, a
    transaction, a server error, a ping and the quit."""
    db = client_mod.MySQLDB("127.0.0.1", port, "gofr", "s3cret", "test")
    out = []
    db.execute("CREATE TABLE w (id INTEGER, name TEXT, score REAL, data BLOB)")
    out.append(db.execute("INSERT INTO w VALUES (?, ?, ?, ?)", 1,
                          "Robert'); DROP TABLE w;-- \" \\ \n über 🎉", 9.5, bytes(range(256))))
    out.append(db.execute_many("INSERT INTO w VALUES (?, ?, ?, ?)",
                               [(2, "Grace", 8.25, b""), (3, None, None, None)]))
    out.append([tuple(r) for r in db.query("SELECT id, name, score, data FROM w ORDER BY id")])
    out.append(db.select_value("SELECT 2+2"))
    with db.begin() as tx:
        tx.execute("UPDATE w SET score = ? WHERE id = ?", 1.5, 2)
    out.append(db.select_value("SELECT score FROM w WHERE id = 2"))
    try:
        db.query("SELEKT broken")
    except Exception as exc:
        out.append((type(exc).__name__, getattr(exc, "code", None)))
    out.append(db.health_check().status)
    db.close()
    return out


@pytest.fixture
def fixed_scramble(monkeypatch):
    """Both servers draw the same nonce: the handshake's bytes (and the
    client's auth token over them) are then a function of the code."""
    fake_os = types.SimpleNamespace(urandom=lambda n: bytes(range(7, 7 + n)))
    for mod in _SERVERS.values():
        monkeypatch.setattr(mod, "os", fake_os)


@pytest.mark.parametrize("auth", ["caching_sha2_password", "mysql_native_password"])
def test_wire_bytes_equal_the_jax_client_and_server(fixed_scramble, auth):
    """Each client against each server, through a recording relay: the
    four transcripts (client to server and back) and the answers equal the
    JAX client's against the JAX server."""
    transcripts = {}
    for server_name, server_mod in _SERVERS.items():
        for client_name, client_mod in _CLIENTS.items():
            with server_mod.MiniMySQL(user="gofr", password="s3cret", auth_plugin=auth) as srv:
                tap = _Tap(srv.port)
                answers = _scripted_session(client_mod, tap.port)
                conns = tap.close()
            assert len(conns) == 1
            transcripts[(client_name, server_name)] = (conns[0], answers)
    ref_wire, ref_answers = transcripts[("jax", "jax")]
    assert ref_answers[3] == 4 and ref_answers[-1] == "UP"
    assert len(ref_wire[0]) > 200 and len(ref_wire[1]) > 500
    for key, (wire, answers) in transcripts.items():
        assert answers == ref_answers, key
        assert wire[0] == ref_wire[0], f"client bytes differ: {key}"
        assert wire[1] == ref_wire[1], f"server bytes differ: {key}"


def test_auth_switch_bytes_equal_jax(fixed_scramble):
    """An AuthSwitchRequest exchange (the server names another plugin):
    the port's client answers it with the JAX client's bytes."""
    wires = []
    for client_mod in (jax_mysql, torch_mysql):
        with jax_minimysql.MiniMySQL(user="gofr", password="s3cret",
                                     switch_to="mysql_native_password") as srv:
            tap = _Tap(srv.port)
            db = client_mod.MySQLDB("127.0.0.1", tap.port, "gofr", "s3cret", "")
            assert db.select_value("select 7") == 7
            db.close()
            wires.append(tap.close())
    assert wires[1] == wires[0]


@pytest.mark.parametrize("client_mod,server_mod", [
    (torch_mysql, jax_minimysql), (jax_mysql, torch_minimysql),
], ids=["torch-client-jax-server", "jax-client-torch-server"])
def test_full_auth_across_packages(client_mod, server_mod):
    """The RSA full-auth exchange (the encrypted password is random-padded,
    so it is held by outcome): each client authenticates against the other
    package's server, and a wrong password is refused with 1045."""
    with server_mod.MiniMySQL(user="u", password="hunter2", full_auth=True) as srv:
        db = client_mod.MySQLDB("127.0.0.1", srv.port, "u", "hunter2", "")
        assert db.select_value("select 41 + 1") == 42
        db.close()
        with pytest.raises(Exception) as exc:
            client_mod.MySQLDB("127.0.0.1", srv.port, "u", "wrong", "")
        assert exc.value.code == 1045


def test_stdlib_rsa_crosses_packages():
    """The stdlib OAEP fallback: a key made by one package decrypts what
    the other encrypts, and the key's PEM reads the same in both."""
    from gofr_tpu.datasource import _rsa as jax_rsa
    from gofr_tpu_torch.datasource import _rsa as torch_rsa

    for maker, user in ((jax_rsa, torch_rsa), (torch_rsa, jax_rsa)):
        key = maker.generate_key(1024)
        pem = maker.public_key_pem(key.n, key.e)
        assert user.load_public_key(pem) == maker.load_public_key(pem) == (key.n, key.e)
        secret = b"nonce-whitened password\x00"
        assert maker._oaep_decrypt(key, user.oaep_encrypt((key.n, key.e), secret)) == secret


def test_helpers_equal_jax():
    """The literal escaping, interpolation and the two scramble tokens
    give the JAX package's bytes."""
    values = [None, True, False, 0, -7, 3.25, "a'b\\c\n\x00\x1a\"", b"\x01\xff", "über"]
    for v in values:
        assert torch_mysql.escape_literal(v) == jax_mysql.escape_literal(v)
    q = "SELECT '?', ?, ? FROM t WHERE a = ?"
    assert torch_mysql.interpolate(q, [1, "x'y", None]) == jax_mysql.interpolate(q, [1, "x'y", None])
    scramble = bytes(range(20))
    for pw in ("", "pw", "s3cret-ü"):
        assert torch_mysql.native_password_token(pw, scramble) == \
            jax_mysql.native_password_token(pw, scramble)
        assert torch_mysql.sha2_password_token(pw, scramble) == \
            jax_mysql.sha2_password_token(pw, scramble)
    for n in (0, 250, 251, 2**16, 2**24, 2**40):
        assert torch_mysql.encode_lenenc_int(n) == jax_mysql.encode_lenenc_int(n)
