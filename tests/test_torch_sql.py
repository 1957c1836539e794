"""The port's SQL datasource (``gofr_tpu_torch/datasource/sql.py``), case
for case with ``tests/test_sql.py``, then beside the JAX package's: the
same statements give the same rows, row counts and query log, and
``new_sql``'s mysql dialect reaches the other package's server."""

import dataclasses
import threading

import pytest

from gofr_tpu_torch.config import EnvFileConfig as EnvConfig
from gofr_tpu_torch.datasource.sql import DB, new_sql, to_snake_case
from gofr_tpu_torch.logging import Level
from gofr_tpu_torch.testutil import MockLogger


@dataclasses.dataclass
class User:
    id: int = 0
    full_name: str = ""
    email: str = dataclasses.field(default="", metadata={"db": "mail"})


@pytest.fixture
def db():
    logger = MockLogger(Level.DEBUG)
    database = DB(":memory:", logger)
    database.execute("CREATE TABLE users (id INTEGER PRIMARY KEY,"
                     " full_name TEXT, mail TEXT, junk TEXT)")
    database.execute_many(
        "INSERT INTO users (id, full_name, mail, junk) VALUES (?, ?, ?, ?)",
        [(1, "Ada Lovelace", "ada@x.io", "z"), (2, "Alan Turing", "alan@x.io", "z")],
    )
    yield database, logger
    database.close()


def test_to_snake_case():
    assert to_snake_case("FullName") == "full_name"
    assert to_snake_case("ID") == "id"
    assert to_snake_case("HTTPPort") == "http_port"
    assert to_snake_case("simple") == "simple"


def test_select_into_dataclass(db):
    database, _ = db
    users = database.select(User, "SELECT * FROM users ORDER BY id")
    assert len(users) == 2
    assert users[0] == User(1, "Ada Lovelace", "ada@x.io")  # db tag mapped mail->email
    assert users[1].full_name == "Alan Turing"  # snake_case mapping


def test_select_one_and_value(db):
    database, _ = db
    user = database.select_one(User, "SELECT * FROM users WHERE id = ?", 2)
    assert user.email == "alan@x.io"
    assert database.select_one(User, "SELECT * FROM users WHERE id = ?", 99) is None
    assert database.select_value("SELECT COUNT(*) FROM users") == 2
    assert database.select_value("SELECT 2+2") == 4


def test_exec_returns_rowcount_and_logs(db):
    database, logger = db
    n = database.execute("UPDATE users SET junk = ? WHERE id > ?", "y", 0)
    assert n == 2
    assert "UPDATE users SET junk" in logger.output
    assert "duration_us" in logger.output


def test_transaction_commit_and_rollback(db):
    database, logger = db
    with database.begin() as tx:
        tx.execute("INSERT INTO users (id, full_name) VALUES (3, 'Grace')")
    assert database.select_value("SELECT COUNT(*) FROM users") == 3

    with pytest.raises(RuntimeError):
        with database.begin() as tx:
            tx.execute("INSERT INTO users (id, full_name) VALUES (4, 'Nope')")
            raise RuntimeError("abort")
    assert database.select_value("SELECT COUNT(*) FROM users") == 3  # rolled back
    assert "ROLLBACK" in logger.output


def test_memory_db_shared_across_threads(db):
    database, _ = db
    results = []

    def read():
        results.append(database.select_value("SELECT COUNT(*) FROM users"))

    t = threading.Thread(target=read)
    t.start()
    t.join()
    assert results == [2]


def test_select_requires_dataclass(db):
    database, _ = db
    with pytest.raises(TypeError):
        database.select(dict, "SELECT * FROM users")


def test_health_check(db):
    database, _ = db
    h = database.health_check()
    assert h.status == "UP"
    assert "latency_us" in h.details


def test_new_sql_dialect_gating(monkeypatch, tmp_path):
    monkeypatch.setenv("DB_DIALECT", "sqlite")
    monkeypatch.setenv("DB_NAME", str(tmp_path / "t.db"))
    database = new_sql(EnvConfig(), MockLogger())
    database.execute("CREATE TABLE t (x INTEGER)")
    database.close()

    # mysql dialect routes to the wire-protocol client (tests/test_mysql.py
    # covers it against minimysql); a dead port surfaces as a connect error
    monkeypatch.setenv("DB_DIALECT", "mysql")
    monkeypatch.setenv("DB_HOST", "127.0.0.1")
    monkeypatch.setenv("DB_PORT", "1")
    with pytest.raises(OSError):
        new_sql(EnvConfig(), MockLogger())

    monkeypatch.setenv("DB_DIALECT", "cockroach")
    with pytest.raises(RuntimeError, match="unsupported"):
        new_sql(EnvConfig(), MockLogger())


# -- the two packages side by side --------------------------------------------

import json  # noqa: E402

from gofr_tpu.datasource import sql as jax_sql  # noqa: E402
from gofr_tpu.testutil import MockLogger as JaxMockLogger  # noqa: E402
from gofr_tpu_torch.datasource import sql as torch_sql  # noqa: E402


def _session(sql_mod, logger):
    database = sql_mod.DB(":memory:", logger)
    out = [
        database.execute("CREATE TABLE users (id INTEGER PRIMARY KEY,"
                         " full_name TEXT, mail TEXT, junk TEXT)"),
        database.execute_many(
            "INSERT INTO users (id, full_name, mail, junk) VALUES (?, ?, ?, ?)",
            [(1, "Ada Lovelace", "ada@x.io", "z"), (2, "Alan Turing", "alan@x.io", None)],
        ),
        [tuple(r) for r in database.query("SELECT * FROM users ORDER BY id")],
        tuple(database.query_row("SELECT full_name, mail FROM users WHERE id = ?", 2)),
        database.select(User, "SELECT * FROM users ORDER BY id"),
        database.select_value("SELECT 2+2"),
        database.execute("UPDATE users SET junk = ? WHERE id > ?", "y", 0),
    ]
    with database.begin() as tx:
        tx.execute("INSERT INTO users (id, full_name) VALUES (3, 'Grace')")
    try:
        with database.begin() as tx:
            tx.execute("INSERT INTO users (id, full_name) VALUES (4, 'Nope')")
            raise RuntimeError("abort")
    except RuntimeError:
        pass
    out.append(database.select_value("SELECT COUNT(*) FROM users"))
    out.append(database.health_check().status)
    database.close()
    return out


def test_statements_and_query_log_equal_jax():
    """The same statements through both packages' sqlite DB: equal rows,
    row counts and bound dataclasses, and the same query log entries (the
    datasource, the query; not the durations)."""
    loggers = (JaxMockLogger(Level.DEBUG), MockLogger(Level.DEBUG))
    jax_out, torch_out = (_session(mod, log) for mod, log in zip((jax_sql, torch_sql), loggers))
    assert torch_out[:4] == jax_out[:4]
    assert [dataclasses.asdict(u) for u in torch_out[4]] == [dataclasses.asdict(u) for u in jax_out[4]]
    assert torch_out[5:] == jax_out[5:] and torch_out[-2] == 3

    def entries(logger):
        out = []
        for line in logger.lines:
            message = json.loads(line)["message"]
            if isinstance(message, dict):
                message.pop("duration_us", None)
            out.append((json.loads(line)["level"], message))
        return out

    assert entries(loggers[1]) == entries(loggers[0])
    assert any("ROLLBACK" in str(m) for _, m in entries(loggers[1]))


def test_sql_log_and_snake_case_equal_jax():
    from gofr_tpu_torch.datasource.sql import SQLLog

    for name in ("FullName", "ID", "HTTPPort", "simple", "userID2Name", "A"):
        assert to_snake_case(name) == jax_sql.to_snake_case(name)
    ours, theirs = SQLLog("SELECT 1", 42), jax_sql.SQLLog("SELECT 1", 42)
    assert ours.log_fields() == theirs.log_fields()
    assert ours.pretty_terminal() == theirs.pretty_terminal()


@pytest.mark.parametrize("direction", ["torch-client-jax-server", "jax-client-torch-server"])
def test_new_sql_mysql_dialect_across_packages(direction, monkeypatch):
    """``DB_DIALECT=mysql`` through ``new_sql``: the port's config reaches
    the JAX package's MiniMySQL, and the JAX package's reaches the
    port's."""
    from gofr_tpu.config import EnvConfig as JaxEnvConfig
    from gofr_tpu.datasource.minimysql import MiniMySQL as JaxMiniMySQL
    from gofr_tpu_torch.datasource.minimysql import MiniMySQL

    if direction.startswith("torch"):
        server, make = JaxMiniMySQL, lambda: new_sql(EnvConfig(), MockLogger())
    else:
        server, make = MiniMySQL, lambda: jax_sql.new_sql(JaxEnvConfig(), JaxMockLogger())
    with server(user="gofr", password="pw") as srv:
        for key, value in (("DB_DIALECT", "mysql"), ("DB_HOST", "127.0.0.1"),
                           ("DB_PORT", str(srv.port)), ("DB_USER", "gofr"),
                           ("DB_PASSWORD", "pw"), ("DB_NAME", "test")):
            monkeypatch.setenv(key, value)
        database = make()
        assert database.select_value("SELECT 2+2") == 4
        assert database.health_check().status == "UP"
        database.close()
