"""SQL datasource: a DB-API pool wrapper with query logging, transactions,
reflection row binding, and health checks (copy of
``gofr_tpu/datasource/sql.py``).

Parity: GoFr's pkg/gofr/datasource/sql/ —
- sql.go:10-38: DBConfig from env keys, DSN build, connect + ping;
- db.go:15-117: logged Query/QueryRow/Exec and the Tx wrapper;
- db.go:148-243: reflection ``Select`` into a slice/struct using ``db:``
  tags or snake_case field names, unmatched columns discarded;
- db.go:248: ToSnakeCase; health.go:10-29: 1s ping + pool stats.

The built-in driver is stdlib sqlite3 (the environment ships no MySQL
driver); ``DB_DIALECT=mysql`` is gated behind driver availability with the
same degraded-startup behavior the container applies to all datasources.
Connections are per-thread (sqlite3 objects are not thread-safe), so the
pool plays the role of database/sql's internal pool.
"""

from __future__ import annotations

import dataclasses
import re
import sqlite3
import threading
import time
from dataclasses import dataclass
from typing import Any, Iterator, Optional, Sequence

from gofr_tpu_torch.datasource.health import DOWN, UP, Health
from gofr_tpu_torch.tracing import get_tracer


@dataclass
class SQLLog:
    """Typed query log (parity: sql/db.go:27-34)."""

    query: str
    duration_us: int

    def pretty_terminal(self) -> str:
        return f"\x1b[36mSQL\x1b[0m [{self.query}] {self.duration_us}µs"

    def log_fields(self) -> dict[str, Any]:
        return {"datasource": "sql", "query": self.query, "duration_us": self.duration_us}


def to_snake_case(name: str) -> str:
    """Parity: sql/db.go:248-253."""
    s1 = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub(r"([a-z0-9])([A-Z])", r"\1_\2", s1).lower()


class DB:
    """Logged DB wrapper (parity: sql/db.go:15)."""

    _mem_counter = 0
    _mem_lock = threading.Lock()

    def __init__(self, path: str, logger: Any = None):
        self.path = path
        if path == ":memory:":
            # per-thread connections must still see ONE database; a plain
            # :memory: is private per connection, so use a shared-cache URI
            with DB._mem_lock:
                DB._mem_counter += 1
                self._uri = f"file:gofr_mem_{id(self)}_{DB._mem_counter}?mode=memory&cache=shared"
        else:
            self._uri = f"file:{path}"
        self.logger = logger
        self._local = threading.local()
        self._conns: list[sqlite3.Connection] = []
        self._conns_lock = threading.Lock()
        # connect + ping eagerly so the container can log-and-degrade; this
        # anchor connection also keeps a shared in-memory db alive
        self._conn().execute("SELECT 1")

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self._uri, timeout=5.0, uri=True)
            conn.row_factory = sqlite3.Row
            conn.isolation_level = None  # autocommit; explicit BEGIN for tx
            self._local.conn = conn
            with self._conns_lock:
                self._conns.append(conn)
        return conn

    # -- logged primitives (parity: db.go:36-59) -----------------------------
    def _timed(self, query: str, fn):
        start = time.perf_counter()
        span = get_tracer().start_span("sql-query", activate=False)
        span.set_tag("db.system", "sqlite")
        span.set_tag("db.statement", query[:256])
        try:
            return fn()
        finally:
            span.end()
            if self.logger is not None:
                elapsed_us = int((time.perf_counter() - start) * 1e6)
                self.logger.debug(SQLLog(query=query[:256], duration_us=elapsed_us))

    def query(self, query: str, *args: Any) -> list[sqlite3.Row]:
        return self._timed(query, lambda: self._conn().execute(query, args).fetchall())

    def query_row(self, query: str, *args: Any) -> Optional[sqlite3.Row]:
        return self._timed(query, lambda: self._conn().execute(query, args).fetchone())

    def execute(self, query: str, *args: Any) -> int:
        """Returns affected-row count (parity: Exec, db.go:52)."""

        def run() -> int:
            cur = self._conn().execute(query, args)
            return cur.rowcount if cur.rowcount >= 0 else 0

        return self._timed(query, run)

    def execute_many(self, query: str, rows: Sequence[Sequence[Any]]) -> int:
        def run() -> int:
            cur = self._conn().executemany(query, rows)
            return cur.rowcount if cur.rowcount >= 0 else 0

        return self._timed(f"{query} [batch x{len(rows)}]", run)

    # -- transactions (parity: db.go:70-117) ---------------------------------
    class _Tx:
        def __init__(self, db: "DB"):
            self.db = db

        def __enter__(self) -> "DB._Tx":
            self.db._timed("BEGIN", lambda: self.db._conn().execute("BEGIN"))
            return self

        def query(self, query: str, *args: Any) -> list[sqlite3.Row]:
            return self.db.query(query, *args)

        def execute(self, query: str, *args: Any) -> int:
            return self.db.execute(query, *args)

        def __exit__(self, exc_type, exc, tb) -> None:
            if exc_type is None:
                self.db._timed("COMMIT", lambda: self.db._conn().execute("COMMIT"))
            else:
                self.db._timed("ROLLBACK", lambda: self.db._conn().execute("ROLLBACK"))

    def begin(self) -> "DB._Tx":
        return DB._Tx(self)

    # -- reflection select (parity: db.go:148-243) ---------------------------
    def select(self, into: type, query: str, *args: Any) -> Any:
        """``into`` is a dataclass type -> list of instances; column->field
        mapping uses ``field(metadata={"db": "col"})`` or snake_case of the
        field name; unmatched columns are discarded (db.go:202-243)."""
        rows = self.query(query, *args)
        if not dataclasses.is_dataclass(into):
            raise TypeError(f"select target must be a dataclass, got {into!r}")
        field_by_column: dict[str, str] = {}
        for f in dataclasses.fields(into):
            column = f.metadata.get("db", to_snake_case(f.name))
            field_by_column[column] = f.name
        out = []
        for row in rows:
            kwargs = {}
            for column in row.keys():
                field_name = field_by_column.get(column)
                if field_name is not None:
                    kwargs[field_name] = row[column]
            out.append(into(**kwargs))
        return out

    def select_one(self, into: type, query: str, *args: Any) -> Optional[Any]:
        result = self.select(into, query, *args)
        return result[0] if result else None

    def select_value(self, query: str, *args: Any) -> Any:
        row = self.query_row(query, *args)
        return None if row is None else row[0]

    # -- health (parity: sql/health.go:10-29) --------------------------------
    def health_check(self) -> Health:
        try:
            start = time.perf_counter()
            self._conn().execute("SELECT 1").fetchone()
            latency_us = int((time.perf_counter() - start) * 1e6)
            return Health(UP, {"database": self.path, "latency_us": latency_us,
                               "open_connections": len(self._conns)})
        except Exception as exc:
            return Health(DOWN, {"database": self.path, "error": str(exc)})

    def close(self) -> None:
        with self._conns_lock:
            for conn in self._conns:
                try:
                    conn.close()
                except Exception:
                    pass
            self._conns.clear()


def new_sql(config: Any, logger: Any = None) -> Any:
    """Config-driven constructor (parity: sql/sql.go:19-38).

    DB_DIALECT=sqlite (default): DB_NAME is the database path (or
    ``:memory:``). DB_DIALECT=mysql: the from-scratch wire-protocol client
    (datasource/mysql.py) over DB_HOST/DB_PORT/DB_USER/DB_PASSWORD/DB_NAME
    — the same env keys the reference DSN uses (sql.go:19-37). Connect
    failures raise; the container logs and degrades."""
    dialect = (config.get_or_default("DB_DIALECT", "sqlite") or "sqlite").lower()
    if dialect == "sqlite":
        name = config.get_or_default("DB_NAME", ":memory:")
        return DB(name, logger)
    if dialect == "mysql":
        from gofr_tpu_torch.datasource.mysql import MySQLDB

        return MySQLDB(
            host=config.get_or_default("DB_HOST", "127.0.0.1"),
            port=int(config.get_or_default("DB_PORT", "3306")),
            user=config.get_or_default("DB_USER", "root"),
            password=config.get_or_default("DB_PASSWORD", ""),
            database=config.get_or_default("DB_NAME", ""),
            logger=logger,
        )
    raise RuntimeError(f"unsupported DB_DIALECT '{dialect}'")


def new_mysql(config: Any, logger: Any = None) -> Any:
    """Parity alias: sql.go:19 NewMYSQL."""
    return new_sql(config, logger)
