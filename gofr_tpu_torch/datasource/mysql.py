"""MySQL client: a from-scratch wire-protocol implementation (copy of
``gofr_tpu/datasource/mysql.py``; its packets are the JAX client's byte
for byte).

Parity: GoFr's pkg/gofr/datasource/sql/sql.go:19-37 — the reference
is a MySQL framework (``NewMYSQL`` builds the DSN and pings). This
environment ships no MySQL driver, so the client speaks the documented
protocol directly: handshake v10, ``caching_sha2_password`` (the MySQL 8
default, incl. the non-TLS RSA full-auth exchange) and
``mysql_native_password`` auth with AuthSwitch between them,
``COM_QUERY`` with text resultsets, ``COM_PING`` health. The surface
mirrors datasource/sql.py's DB (logged query/execute/tx/select) so
``DB_DIALECT=mysql`` swaps in transparently behind the container.

Scope: classic EOF framing (CLIENT_DEPRECATE_EOF not negotiated), text
protocol only — parameters interpolate client-side with proper escaping
(the same approach as go-sql-driver's interpolateParams fast path). One
socket guarded by a mutex; MySQL connections are sequential by protocol.
No TLS: full auth on caching_sha2 always takes the RSA public-key path
(what go-sql-driver does with allowCleartextPasswords off on plain TCP).

Tested against datasource/minimysql.py, an in-process fake speaking the
same wire format (the reference tests MySQL with sqlmock the same way,
SURVEY.md §4) — including a fake demanding caching_sha2 full auth.
"""

from __future__ import annotations

import dataclasses
import hashlib
import socket
import struct
import threading
import time
from typing import Any, Optional, Sequence

from gofr_tpu_torch.datasource.health import DOWN, UP, Health
from gofr_tpu_torch.datasource.sql import SQLLog, to_snake_case
from gofr_tpu_torch.tracing import get_tracer

# capability flags (protocol constants)
CLIENT_LONG_PASSWORD = 0x1
CLIENT_CONNECT_WITH_DB = 0x8
CLIENT_PROTOCOL_41 = 0x200
CLIENT_TRANSACTIONS = 0x2000
CLIENT_SECURE_CONNECTION = 0x8000
CLIENT_PLUGIN_AUTH = 0x80000

COM_QUIT, COM_QUERY, COM_PING = 0x01, 0x03, 0x0E

# column type codes (text protocol conversion)
_INT_TYPES = {0x01, 0x02, 0x03, 0x08, 0x09, 0x0D}  # tiny..longlong, year
_FLOAT_TYPES = {0x04, 0x05, 0xF6}  # float, double, newdecimal
_BLOB_TYPE = 0xFC


class MySQLError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"MySQL error {code}: {message}")
        self.code = code
        self.message = message


def native_password_token(password: str, scramble: bytes) -> bytes:
    """mysql_native_password: SHA1(pass) XOR SHA1(scramble + SHA1(SHA1(pass)))."""
    if not password:
        return b""
    h1 = hashlib.sha1(password.encode()).digest()
    h2 = hashlib.sha1(h1).digest()
    h3 = hashlib.sha1(scramble + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


def sha2_password_token(password: str, scramble: bytes) -> bytes:
    """caching_sha2_password fast-auth scramble:
    SHA256(pass) XOR SHA256(SHA256(SHA256(pass)) + scramble)."""
    if not password:
        return b""
    h1 = hashlib.sha256(password.encode()).digest()
    h2 = hashlib.sha256(hashlib.sha256(h1).digest() + scramble).digest()
    return bytes(a ^ b for a, b in zip(h1, h2))


def xor_rotating(data: bytes, key: bytes) -> bytes:
    """XOR ``data`` with ``key`` repeated — the pre-RSA whitening MySQL
    applies to the password in the caching_sha2 full-auth exchange."""
    return bytes(b ^ key[i % len(key)] for i, b in enumerate(data))


def rsa_encrypt_password(password: str, scramble: bytes, pem: bytes) -> bytes:
    """Non-TLS full auth: RSA-OAEP(SHA1)-encrypt the nonce-whitened
    NUL-terminated password with the server's public key. Prefers the
    audited ``cryptography`` implementation; containers without it
    (the serving image ships no OpenSSL bindings) fall back to the
    stdlib OAEP in ``datasource/_rsa.py`` — same bytes on the wire."""
    plain = xor_rotating(password.encode() + b"\x00", scramble)
    try:
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import padding as _pad
    except ImportError:
        from gofr_tpu_torch.datasource import _rsa

        return _rsa.oaep_encrypt(_rsa.load_public_key(pem), plain)

    key = serialization.load_pem_public_key(pem)
    return key.encrypt(
        plain,
        _pad.OAEP(mgf=_pad.MGF1(hashes.SHA1()), algorithm=hashes.SHA1(), label=None),
    )


def _lenenc_int(data: bytes, pos: int) -> tuple[int, int]:
    first = data[pos]
    if first < 0xFB:
        return first, pos + 1
    if first == 0xFC:
        return struct.unpack_from("<H", data, pos + 1)[0], pos + 3
    if first == 0xFD:
        return int.from_bytes(data[pos + 1 : pos + 4], "little"), pos + 4
    if first == 0xFE:
        return struct.unpack_from("<Q", data, pos + 1)[0], pos + 9
    raise MySQLError(2027, f"malformed length-encoded int 0x{first:02x}")


def _lenenc_str(data: bytes, pos: int) -> tuple[bytes, int]:
    n, pos = _lenenc_int(data, pos)
    return data[pos : pos + n], pos + n


def encode_lenenc_int(n: int) -> bytes:
    if n < 0xFB:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 1 << 24:
        return b"\xfd" + n.to_bytes(3, "little")
    return b"\xfe" + struct.pack("<Q", n)


def encode_lenenc_str(s: bytes) -> bytes:
    return encode_lenenc_int(len(s)) + s


def escape_literal(value: Any) -> str:
    """Client-side parameter interpolation (text protocol has no binds)."""
    if value is None:
        return "NULL"
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, (bytes, bytearray)):
        return "x'" + bytes(value).hex() + "'"
    s = str(value)
    s = (
        s.replace("\\", "\\\\").replace("'", "\\'").replace('"', '\\"')
        .replace("\x00", "\\0").replace("\n", "\\n").replace("\r", "\\r")
        .replace("\x1a", "\\Z")
    )
    return f"'{s}'"


def interpolate(query: str, args: Sequence[Any]) -> str:
    """Replace ``?`` placeholders outside string literals."""
    if not args:
        return query
    out: list[str] = []
    it = iter(args)
    in_str: Optional[str] = None
    i = 0
    while i < len(query):
        ch = query[i]
        if in_str:
            if ch == "\\":
                out.append(query[i : i + 2])
                i += 2
                continue
            if ch == in_str:
                in_str = None
            out.append(ch)
        elif ch in ("'", '"'):
            in_str = ch
            out.append(ch)
        elif ch == "?":
            try:
                out.append(escape_literal(next(it)))
            except StopIteration:
                raise MySQLError(2034, "not enough parameters for query") from None
        else:
            out.append(ch)
        i += 1
    return "".join(out)


class Row:
    """Result row with sqlite3.Row-compatible access: by index, by column
    name, and ``.keys()`` (datasource/sql.py's ``select`` reflection uses
    exactly this surface)."""

    __slots__ = ("_columns", "_values")

    def __init__(self, columns: Sequence[str], values: Sequence[Any]):
        self._columns = columns
        self._values = values

    def keys(self) -> Sequence[str]:
        return list(self._columns)

    def __getitem__(self, key: Any) -> Any:
        if isinstance(key, int):
            return self._values[key]
        try:
            return self._values[self._columns.index(key)]
        except ValueError:
            raise KeyError(key) from None

    def __len__(self) -> int:
        return len(self._values)

    def __iter__(self):
        return iter(self._values)

    def __repr__(self) -> str:
        return f"Row({dict(zip(self._columns, self._values))!r})"


class _Conn:
    """One authenticated connection: packet framing + command round trips."""

    def __init__(self, host: str, port: int, user: str, password: str,
                 database: str, timeout: float = 5.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.settimeout(timeout)
        self._seq = 0
        self._handshake(user, password, database)

    # -- framing -------------------------------------------------------------
    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise MySQLError(2013, "lost connection during query")
            buf += chunk
        return buf

    def read_packet(self) -> bytes:
        payload = b""
        while True:
            header = self._read_exact(4)
            length = int.from_bytes(header[:3], "little")
            self._seq = (header[3] + 1) % 256
            payload += self._read_exact(length)
            if length < 0xFFFFFF:  # 16MB-1 means a continuation follows
                return payload

    def write_packet(self, payload: bytes) -> None:
        header = len(payload).to_bytes(3, "little") + bytes([self._seq])
        self._seq = (self._seq + 1) % 256
        self.sock.sendall(header + payload)

    # -- handshake -----------------------------------------------------------
    @staticmethod
    def _auth_token(plugin: str, password: str, scramble: bytes) -> bytes:
        """Scramble token for the plugin the SERVER named — never assume
        (a default-configured MySQL 8 advertises caching_sha2_password;
        older servers and explicit accounts use mysql_native_password)."""
        if plugin == "mysql_native_password":
            return native_password_token(password, scramble)
        if plugin == "caching_sha2_password":
            return sha2_password_token(password, scramble)
        raise MySQLError(2059, f"authentication plugin '{plugin}' not supported")

    def _handshake(self, user: str, password: str, database: str) -> None:
        greeting = self.read_packet()
        if greeting and greeting[0] == 0xFF:
            raise self._err(greeting)
        if not greeting or greeting[0] != 0x0A:
            raise MySQLError(2012, f"unsupported handshake version {greeting[:1]!r}")
        pos = 1
        end = greeting.index(b"\x00", pos)
        self.server_version = greeting[pos:end].decode("utf-8", "replace")
        pos = end + 1
        pos += 4  # thread id
        scramble = greeting[pos : pos + 8]
        pos += 8 + 1  # + filler
        pos += 2 + 1 + 2 + 2  # caps_lo, charset, status, caps_hi
        auth_len = greeting[pos] if pos < len(greeting) else 0
        pos += 1 + 10  # + reserved
        if auth_len > 8 and pos < len(greeting):
            # part 2 occupies max(13, auth_len-8) bytes, of which the first
            # 12 extend the nonce (the 13th is a NUL)
            part2_len = max(13, auth_len - 8)
            scramble += greeting[pos : pos + 12]
            pos += part2_len
        plugin = "mysql_native_password"
        if pos < len(greeting):
            nul = greeting.find(b"\x00", pos)
            name = greeting[pos : nul if nul >= 0 else len(greeting)]
            if name:
                plugin = name.decode("utf-8", "replace")

        caps = (
            CLIENT_LONG_PASSWORD | CLIENT_PROTOCOL_41 | CLIENT_TRANSACTIONS
            | CLIENT_SECURE_CONNECTION | CLIENT_PLUGIN_AUTH
        )
        if database:
            caps |= CLIENT_CONNECT_WITH_DB
        token = self._auth_token(plugin, password, scramble)
        payload = (
            struct.pack("<IIB23x", caps, 1 << 24, 45)  # caps, max packet, utf8mb4
            + user.encode() + b"\x00"
            + bytes([len(token)]) + token
            + ((database.encode() + b"\x00") if database else b"")
            + plugin.encode() + b"\x00"
        )
        self.write_packet(payload)
        self._auth_loop(password, scramble, plugin)

    def _auth_loop(self, password: str, scramble: bytes, plugin: str) -> None:
        """Drive auth to OK: AuthSwitchRequest (re-scramble under the
        plugin the server NAMES), caching_sha2 AuthMoreData (0x03 fast-auth
        hit; 0x04 full auth via the RSA public-key exchange)."""
        while True:
            reply = self.read_packet()
            if not reply:
                raise MySQLError(2013, "connection closed during auth")
            if reply[0] == 0x00:
                return
            if reply[0] == 0xFF:
                raise self._err(reply)
            if reply[0] == 0xFE:  # AuthSwitchRequest
                end = reply.index(b"\x00", 1)
                plugin = reply[1:end].decode("utf-8", "replace")
                scramble = reply[end + 1 :]
                # exactly ONE trailing NUL terminates the scramble — rstrip
                # would also eat random scramble bytes that happen to be 0x00
                if scramble.endswith(b"\x00"):
                    scramble = scramble[:-1]
                self.write_packet(self._auth_token(plugin, password, scramble))
                continue
            if reply[0] == 0x01 and plugin == "caching_sha2_password":
                status = reply[1:2]
                if status == b"\x03":  # fast_auth_success; OK follows
                    continue
                if status == b"\x04":  # perform_full_authentication
                    # no TLS on this socket: ask for the server RSA key and
                    # send the nonce-whitened password encrypted under it
                    self.write_packet(b"\x02")
                    key_pkt = self.read_packet()
                    if not key_pkt or key_pkt[0] != 0x01:
                        raise MySQLError(
                            2012,
                            f"expected RSA key, got 0x{key_pkt[:1].hex()}",
                        )
                    self.write_packet(
                        rsa_encrypt_password(password, scramble, key_pkt[1:])
                    )
                    continue
                raise MySQLError(2012, f"unexpected auth state 0x{status.hex()}")
            raise MySQLError(2012, f"unexpected auth reply 0x{reply[:1].hex()}")

    @staticmethod
    def _err(payload: bytes) -> MySQLError:
        code = struct.unpack_from("<H", payload, 1)[0]
        msg = payload[3:]
        if msg[:1] == b"#":  # sql state marker + 5 chars
            msg = msg[6:]
        return MySQLError(code, msg.decode("utf-8", "replace"))

    # -- commands ------------------------------------------------------------
    def query(self, sql: str) -> tuple[list[str], list[Row], int]:
        """Returns (columns, rows, affected). OK responses (DML/DDL) give
        ([], [], affected_rows)."""
        self._seq = 0
        self.write_packet(bytes([COM_QUERY]) + sql.encode("utf-8"))
        first = self.read_packet()
        if first and first[0] == 0xFF:
            raise self._err(first)
        if first and first[0] == 0x00:  # OK packet
            affected, _ = _lenenc_int(first, 1)
            return [], [], affected
        n_cols, _ = _lenenc_int(first, 0)
        columns: list[str] = []
        types: list[tuple[int, int]] = []  # (type, charset)
        for _ in range(n_cols):
            col = self.read_packet()
            pos = 0
            for _ in range(4):  # catalog, schema, table, org_table
                _, pos = _lenenc_str(col, pos)
            name, pos = _lenenc_str(col, pos)
            _, pos = _lenenc_str(col, pos)  # org_name
            pos += 1  # fixed-length-fields marker (0x0c)
            charset = struct.unpack_from("<H", col, pos)[0]
            pos += 2 + 4  # charset, column length
            types.append((col[pos], charset))
            columns.append(name.decode("utf-8", "replace"))
        eof = self.read_packet()
        if eof and eof[0] == 0xFF:
            raise self._err(eof)
        rows: list[Row] = []
        while True:
            pkt = self.read_packet()
            if pkt and pkt[0] == 0xFF:
                raise self._err(pkt)
            if pkt and pkt[0] == 0xFE and len(pkt) < 9:  # EOF
                break
            values: list[Any] = []
            pos = 0
            for t, charset in types:
                if pkt[pos] == 0xFB:  # NULL
                    values.append(None)
                    pos += 1
                    continue
                raw, pos = _lenenc_str(pkt, pos)
                if t in _INT_TYPES:
                    values.append(int(raw))
                elif t in _FLOAT_TYPES:
                    values.append(float(raw))
                elif t == _BLOB_TYPE and charset == 63:
                    # charset 63 = binary: BLOB; TEXT shares the wire type
                    # but carries a real charset and decodes to str
                    values.append(raw)
                else:
                    values.append(raw.decode("utf-8", "replace"))
            rows.append(Row(columns, values))
        return columns, rows, 0

    def ping(self) -> bool:
        self._seq = 0
        self.write_packet(bytes([COM_PING]))
        reply = self.read_packet()
        if reply and reply[0] == 0xFF:
            raise self._err(reply)
        return bool(reply) and reply[0] == 0x00

    def close(self) -> None:
        try:
            self._seq = 0
            self.write_packet(bytes([COM_QUIT]))
        except Exception:
            pass
        try:
            self.sock.close()
        except Exception:
            pass


class MySQLDB:
    """Logged MySQL wrapper with the datasource/sql.py DB surface (query /
    query_row / execute / execute_many / begin / select / select_one /
    select_value / health_check / close). Parity: sql/db.go:15-253.

    Connections are per-thread (exactly like the sqlite DB): MySQL wire
    sessions are sequential and transactions are connection-scoped, so a
    shared socket would interleave one handler thread's BEGIN with
    another's statements. A connection that hits an I/O or protocol error
    is discarded (the wire may hold a half-read resultset — desynced
    forever); the thread reconnects on its next call."""

    def __init__(self, host: str, port: int, user: str, password: str,
                 database: str, logger: Any = None):
        self.host, self.port, self.database = host, port, database
        self._user, self._password = user, password
        self.logger = logger
        self._local = threading.local()
        self._all: list[_Conn] = []
        self._all_lock = threading.Lock()
        self.server_version = ""
        self._get_conn()  # connect + auth eagerly: container logs-and-degrades

    def _get_conn(self) -> _Conn:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = _Conn(self.host, self.port, self._user, self._password,
                         self.database)
            self.server_version = conn.server_version
            self._local.conn = conn
            with self._all_lock:
                self._all.append(conn)
        return conn

    def _drop_conn(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            self._local.conn = None
            with self._all_lock:
                if conn in self._all:
                    self._all.remove(conn)
            conn.close()

    def _timed(self, query: str, fn):
        start = time.perf_counter()
        span = get_tracer().start_span("sql-query", activate=False)
        span.set_tag("db.system", "mysql")
        span.set_tag("db.statement", query[:256])
        try:
            return fn()
        finally:
            span.end()
            if self.logger is not None:
                elapsed_us = int((time.perf_counter() - start) * 1e6)
                self.logger.debug(SQLLog(query=query[:256], duration_us=elapsed_us))

    def _run(self, query: str, args: Sequence[Any]) -> tuple[list[str], list[Row], int]:
        sql = interpolate(query, args)
        try:
            return self._get_conn().query(sql)
        except MySQLError as exc:
            # ONLY 2000-2999 are client-side CR_* codes (desynced wire);
            # 3000+ are server errors on a healthy connection — tearing it
            # down would break the thread's open transaction
            if 2000 <= exc.code < 3000:
                self._drop_conn()
            raise
        except OSError:
            self._drop_conn()
            raise

    # -- DB surface ----------------------------------------------------------
    def query(self, query: str, *args: Any) -> list[Row]:
        return self._timed(query, lambda: self._run(query, args)[1])

    def query_row(self, query: str, *args: Any) -> Optional[Row]:
        rows = self.query(query, *args)
        return rows[0] if rows else None

    def execute(self, query: str, *args: Any) -> int:
        return self._timed(query, lambda: self._run(query, args)[2])

    def execute_many(self, query: str, rows: Sequence[Sequence[Any]]) -> int:
        def run() -> int:
            return sum(self._run(query, r)[2] for r in rows)

        return self._timed(f"{query} [batch x{len(rows)}]", run)

    class _Tx:
        def __init__(self, db: "MySQLDB"):
            self.db = db

        def __enter__(self) -> "MySQLDB._Tx":
            self.db.execute("BEGIN")
            return self

        def query(self, query: str, *args: Any) -> list[Row]:
            return self.db.query(query, *args)

        def execute(self, query: str, *args: Any) -> int:
            return self.db.execute(query, *args)

        def __exit__(self, exc_type, exc, tb) -> None:
            self.db.execute("COMMIT" if exc_type is None else "ROLLBACK")

    def begin(self) -> "MySQLDB._Tx":
        return MySQLDB._Tx(self)

    def select(self, into: type, query: str, *args: Any) -> Any:
        rows = self.query(query, *args)
        if not dataclasses.is_dataclass(into):
            raise TypeError(f"select target must be a dataclass, got {into!r}")
        field_by_column = {
            f.metadata.get("db", to_snake_case(f.name)): f.name
            for f in dataclasses.fields(into)
        }
        out = []
        for row in rows:
            kwargs = {}
            for column in row.keys():
                field = field_by_column.get(column)
                if field is not None:
                    kwargs[field] = row[column]
            out.append(into(**kwargs))
        return out

    def select_one(self, into: type, query: str, *args: Any) -> Optional[Any]:
        result = self.select(into, query, *args)
        return result[0] if result else None

    def select_value(self, query: str, *args: Any) -> Any:
        row = self.query_row(query, *args)
        return None if row is None else row[0]

    def health_check(self) -> Health:
        try:
            start = time.perf_counter()
            try:
                self._get_conn().ping()
            except (OSError, MySQLError):
                self._drop_conn()
                raise
            latency_us = int((time.perf_counter() - start) * 1e6)
            return Health(UP, {
                "host": f"{self.host}:{self.port}", "database": self.database,
                "dialect": "mysql", "latency_us": latency_us,
                "server_version": self.server_version,
            })
        except Exception as exc:
            return Health(DOWN, {
                "host": f"{self.host}:{self.port}", "database": self.database,
                "dialect": "mysql", "error": str(exc),
            })

    def close(self) -> None:
        with self._all_lock:
            for conn in self._all:
                conn.close()
            self._all.clear()
