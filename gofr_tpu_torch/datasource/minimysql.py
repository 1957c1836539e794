"""In-process fake MySQL server for tests — the sqlmock/miniredis analogue
(copy of ``gofr_tpu/datasource/minimysql.py``).

Parity rationale: the reference unit-tests its MySQL layer against
go-sqlmock (SURVEY.md §4) without a real server. This fake goes one step
further: it speaks the REAL wire protocol (handshake v10, auth plugin
verification, COM_QUERY text resultsets, COM_PING) over a localhost
socket, executing statements against an in-memory sqlite — so
datasource/mysql.py's client is tested through its actual socket path,
framing, auth and resultset decoding included.

Auth mirrors a default-configured MySQL 8 (the reference CI image,
mysql:8.2.0): ``caching_sha2_password`` advertised by default, with the
fast-auth scramble verified; ``full_auth=True`` demands the non-TLS RSA
public-key exchange instead (what a real server does on a cache miss);
``auth_plugin="mysql_native_password"`` reproduces legacy servers; and
``switch_to=`` sends an AuthSwitchRequest so the client's plugin-name
check is exercised.
"""

from __future__ import annotations

import os
import socket
import sqlite3
import struct
import threading
from typing import Optional

from gofr_tpu_torch.datasource.mysql import (
    COM_PING,
    COM_QUERY,
    COM_QUIT,
    encode_lenenc_int,
    encode_lenenc_str,
    native_password_token,
    sha2_password_token,
    xor_rotating,
)

_TYPE_LONGLONG, _TYPE_DOUBLE, _TYPE_VARSTR, _TYPE_BLOB = 0x08, 0x05, 0xFD, 0xFC

_BACKSLASH_MAP = {
    "n": "\n", "r": "\r", "t": "\t", "0": "\x00", "Z": "\x1a",
    "\\": "\\", "'": "'", '"': '"', "b": "\b", "%": "\\%", "_": "\\_",
}


def _mysql_to_sqlite(sql: str) -> str:
    """Rewrite MySQL string-literal syntax into sqlite's: backslash escapes
    (MySQL default) become literal characters, quotes double. The client
    escapes for REAL MySQL; the fake must accept exactly that dialect."""
    out: list[str] = []
    i, n = 0, len(sql)
    while i < n:
        ch = sql[i]
        if ch in ("'", '"'):
            quote = ch
            i += 1
            body: list[str] = []
            while i < n:
                c = sql[i]
                if c == "\\" and i + 1 < n:
                    body.append(_BACKSLASH_MAP.get(sql[i + 1], sql[i + 1]))
                    i += 2
                    continue
                if c == quote:
                    if i + 1 < n and sql[i + 1] == quote:  # doubled quote
                        body.append(quote)
                        i += 2
                        continue
                    i += 1
                    break
                body.append(c)
                i += 1
            literal = "".join(body).replace("'", "''")
            out.append(f"'{literal}'")
            continue
        out.append(ch)
        i += 1
    return "".join(out)


class MiniMySQL:
    """``with MiniMySQL(user="u", password="p") as srv: ...`` — serves one
    wire-protocol MySQL on ``srv.port`` backed by a shared in-memory
    sqlite."""

    def __init__(self, user: str = "root", password: str = "", port: int = 0,
                 auth_plugin: str = "caching_sha2_password",
                 full_auth: bool = False, switch_to: str = ""):
        self.user, self.password = user, password
        self.auth_plugin = auth_plugin
        self.full_auth = full_auth
        self.switch_to = switch_to
        self._rsa_key = None  # generated on first full-auth exchange
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", port))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        self._uri = f"file:minimysql_{id(self)}?mode=memory&cache=shared"
        self._anchor = sqlite3.connect(self._uri, uri=True)  # keeps db alive
        # statement serialization: shared-cache sqlite raises
        # SQLITE_LOCKED on concurrent writers where a real MySQL blocks
        # on row locks — the fake must present MySQL's serializing
        # behavior, not sqlite's. Held around execute+fetch only; the
        # socket writes stay outside (GFL004).
        self._db_lock = threading.Lock()
        self._closed = False
        self._threads: list[threading.Thread] = []
        self._accept_thread = threading.Thread(
            target=self._accept, daemon=True, name="gofr-minimysql-accept"
        )
        self._accept_thread.start()

    # -- lifecycle -----------------------------------------------------------
    def __enter__(self) -> "MiniMySQL":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
        for t in self._threads:
            t.join(timeout=2)
        self._anchor.close()

    # -- accept loop ---------------------------------------------------------
    def _accept(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(
                target=self._serve, args=(conn,), daemon=True,
                name="gofr-minimysql-conn",
            )
            t.start()
            self._threads.append(t)

    # -- packet helpers ------------------------------------------------------
    @staticmethod
    def _read_exact(conn: socket.socket, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    @classmethod
    def _read_packet(cls, conn: socket.socket) -> Optional[tuple[int, bytes]]:
        header = cls._read_exact(conn, 4)
        if header is None:
            return None
        length = int.from_bytes(header[:3], "little")
        payload = cls._read_exact(conn, length)
        if payload is None:
            return None
        return header[3], payload

    @staticmethod
    def _send(conn: socket.socket, seq: int, payload: bytes) -> int:
        conn.sendall(len(payload).to_bytes(3, "little") + bytes([seq]) + payload)
        return seq + 1

    @staticmethod
    def _ok(affected: int = 0) -> bytes:
        return (b"\x00" + encode_lenenc_int(affected) + encode_lenenc_int(0)
                + struct.pack("<HH", 0x0002, 0))  # autocommit status

    @staticmethod
    def _err(code: int, message: str) -> bytes:
        return (b"\xff" + struct.pack("<H", code) + b"#HY000"
                + message.encode("utf-8"))

    @staticmethod
    def _eof() -> bytes:
        return b"\xfe" + struct.pack("<HH", 0, 0x0002)

    # -- connection ----------------------------------------------------------
    def _serve(self, conn: socket.socket) -> None:
        db = sqlite3.connect(self._uri, uri=True)
        db.isolation_level = None
        try:
            scramble = os.urandom(20)
            greeting = (
                b"\x0a" + b"8.0.0-minimysql\x00"
                + struct.pack("<I", 1)  # thread id
                + scramble[:8] + b"\x00"
                + struct.pack("<H", 0xFFFF)  # caps low
                + b"\x2d"  # charset utf8mb4
                + struct.pack("<H", 0x0002)  # status
                + struct.pack("<H", 0x000F)  # caps high (incl PLUGIN_AUTH)
                + bytes([21])  # auth data len (8 + 12 + NUL)
                + b"\x00" * 10
                + scramble[8:] + b"\x00"
                + self.auth_plugin.encode() + b"\x00"
            )
            self._send(conn, 0, greeting)
            pkt = self._read_packet(conn)
            if pkt is None:
                return
            seq, payload = pkt[0] + 1, pkt[1]
            user, token = self._parse_handshake_response(payload)
            plugin = self.auth_plugin
            if self.switch_to:
                # real servers switch when the account's plugin differs
                # from the advertised default — exercises the client's
                # check of the plugin NAME in AuthSwitchRequest
                plugin = self.switch_to
                scramble = os.urandom(20)
                seq = self._send(
                    conn, seq,
                    b"\xfe" + plugin.encode() + b"\x00" + scramble + b"\x00",
                )
                pkt = self._read_packet(conn)
                if pkt is None:
                    return
                seq, token = pkt[0] + 1, pkt[1]
            ok, seq = self._verify_auth(conn, seq, user, token, plugin, scramble)
            if not ok:
                self._send(conn, seq, self._err(1045, f"Access denied for user '{self.user}'"))
                return
            self._send(conn, seq, self._ok())
            self._command_loop(conn, db)
        except OSError:
            pass
        finally:
            db.close()
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _parse_handshake_response(payload: bytes) -> tuple[str, bytes]:
        # HandshakeResponse41: caps(4) maxpacket(4) charset(1) filler(23)
        pos = 4 + 4 + 1 + 23
        end = payload.index(b"\x00", pos)
        user = payload[pos:end].decode("utf-8", "replace")
        pos = end + 1
        token_len = payload[pos]
        token = payload[pos + 1 : pos + 1 + token_len]
        return user, token

    def _verify_auth(
        self, conn: socket.socket, seq: int, user: str, token: bytes,
        plugin: str, scramble: bytes,
    ) -> tuple[bool, int]:
        """Verify ``token`` under ``plugin``; drives the caching_sha2
        AuthMoreData sub-protocol (0x03 fast-auth hit, or the full RSA
        exchange when ``full_auth``). Returns (ok, next_seq)."""
        if user != self.user:
            return False, seq
        if not self.password:
            return token == b"", seq
        if plugin == "mysql_native_password":
            return token == native_password_token(self.password, scramble), seq
        if plugin != "caching_sha2_password":
            return False, seq
        if not self.full_auth:
            if token != sha2_password_token(self.password, scramble):
                return False, seq
            # cache hit: fast_auth_success, then the caller's OK
            return True, self._send(conn, seq, b"\x01\x03")
        # cache miss: demand the non-TLS RSA public-key exchange (ignores
        # the scramble token, exactly like a real server on a cold cache).
        # Stdlib RSA (datasource/_rsa.py): the fake must run in containers
        # without the `cryptography` package, and the CLIENT under test
        # exercises its own preferred implementation either way.
        from gofr_tpu_torch.datasource import _rsa

        if self._rsa_key is None:
            self._rsa_key = _rsa.generate_key(1024)
        seq = self._send(conn, seq, b"\x01\x04")  # perform_full_authentication
        pkt = self._read_packet(conn)
        if pkt is None or pkt[1] != b"\x02":  # client asks for the RSA key
            return False, seq if pkt is None else pkt[0] + 1
        pem = self._rsa_key.public_pem()
        seq = self._send(conn, pkt[0] + 1, b"\x01" + pem)
        pkt = self._read_packet(conn)
        if pkt is None:
            return False, seq
        seq = pkt[0] + 1
        try:
            plain = self._rsa_key.decrypt_oaep_sha1(pkt[1])
        except Exception:
            return False, seq
        return xor_rotating(plain, scramble) == self.password.encode() + b"\x00", seq

    # -- commands ------------------------------------------------------------
    def _command_loop(self, conn: socket.socket, db: sqlite3.Connection) -> None:
        while True:
            pkt = self._read_packet(conn)
            if pkt is None:
                return
            _, payload = pkt
            seq = 1  # responses to a command restart at seq 1
            if not payload or payload[0] == COM_QUIT:
                return
            if payload[0] == COM_PING:
                self._send(conn, seq, self._ok())
                continue
            if payload[0] != COM_QUERY:
                self._send(conn, seq, self._err(1047, f"unknown command 0x{payload[0]:02x}"))
                continue
            sql = _mysql_to_sqlite(payload[1:].decode("utf-8", "replace"))
            try:
                with self._db_lock:
                    cur = db.execute(sql)
                    rows = cur.fetchall()
                    columns = [d[0] for d in cur.description] if cur.description else []
                    affected = cur.rowcount if cur.rowcount >= 0 else 0
            except sqlite3.Error as exc:
                self._send(conn, seq, self._err(1064, str(exc)))
                continue
            if not columns:  # DML/DDL -> OK with affected rows
                self._send(conn, seq, self._ok(affected))
                continue
            seq = self._send(conn, seq, encode_lenenc_int(len(columns)))
            for i, name in enumerate(columns):
                col_type = self._column_type(rows, i)
                charset = 63 if col_type == _TYPE_BLOB else 45  # 63 = binary
                coldef = (
                    encode_lenenc_str(b"def")
                    + encode_lenenc_str(b"") * 3
                    + encode_lenenc_str(name.encode())
                    + encode_lenenc_str(name.encode())
                    + b"\x0c" + struct.pack("<H", charset) + struct.pack("<I", 1024)
                    + bytes([col_type]) + struct.pack("<H", 0) + b"\x00"
                    + b"\x00\x00"
                )
                seq = self._send(conn, seq, coldef)
            seq = self._send(conn, seq, self._eof())
            for row in rows:
                out = b""
                for value in row:
                    if value is None:
                        out += b"\xfb"
                    elif isinstance(value, bytes):
                        out += encode_lenenc_str(value)
                    else:
                        out += encode_lenenc_str(str(value).encode("utf-8"))
                seq = self._send(conn, seq, out)
            self._send(conn, seq, self._eof())

    @staticmethod
    def _column_type(rows: list, index: int) -> int:
        for row in rows:
            v = row[index]
            if v is None:
                continue
            if isinstance(v, bool) or isinstance(v, int):
                return _TYPE_LONGLONG
            if isinstance(v, float):
                return _TYPE_DOUBLE
            if isinstance(v, bytes):
                return _TYPE_BLOB
            return _TYPE_VARSTR
        return _TYPE_VARSTR
