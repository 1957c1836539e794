"""Postmortem black box: on-disk flight-data bundles that outlive the
process (port of ``gofr_tpu/postmortem.py``).

When the engine wedges or fails, the process crashes, or an operator asks
(``POST /admin/postmortem``), the whole observability state goes into one
atomic ``postmortem-<ts>.json`` under ``POSTMORTEM_DIR`` (schema
``gofr-postmortem/1``): the reason and detail, ``versions`` (torch, CUDA,
the driver, the card's name and power limit, python, the platform), the
framework's config keys with secrets redacted and their hash, the
``/admin/engine`` snapshot (state history, watchdog, the stalled dispatch
ids), the dispatch timeline, the flight records (and those in flight), the
SLO budget, the tenants, the last timebase snapshots, the cost model with
its anomaly ring, and every thread's stack.

Triggers: an engine listener on ``wedged`` and ``failed`` (written from a
thread of its own), the recovery supervisor before it quarantines,
``install_crash_hooks`` (``sys.excepthook``, ``threading.excepthook`` and
``faulthandler``; armed only when ``POSTMORTEM_DIR`` is set), and the
operator. Automatic writes are rate-limited (``POSTMORTEM_MIN_INTERVAL_S``,
30) and the newest ``POSTMORTEM_KEEP`` (20) bundles are kept.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Optional

from gofr_tpu_torch.config import environ_snapshot
from gofr_tpu_torch.version import __version__

SCHEMA = "gofr-postmortem/1"

# config keys worth carrying in the fingerprint: every framework prefix
# (the bundle must reproduce the serving shape, not the whole shell env)
CONFIG_PREFIXES = (
    "ADMIN_", "ANOMALY_", "APP_", "BATCH_", "BENCH_", "COMPILE_",
    "COSTMODEL_", "DECODE_",
    "DISPATCH_", "ECHO_", "FLIGHT_", "GEN_", "GRPC_", "HANDLER_", "HTTP_",
    "LOG_", "METRICS_", "MODEL_", "POSTMORTEM_", "PREFILL_", "PREFIX_",
    "SCHED_", "SLO", "SPEC_", "TENANT_", "TIMEBASE_", "TOKENIZER", "TPU_",
    "TRACER_", "WATCHDOG_",
    # the port's own and this layer's: the device, the journal, deadlines,
    # brownout, recovery, paged KV, adapters and the draft model
    "BROWNOUT_", "DRAFT_", "JOURNAL", "KV_", "LORA_", "PRIORITY_", "RECOVERY_",
    "REQUEST_", "TORCH_",
)
# suffixes marking a value as secret: redacted, never written (suffix,
# not substring — GEN_STOP_TOKENS is model config, ADMIN_TOKEN is not)
SECRET_SUFFIXES = ("TOKEN", "SECRET", "PASSWORD", "PASSWD", "KEY", "CREDENTIAL")

_hooks_lock = threading.Lock()
_hooks_installed = False
# the store the process-global crash hooks write through; latest wins
# (containers come and go in tests, hooks are forever)
_active_store: Optional["PostmortemStore"] = None


class PostmortemStore:
    """Assembles, writes, lists, and prunes postmortem bundles.

    ``container`` is the DI container — every source (telemetry,
    timebase, tpu engine/timeline/watchdog) is read through it AT WRITE
    TIME, so a store constructed before the device wires still captures
    it, and a source that is missing (bare test container) simply
    yields null fields."""

    def __init__(
        self,
        container: Any,
        directory: str = "./postmortems",
        keep: int = 20,
        min_interval_s: float = 30.0,
        snapshots: int = 60,
        logger: Any = None,
    ):
        self.container = container
        # anchor NOW: bundles must land relative to where the app was
        # constructed, not wherever the process has chdir'd to by the
        # time a wedge (much later) triggers the write
        self.directory = os.path.abspath(directory)
        self.keep = max(1, keep)
        self.min_interval_s = float(min_interval_s)
        self.snapshots = max(1, snapshots)
        self.logger = logger
        self._lock = threading.Lock()
        # None = no automatic bundle written yet. NOT 0.0: monotonic
        # time starts near zero at HOST boot (Linux), so a zero anchor
        # silently rate-limited every automatic bundle for the
        # machine's first min_interval_s of uptime — exactly the
        # early-boot wedges whose evidence matters most
        self._last_auto: Optional[float] = None

    # -- triggers -------------------------------------------------------------
    def watch_engine(self, engine: Any) -> None:
        """Subscribe to the engine state machine: the ``wedged`` and
        ``failed`` transitions each write a bundle from a detached
        thread (the transition may run under the watchdog's lock, and a
        bundle write — stack formatting, JSON, fsync — must never sit
        in that critical section)."""

        def on_transition(state: str, detail: str) -> None:
            if state not in ("wedged", "failed"):
                return
            threading.Thread(
                target=self.write,
                kwargs={"reason": state, "detail": detail},
                name="gofr-postmortem",
                daemon=True,
            ).start()

        engine.add_listener(on_transition)

    def install_crash_hooks(self) -> None:
        """Chain-wrap ``sys.excepthook`` and ``threading.excepthook`` to
        write a bundle on any unhandled exception before the previous
        hook runs, and arm ``faulthandler`` so fatal signals dump every
        thread's stack into ``fatal-signals.log``. Installed once per
        process; the newest store wins the write."""
        global _hooks_installed, _active_store
        with _hooks_lock:
            _active_store = self
            if _hooks_installed:
                return
            _hooks_installed = True
            prev_sys = sys.excepthook
            prev_threading = threading.excepthook

            def sys_hook(exc_type, exc, tb):
                store = _active_store
                if store is not None:
                    store.write(
                        reason="crash",
                        detail=f"{exc_type.__name__}: {exc}",
                        force=True,
                    )
                prev_sys(exc_type, exc, tb)

            def threading_hook(args):
                store = _active_store
                if store is not None and args.exc_type is not SystemExit:
                    store.write(
                        reason="thread-crash",
                        detail=(
                            f"{args.exc_type.__name__}: {args.exc_value} "
                            f"(thread {getattr(args.thread, 'name', '?')})"
                        ),
                    )
                prev_threading(args)

            sys.excepthook = sys_hook
            threading.excepthook = threading_hook
        try:
            import faulthandler

            os.makedirs(self.directory, exist_ok=True)
            # the file object must outlive this frame: faulthandler
            # keeps the fd, the attribute keeps the object alive
            self._fault_file = open(  # noqa: SIM115 - lifetime is the process
                os.path.join(self.directory, "fatal-signals.log"), "a"
            )
            faulthandler.enable(file=self._fault_file, all_threads=True)
        except Exception as exc:
            self._log_error("faulthandler arm failed: %r", exc)

    def detach(self) -> None:
        """Stop being the crash-hook target (container close)."""
        global _active_store
        with _hooks_lock:
            if _active_store is self:
                _active_store = None

    # -- write side -----------------------------------------------------------
    def write(
        self, reason: str, detail: str = "", force: bool = False
    ) -> Optional[str]:
        """Assemble and atomically write one bundle; returns its path.
        Automatic triggers (``force=False``) are rate-limited to one per
        ``min_interval_s`` — a flapping engine must not fill the disk.
        Forced (operator) writes neither consult nor consume that
        budget, and a FAILED write refunds it: a manual drill or an
        assembly error must never suppress the next wedge's bundle —
        that bundle is the whole point. Never raises: a postmortem
        failing is itself logged, nothing more (the process is usually
        already in trouble here)."""
        now = time.monotonic()
        consumed = False
        prev: Optional[float] = None
        if not force:
            with self._lock:
                if (
                    self._last_auto is not None
                    and now - self._last_auto < self.min_interval_s
                ):
                    return None
                prev = self._last_auto
                self._last_auto = now
                consumed = True
        try:
            bundle = self.bundle(reason, detail)
            path = self._write_atomic(bundle)
            self._prune()
            if self.logger is not None:
                self.logger.warnf(
                    "postmortem bundle written: %s (reason=%s)", path, reason
                )
            return path
        except Exception as exc:
            if consumed:
                with self._lock:
                    if self._last_auto == now:  # nobody else stamped since
                        self._last_auto = prev
            self._log_error("postmortem write failed: %r", exc)
            return None

    def bundle(self, reason: str, detail: str = "") -> dict[str, Any]:
        """Assemble the bundle dict. Host-side reads only — safe (and
        most useful) while the engine is wedged."""
        c = self.container
        out: dict[str, Any] = {
            "schema": SCHEMA,
            "reason": reason,
            "detail": detail,
            "ts": time.time(),  # gofrlint: wall-clock — bundle ts (filename + correlation)
            "iso": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "pid": os.getpid(),
            "versions": runtime_versions(),
            "config": _config_fingerprint(),
            "threads": _thread_stacks(),
        }
        telemetry = getattr(c, "telemetry", None)
        if telemetry is not None:
            out["requests"] = telemetry.records(limit=telemetry.capacity)
            out["requests_in_flight"] = telemetry.active_records()
        slo = getattr(c, "slo", None)
        if slo is not None:
            # the error-budget ledger at death: "were we already burning
            # before this happened" — a fresh evaluation, not a cache,
            # plus the latched alert evidence it carries
            try:
                out["slo_budget"] = slo.budget()
            except Exception as exc:
                out["slo_budget"] = {"error": repr(exc)}
        tenants = getattr(c, "tenants", None)
        if tenants is not None:
            # who was on the box: top-K tenants by token volume (hashed
            # ids only — the sketch never holds raw keys)
            out["tenants"] = tenants.snapshot(k=50)
        timebase = getattr(c, "timebase", None)
        if timebase is not None:
            from gofr_tpu_torch.timebase import jsonable_snapshots

            out["timebase"] = jsonable_snapshots(
                timebase.snapshots(last=self.snapshots)
            )
        tpu = getattr(c, "tpu", None)
        if tpu is not None:
            try:
                out["engine"] = tpu.engine_snapshot()
            except Exception as exc:
                out["engine"] = {"error": repr(exc)}
            timeline = getattr(tpu, "timeline", None)
            if timeline is not None:
                out["dispatches"] = timeline.records(limit=1_000_000)
            costmodel = getattr(tpu, "costmodel", None)
            if costmodel is not None:
                # the residual watchtower's state at death: calibration,
                # sheets, per-family residual EMAs, and the full anomaly
                # ring — "was the engine already blowing its predictions
                # before it wedged" is the first postmortem question
                try:
                    out["costmodel"] = costmodel.snapshot()
                    out["anomalies"] = costmodel.ring.events(
                        limit=costmodel.ring.capacity
                    )
                except Exception as exc:
                    out["costmodel"] = {"error": repr(exc)}
        return out

    def _write_atomic(self, bundle: dict[str, Any]) -> str:
        os.makedirs(self.directory, exist_ok=True)
        ts = time.strftime("%Y%m%dT%H%M%S", time.gmtime(bundle["ts"]))
        ms = int((bundle["ts"] % 1) * 1000)
        name = f"postmortem-{ts}.{ms:03d}.json"
        path = os.path.join(self.directory, name)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(bundle, fh, indent=1, default=str)
            fh.flush()
            # fsync BEFORE the rename: the whole point is surviving a
            # SIGKILL moments later, so the data must hit the platter
            # before the name does
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        return path

    def _prune(self) -> None:
        bundles = self.list()
        for entry in bundles[: -self.keep]:
            try:
                os.unlink(os.path.join(self.directory, entry["file"]))
            except OSError:
                pass

    # -- read side ------------------------------------------------------------
    def list(self) -> list[dict[str, Any]]:
        """Bundle inventory, oldest first: file, size, mtime."""
        try:
            names = sorted(
                n for n in os.listdir(self.directory)
                if n.startswith("postmortem-") and n.endswith(".json")
            )
        except OSError:
            return []
        out = []
        for name in names:
            try:
                st = os.stat(os.path.join(self.directory, name))
            except OSError:
                continue
            out.append({"file": name, "bytes": st.st_size, "mtime": st.st_mtime})
        return out

    def _log_error(self, fmt: str, *args: Any) -> None:
        if self.logger is not None:
            try:
                self.logger.errorf(fmt, *args)
                return
            except Exception:
                pass  # the logger itself failed: fall through to stderr
        try:
            print("[postmortem] " + (fmt % args), file=sys.stderr)
        except Exception:
            pass  # the last reporter on the crash path


def runtime_versions() -> dict[str, Any]:
    """The one versions dict, shared by bundles and ``engine_snapshot``:
    the package, python, torch and its CUDA, and on a machine with a card
    the driver, the card's name and its power limit as ``nvidia-smi``
    reads them (None where there is none). It initializes no CUDA context:
    a bundle written on the crash path must not touch a faulted one."""
    import platform

    import torch

    out: dict[str, Any] = {
        "gofr_tpu_torch": __version__,
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "driver": None,
        "card": None,
        "power_limit": None,
        "platform": platform.platform(),
    }
    out.update(_nvidia_smi())
    return out


@functools.lru_cache(maxsize=1)
def _nvidia_smi() -> dict[str, Any]:
    """The driver version, the card's name and its power limit, or nothing
    when ``nvidia-smi`` is missing or fails (read once a process)."""
    import shutil
    import subprocess

    if shutil.which("nvidia-smi") is None:
        return {}
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=driver_version,name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=10, check=True,
        ).stdout.strip().splitlines()[0]
    except Exception:
        return {}
    driver, card, limit = (part.strip() for part in (line.split(",") + ["", ""])[:3])
    return {"driver": driver or None, "card": card or None, "power_limit": limit or None}


def _config_fingerprint() -> dict[str, Any]:
    """Framework config keys present in the environment, secrets
    redacted, plus a stable hash of the redacted view — enough to say
    "these two wedges ran the same config" without leaking credentials."""
    environ = environ_snapshot()
    keys: dict[str, str] = {}
    for key in sorted(environ):
        if not key.startswith(CONFIG_PREFIXES):
            continue
        if key.upper().endswith(SECRET_SUFFIXES):
            keys[key] = "<redacted>"
        else:
            keys[key] = environ[key]
    digest = hashlib.sha256(
        "\n".join(f"{k}={v}" for k, v in keys.items()).encode()
    ).hexdigest()[:16]
    return {"keys": keys, "fingerprint": digest}


def _thread_stacks() -> list[dict[str, Any]]:
    """Every live thread's current stack. The wedged dispatch's thread
    is in here — the line that says WHICH call never returned."""
    frames = sys._current_frames()
    by_ident = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        thread = by_ident.get(ident)
        out.append(
            {
                "name": thread.name if thread else f"<ident {ident}>",
                "ident": ident,
                "daemon": thread.daemon if thread else None,
                "stack": "".join(traceback.format_stack(frame)),
            }
        )
    out.sort(key=lambda t: t["name"])
    return out
