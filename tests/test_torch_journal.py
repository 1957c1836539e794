"""gofr_tpu_torch's generation journal and its write-ahead log
(``telemetry.py``: ``request_key``, ``JournalEntry``,
``GenerationJournal``; ``journal_wal.py``) against gofr_tpu's
(``tests/test_journal_wal.py``, ``tests/test_recovery.py``'s journal part).

- ``request_key`` gives the same key for the same request in both packages
  (and separates seeds, prompts, budgets, models and stop sets).
- The same journal operations give the same claims, truncation, eviction
  and stats.
- The WAL is the reference's byte for byte: the same frames, the same
  segment files for the same operations, and a directory written by
  either package recovers in the other to the same entries, rotation and
  retention included.
- The truncation fuzz (a segment cut at every byte) and the bit-flip fuzz
  recover in the port to exactly what the JAX package recovers, and never
  install tokens that are not a true prefix.
- Process death across packages: an echo device of one package leaves an
  interrupted stream in its ``JOURNAL_DIR``; an echo device of the other
  rehydrates it and resumes it bit-identically.

Every test clears both packages' journal, record and deadline
contextvars.
"""

import os
import struct

import numpy as np
import pytest

import gofr_tpu.deadline as jd
import gofr_tpu.journal_wal as jw
import gofr_tpu.telemetry as jt
import gofr_tpu_torch.deadline as td
import gofr_tpu_torch.journal_wal as tw
import gofr_tpu_torch.telemetry as tt
from gofr_tpu.ops.sampling import Sampler as JaxSampler
from gofr_tpu_torch.config import DECLARED_KEYS, EnvFileConfig
from gofr_tpu_torch.logging import Level, Logger
from gofr_tpu_torch.metrics import Registry
from gofr_tpu_torch.ops.sampling import Sampler

PROMPT = [5, 6, 7]


def _clear():
    for mod in (jt, tt):
        mod.activate_journal_entry(None)
        mod.activate_record(None)
    for mod in (jd, td):
        mod.activate_deadline(None)
        mod.activate_priority(None)


@pytest.fixture(autouse=True)
def _no_leaked_contextvars():
    _clear()
    yield
    _clear()


# -- the key and the journal -----------------------------------------------------

SAMPLERS = [
    {}, {"seed": 7}, {"seed": 8}, {"temperature": 0.8, "top_k": 5, "seed": 3},
    {"temperature": 0.7, "top_p": 0.9, "min_p": 0.05}, {"repetition_penalty": 1.3},
    {"presence_penalty": 0.5, "frequency_penalty": 0.25, "seed": 1},
]


@pytest.mark.parametrize("knobs", SAMPLERS)
def test_request_key_matches_jax(knobs):
    rng = np.random.default_rng(len(knobs))
    prompt = rng.integers(0, 1000, size=12).tolist()
    for stops in (None, {5}, {9, 2, 4}):
        got = tt.request_key("m", prompt, 8, Sampler(**knobs), stop_tokens=stops)
        want = jt.request_key("m", prompt, 8, JaxSampler(**knobs), stop_tokens=stops)
        assert got == want
    assert tt.request_key("m", prompt, 8) == jt.request_key("m", prompt, 8)


def test_request_key_separates_what_changes_the_stream():
    base = tt.request_key("m", [1, 2, 3], 8, Sampler(seed=7))
    assert base == tt.request_key("m", [1, 2, 3], 8, Sampler(seed=7))
    for other in (
        tt.request_key("m", [1, 2, 3], 8, Sampler(seed=8)),
        tt.request_key("m", [1, 2, 4], 8, Sampler(seed=7)),
        tt.request_key("m", [1, 2, 3], 9, Sampler(seed=7)),
        tt.request_key("m2", [1, 2, 3], 8, Sampler(seed=7)),
        tt.request_key("m", [1, 2, 3], 8, Sampler(seed=7), stop_tokens={5}),
    ):
        assert other != base


def _journal_ops(mod, registry=None):
    """The JAX test's journal walk: interrupt, claim by token count,
    single use, the token cap, capacity eviction, a clean finish."""
    journal = mod.GenerationJournal(capacity=2, max_tokens=4, metrics=registry)
    out = []
    entry = journal.start("k1", "echo", 8, seeded=True, deterministic=True)
    entry.append(11)
    entry.append(12)
    journal.interrupt(entry, "pool died")
    journal.interrupt(entry, "a later cause")  # the first interruption wins
    out.append(journal.stats())
    out.append(journal.claim("k1", min_tokens=3))
    claimed = journal.claim("k1", min_tokens=2)
    out.append((claimed.status, claimed.tokens, claimed.reason, claimed.snapshot()["status"]))
    out.append(journal.claim("k1"))
    full = journal.start("k2", "echo", 8, seeded=True, deterministic=True)
    for token in range(6):
        full.append(token)
    out.append((full.truncated, full.tokens))
    journal.interrupt(full, "wedge")
    out.append(journal.claim("k2"))
    for i in range(3, 6):
        e = journal.start(f"k{i}", "echo", 8, seeded=True, deterministic=True)
        journal.interrupt(e, "wedge")
    out.append(journal.interrupted())
    out.append(journal.claim("k3"))
    out.append(journal.claim("k5").key)
    done = journal.start("k6", "echo", 8, seeded=False, deterministic=True)
    done.append(1)
    journal.finish(done)
    journal.finish(done)  # idempotent
    out.append(journal.stats())
    journal.note_resume("teacher_forced")
    journal.note_resume("replayed")
    journal.note_resume("replayed")
    return out


def test_journal_matches_jax():
    from gofr_tpu.metrics import Registry as JaxRegistry

    reg, jreg = Registry(), JaxRegistry()
    assert _journal_ops(tt, reg) == _journal_ops(jt, jreg)
    name, labels = "gofr_tpu_journal_resumes_total", ("mode",)
    assert reg.counter(name, labels=labels).data() == \
        jreg.counter(name, labels=labels).data() == {("teacher_forced",): 1.0,
                                                     ("replayed",): 2.0}


# -- the WAL, byte for byte ------------------------------------------------------

def test_frames_and_constants_match_jax():
    assert (tw.MAGIC, tw.WIRE_VERSION, tw.MAX_RECORD_BYTES, tw.FSYNC_POLICIES) == \
        (jw.MAGIC, jw.WIRE_VERSION, jw.MAX_RECORD_BYTES, jw.FSYNC_POLICIES)
    kinds = (tw.K_OPEN, tw.K_TOKENS, tw.K_FINISH, tw.K_INTERRUPT, tw.K_CLAIM, tw.K_RETIRE,
             tw.K_CHECKPOINT)
    assert kinds == (jw.K_OPEN, jw.K_TOKENS, jw.K_FINISH, jw.K_INTERRUPT, jw.K_CLAIM,
                     jw.K_RETIRE, jw.K_CHECKPOINT)
    rng = np.random.default_rng(5)
    for kind in kinds:
        payload = rng.integers(0, 256, size=int(rng.integers(0, 64)), dtype=np.uint8).tobytes()
        assert tw._frame(kind, payload) == jw._frame(kind, payload)
    header = tw.MAGIC + struct.pack("<I", 1)
    body = tw._frame(tw.K_OPEN, b'{"x":1}') + tw._frame(tw.K_TOKENS, b"\x01\x00\x00\x00")
    assert list(tw._iter_frames(header + body)) == list(jw._iter_frames(header + body))
    mutated = bytearray(header + body)
    mutated[len(header)] = tw.K_TOKENS  # a flipped kind fails the CRC
    for mod in (tw, jw):
        with pytest.raises(mod.WALError):
            list(mod._iter_frames(bytes(mutated)))
        with pytest.raises(mod.WALError):
            list(mod._iter_frames(b"XXXX" + struct.pack("<I", 1) + body))
    with pytest.raises(ValueError):
        tw.JournalWAL("/nonexistent-never-made", fsync="sometimes")


def _lifecycle(mod_t, mod_w, directory, segment_bytes=1 << 20, retain=4):
    """The same journal traffic on a WAL: one finished, one interrupted,
    one left open (the signature of a killed process), one truncated, one
    claimed, and churn that rotates when segments are small."""
    wal = mod_w.JournalWAL(directory, segment_bytes=segment_bytes, retain=retain)
    journal = mod_t.GenerationJournal(capacity=8, max_tokens=64, wal=wal)
    done = journal.start("k-done", "echo", 16, seeded=False, deterministic=True)
    for t in range(5):
        done.append(t)
    journal.finish(done)
    hurt = journal.start("k-hurt", "echo", 16, seeded=True, deterministic=True,
                         prior=[90, 91])
    for t in (100, 101, 102):
        hurt.append(t)
    journal.interrupt(hurt, "pool failure")
    trunc = journal.start("k-trunc", "echo", 200, seeded=False, deterministic=True)
    for t in range(70):
        trunc.append(t)
    journal.interrupt(trunc, "wedge")
    claimed = journal.start("k-claimed", "echo", 8, seeded=False, deterministic=True)
    claimed.append(3)
    journal.interrupt(claimed, "wedge")
    assert journal.claim("k-claimed", 1) is not None
    for i in range(12):
        churn = journal.start(f"churn{i}", "echo", 64, seeded=False, deterministic=True)
        for t in range(40):
            churn.append(t)
        journal.finish(churn)
    live = journal.start("k-live", "echo", 16, seeded=False, deterministic=True)
    live.append(200)
    live.append(201)
    return wal  # not closed: flushed frames must be enough


def _segments(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        if name.startswith("wal-"):
            with open(os.path.join(directory, name), "rb") as f:
                out[name] = f.read()
    return out


@pytest.mark.parametrize("segment_bytes,retain", [(1 << 20, 4), (4096, 2)],
                         ids=["one-segment", "rotated"])
def test_the_same_traffic_writes_the_same_bytes(tmp_path, segment_bytes, retain):
    _lifecycle(tt, tw, str(tmp_path / "port"), segment_bytes, retain)
    _lifecycle(jt, jw, str(tmp_path / "jax"), segment_bytes, retain)
    got, want = _segments(str(tmp_path / "port")), _segments(str(tmp_path / "jax"))
    assert got == want and got
    if segment_bytes == 4096:
        assert len(got) == retain  # rotated, and retention dropped the oldest


def _rehydrated(mod_t, mod_w, directory):
    journal = mod_t.GenerationJournal(capacity=8, max_tokens=64,
                                      wal=mod_w.JournalWAL(directory))
    count = journal.rehydrate()
    entries = sorted((e["key"], e["tokens"], e["status"], e["reason"])
                     for e in journal.interrupted())
    claims = {}
    for key in ("k-hurt", "k-live", "k-done", "k-trunc", "k-claimed"):
        entry = journal.claim(key, 0)
        claims[key] = None if entry is None else (entry.tokens, entry.reason)
    return count, entries, claims, journal.stats()["rehydrated"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_recovers_the_others_wal(tmp_path, writer):
    mods = {"port": (tt, tw), "jax": (jt, jw)}
    reader = "jax" if writer == "port" else "port"
    _lifecycle(*mods[writer], str(tmp_path / "a"), 4096, 2)
    _lifecycle(*mods[writer], str(tmp_path / "b"), 4096, 2)
    got = _rehydrated(*mods[reader], str(tmp_path / "a"))
    want = _rehydrated(*mods[writer], str(tmp_path / "b"))
    assert got == want
    count, _, claims, _ = got
    assert count == 2
    assert claims["k-hurt"] == ([90, 91, 100, 101, 102], "pool failure")
    assert claims["k-live"][0] == [200, 201] and "process death" in claims["k-live"][1]
    assert claims["k-done"] is None and claims["k-trunc"] is None
    assert claims["k-claimed"] is None
    # the claims were logged: a third boot, in either package, finds nothing
    for mod_t, mod_w in mods.values():
        assert _rehydrated(mod_t, mod_w, str(tmp_path / "a"))[0] == 0


def _fuzz_segment(mod_t, mod_w, directory):
    wal = mod_w.JournalWAL(directory, segment_bytes=1 << 20)
    journal = mod_t.GenerationJournal(capacity=16, max_tokens=256, wal=wal)
    a = journal.start("ka", "echo", 32, seeded=False, deterministic=True)
    b = journal.start("kb", "echo", 32, seeded=True, deterministic=True)
    for t in range(4):
        a.append(10 + t)
        b.append(20 + t)
    journal.interrupt(a, "wedge-a")
    c = journal.start("kc", "echo", 32, seeded=False, deterministic=True)
    c.append(30)
    journal.finish(b)
    c.append(31)
    (name,) = _segments(directory)
    return os.path.join(directory, name)


TRUTH = {"ka": [10, 11, 12, 13], "kb": [20, 21, 22, 23], "kc": [30, 31]}


def _recover_bytes(mod_w, directory, name, data):
    with open(os.path.join(directory, name), "wb") as f:
        f.write(data)
    wal = mod_w.JournalWAL(directory)
    return wal.recover(), wal.torn_segments


@pytest.mark.parametrize("damage", ["truncate", "bitflip"])
def test_fuzz_recovers_what_jax_recovers(tmp_path, damage):
    seg = _fuzz_segment(tt, tw, str(tmp_path / "src"))
    with open(seg, "rb") as f:
        data = f.read()
    name = os.path.basename(seg)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    os.makedirs(port_dir)
    os.makedirs(jax_dir)
    points = range(len(data) + 1) if damage == "truncate" else range(len(data))
    for i in points:
        if damage == "truncate":
            mutated = data[:i]
        else:
            flipped = bytearray(data)
            flipped[i] ^= 0x40
            mutated = bytes(flipped)
        got = _recover_bytes(tw, port_dir, name, mutated)
        assert got == _recover_bytes(jw, jax_dir, name, mutated), (damage, i)
        for state in got[0]:
            tokens = state["tokens"]
            assert tokens == TRUTH[state["key"]][: len(tokens)], (damage, i)
    recovered, torn = _recover_bytes(tw, port_dir, name, data)
    assert {s["key"] for s in recovered} == {"ka", "kc"} and torn == 0


# -- process death across packages (echo devices) --------------------------------

def _with_env(env, fn):
    from gofr_tpu.config import DECLARED_KEYS as JAX_KEYS

    keys = set(DECLARED_KEYS) | set(JAX_KEYS) | set(env)
    old = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _echo(package, journal_dir, registry=None):
    env = {"MODEL_NAME": "echo", "JOURNAL_DIR": journal_dir, "ECHO_STEP_MS": "1",
           "WATCHDOG_DISPATCH_TIMEOUT_S": "off"}
    if package == "jax":
        from gofr_tpu.config import EnvConfig
        from gofr_tpu.logging import Level as JaxLevel
        from gofr_tpu.metrics import Registry as JaxRegistry
        from gofr_tpu.testutil import MockLogger
        from gofr_tpu.tpu.device import new_device

        return _with_env(env, lambda: new_device(EnvConfig(), MockLogger(JaxLevel.FATAL),
                                                 registry or JaxRegistry()))
    from gofr_tpu_torch.tpu.device import TPUDevice

    return _with_env(env, lambda: TPUDevice(EnvFileConfig("/nonexistent"), Logger(Level.FATAL),
                                            metrics=registry or Registry()))


@pytest.mark.parametrize("first,second", [("port", "jax"), ("jax", "port")])
def test_process_death_resume_across_packages(tmp_path, first, second):
    """An interrupted stream's records outlive the first device (close
    writes no terminal record for an interrupted entry); a device of the
    other package over the same JOURNAL_DIR rehydrates it at boot and
    resumes at position 5 bit-identically, teacher-forced; the claim is
    logged, so a third boot finds nothing."""
    directory = str(tmp_path / "journal")
    device = _echo(first, directory)
    try:
        full = device.generate(PROMPT, max_new_tokens=12)
        key = device._journal_key(PROMPT, 12, None, device.default_stop_ids, None)
        entry = device.journal.start(key, "echo", 12, seeded=False, deterministic=True)
        for token in full[:7]:
            entry.append(token)
        device.journal.interrupt(entry, "injected wedge")
        assert device.engine_snapshot()["journal"]["wal"]["segments"] >= 1
    finally:
        device.close()
    registry = Registry() if second == "port" else None
    reborn = _echo(second, directory, registry)
    try:
        stats = reborn.journal.stats()
        assert (stats["rehydrated"], stats["interrupted"]) == (1, 1)
        resumed = list(reborn.generate_stream(PROMPT, max_new_tokens=12, resume_from=5))
        assert full[:5] + resumed == full
        if registry is not None:
            modes = registry.counter("gofr_tpu_journal_resumes_total", labels=("mode",))
            assert modes.data() == {("teacher_forced",): 1.0}
        assert reborn.engine_snapshot()["journal"]["wal"]["live_entries"] == 0
    finally:
        reborn.close()
    for package in ("port", "jax"):
        third = _echo(package, directory)
        try:
            assert third.journal.stats()["rehydrated"] == 0
        finally:
            third.close()


def test_the_journal_is_off_or_in_memory_without_its_dir(tmp_path):
    from gofr_tpu_torch.tpu.device import TPUDevice

    def build(env):
        return _with_env({"MODEL_NAME": "echo", **env},
                         lambda: TPUDevice(EnvFileConfig("/nonexistent"), Logger(Level.FATAL)))

    device = build({})
    try:
        assert device.journal_wal is None and device.journal.stats()["wal"] is None
        assert device.generate(PROMPT, max_new_tokens=4) == [5, 6, 7, 5]
        assert device.journal.stats()["completions"] == 1
    finally:
        device.close()
    device = build({"JOURNAL": "off", "JOURNAL_DIR": str(tmp_path / "j")})
    try:
        assert device.journal is None and device.journal_wal is None
        assert device.engine_snapshot()["journal"] is None
        assert list(device.generate_stream(PROMPT, max_new_tokens=6, resume_from=2)) == \
            [7, 5, 6, 7]  # no journal: the replayed resume
    finally:
        device.close()
