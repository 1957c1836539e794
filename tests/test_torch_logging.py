"""gofr_tpu_torch's logging against gofr_tpu's: the same calls at each
level give the same lines on the same streams, in JSON and in pretty
mode, with the time masked; the leveled API (debugf, notice, fatal) and
the helpers exist and agree."""

import io
import json
import re
import sys

import pytest

from gofr_tpu import logging as jlog
from gofr_tpu_torch import logging as tlog

LEVELS = ["DEBUG", "INFO", "NOTICE", "WARN", "ERROR", "FATAL"]
_PRETTY_TIME = re.compile(r"\[\d\d:\d\d:\d\d\]")


class _Typed:
    """A typed entry (the access log's shape)."""

    def pretty_terminal(self):
        return "PRETTY GET /x"

    def log_fields(self):
        return {"method": "GET", "uri": "/x", "status": 200}


def _calls(logger):
    logger.debug("d plain")
    logger.debugf("d %s %d", "fmt", 1)
    logger.info("i", 1, True)
    logger.infof("i %s", "fmt")
    logger.log("log alias")
    logger.logf("logf %d", 3)
    logger.notice({"k": [1, 2]})
    logger.noticef("n {} {}", "brace", 2)
    logger.warn(_Typed())
    logger.warnf("w %s", "fmt")
    logger.error(None)
    logger.errorf("e %q", "bad format")
    logger.fatal(3.5)
    logger.fatalf("f %s", "fmt")


def _capture(logger, terminal):
    out, err = io.StringIO(), io.StringIO()
    saved = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = out, err
    try:
        _calls(logger)
    finally:
        sys.stdout, sys.stderr = saved
    return _mask(out.getvalue(), terminal), _mask(err.getvalue(), terminal)


def _mask(text, terminal):
    if terminal:
        return _PRETTY_TIME.sub("[T]", text)
    lines = []
    for line in text.splitlines():
        entry = json.loads(line)
        assert re.fullmatch(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d\.\d{6}[+-]\d\d:\d\d", entry["time"])
        entry["time"] = "T"
        lines.append(entry)
    return lines


@pytest.mark.parametrize("terminal", [False, True], ids=["json", "pretty"])
@pytest.mark.parametrize("level", LEVELS)
def test_same_lines_on_the_same_streams(level, terminal):
    want = _capture(jlog.Logger(jlog.level_from_string(level), terminal=terminal), terminal)
    got = _capture(tlog.Logger(tlog.level_from_string(level), terminal=terminal), terminal)
    assert got == want
    out, err = got
    # ERROR and above to stderr, the rest to stdout; nothing below the level
    assert len(out) + len(err) > 0
    if level in ("ERROR", "FATAL"):
        assert not out


def test_level_from_string_and_new_logger_agree():
    for name in LEVELS + ["warn", "bogus", "", "  debug "]:
        assert tlog.level_from_string(name).name == jlog.level_from_string(name).name
        assert tlog.new_logger(name).level.name == jlog.new_logger(name).level.name
    assert [lv.value for lv in tlog.Level] == [lv.value for lv in jlog.Level]
    assert [lv.color() for lv in tlog.Level] == [lv.color() for lv in jlog.Level]


def test_change_level_and_the_silent_logger():
    logger = tlog.Logger(tlog.Level.ERROR, terminal=False)
    out = io.StringIO()
    saved, sys.stdout = sys.stdout, out
    try:
        logger.debugf("hidden")
        logger.change_level(tlog.Level.DEBUG)
        logger.debugf("shown %d", 1)
        tlog.new_silent_logger().info("never")
    finally:
        sys.stdout = saved
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert [x["message"] for x in lines] == ["shown 1"]
