"""The port's CMD transport (``gofr_tpu_torch/cmd.py``), case for case with
``tests/test_cmd.py``, and ``run_cmd`` beside the JAX package's: the same
argv and handlers give the same stdout, stderr and exit code."""

import pytest

import gofr_tpu_torch
from gofr_tpu_torch.cmd import CMDRequest, command_string, run_cmd
from gofr_tpu_torch.testutil import stderr_output_for, stdout_output_for


@pytest.fixture
def cmd_app(monkeypatch, tmp_path):
    monkeypatch.setenv("LOG_LEVEL", "FATAL")
    monkeypatch.chdir(tmp_path)
    return gofr_tpu_torch.new_cmd()


def test_flag_parsing():
    req = CMDRequest(["hello", "-verbose", "--name=ada", "-n=3"])
    assert req.param("verbose") == "true"
    assert req.param("name") == "ada"
    assert req.param("n") == "3"
    assert req.param("missing") == ""


def test_command_string_skips_flags():
    assert command_string(["hello", "-a", "--b=c", "world"]) == "hello world"


def test_bind_types():
    class Opts:
        name: str = ""
        count: int = 0
        fast: bool = False

    req = CMDRequest(["run", "--name=x", "--count=5", "-fast"])
    opts = req.bind(Opts)
    assert opts.name == "x" and opts.count == 5 and opts.fast is True


def test_route_match_and_output(cmd_app):
    cmd_app.sub_command("hello", lambda ctx: f"Hello {ctx.param('name')}!")
    out = stdout_output_for(lambda: run_cmd(cmd_app, ["hello", "--name=ada"]))
    assert out == "Hello ada!\n"


def test_regex_route(cmd_app):
    cmd_app.sub_command(r"greet \w+", lambda ctx: "matched")
    out = stdout_output_for(lambda: run_cmd(cmd_app, ["greet", "bob"]))
    assert "matched" in out


def test_no_command_found(cmd_app):
    cmd_app.sub_command("hello", lambda ctx: "hi")
    err = stderr_output_for(lambda: run_cmd(cmd_app, ["bogus"]))
    assert "No Command Found!" in err


def test_handler_error_to_stderr(cmd_app):
    def fails(ctx):
        raise ValueError("broken pipe dream")

    cmd_app.sub_command("fail", fails)
    err = stderr_output_for(lambda: run_cmd(cmd_app, ["fail"]))
    assert "broken pipe dream" in err
    assert run_cmd(cmd_app, ["fail"]) == 1


def test_dict_result_prints_json(cmd_app):
    cmd_app.sub_command("info", lambda ctx: {"version": 1})
    out = stdout_output_for(lambda: run_cmd(cmd_app, ["info"]))
    assert '"version": 1' in out


def test_lora_finetune_example(monkeypatch, tmp_path):
    """The port's lora_finetune example CLI trains adapters on the CPU and
    writes a merged checkpoint that the serving path can load (MODEL_PATH
    round trip)."""
    import runpy
    import sys

    out = str(tmp_path / "lora_ckpt")
    monkeypatch.setenv("LOG_LEVEL", "FATAL")
    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(
        sys, "argv",
        ["lora_finetune", "finetune", "--model=tiny", "--steps=4", "--rank=2",
         f"--out={out}"],
    )
    text = stdout_output_for(
        lambda: runpy.run_module("gofr_tpu_torch.examples.lora_finetune", run_name="__main__")
    )
    assert "merged checkpoint" in text

    from gofr_tpu_torch.training.checkpoint import restore_params

    params = restore_params(out, "cpu")
    assert params["layers.0.wq"].ndim == 2  # merged: plain weights
    assert not any("lora" in key for key in params)


# -- the two packages side by side ----------------------------------------------

def _handlers():
    def fails(ctx):
        raise ValueError("broken pipe dream")

    return [
        ("hello", lambda ctx: f"Hello {ctx.param('name')}!"),
        (r"greet \w+", lambda ctx: "matched"),
        ("info", lambda ctx: {"version": 1, "name": ctx.param("name")}),
        ("bind", lambda ctx: sorted(ctx.bind().items())),
        ("host", lambda ctx: ctx.host_name()),
        ("none", lambda ctx: None),
        ("fail", fails),
    ]


@pytest.mark.parametrize("argv", [
    ["hello", "--name=ada"],
    ["greet", "bob"],
    ["info", "-name=x"],
    ["bind", "--a=1", "-b", "--c="],
    ["host"],
    ["none"],
    ["fail"],
    ["bogus", "--name=ada"],
    [],
])
def test_run_cmd_matches_jax(argv, monkeypatch, tmp_path):
    """For the same argv and handlers, the port's ``run_cmd`` prints the
    same stdout and stderr and returns the same exit code as the JAX
    package's."""
    import gofr_tpu
    from gofr_tpu.cmd import run_cmd as jax_run_cmd

    monkeypatch.setenv("LOG_LEVEL", "FATAL")
    monkeypatch.chdir(tmp_path)
    results = []
    for new_cmd, runner in ((gofr_tpu.new_cmd, jax_run_cmd),
                            (gofr_tpu_torch.new_cmd, run_cmd)):
        app = new_cmd()
        for pattern, handler in _handlers():
            app.sub_command(pattern, handler)
        code = []
        err = []
        out = stdout_output_for(
            lambda: err.append(stderr_output_for(lambda: code.append(runner(app, argv))))
        )
        results.append((out, err[0], code[0]))
    assert results[1] == results[0]


def test_cmd_app_run_exits_like_jax(monkeypatch, tmp_path):
    """``App.run`` on a CLI app raises SystemExit(1) on a failed command in
    both packages, and returns on success."""
    import sys

    import gofr_tpu

    monkeypatch.setenv("LOG_LEVEL", "FATAL")
    monkeypatch.chdir(tmp_path)
    for new_cmd in (gofr_tpu.new_cmd, gofr_tpu_torch.new_cmd):
        app = new_cmd()
        app.sub_command("ok", lambda ctx: "fine")
        monkeypatch.setattr(sys, "argv", ["cli", "ok"])
        assert stdout_output_for(app.run) == "fine\n"
        monkeypatch.setattr(sys, "argv", ["cli", "nope"])
        with pytest.raises(SystemExit) as exc:
            stderr_output_for(app.run)
        assert exc.value.code == 1


def test_sample_cmd_example_as_a_process(tmp_path):
    """``python -m gofr_tpu_torch.examples.sample_cmd``: the JAX example's
    stdout and exit codes, run as its own process."""
    import os
    import pathlib
    import subprocess
    import sys

    repo = str(pathlib.Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=repo, LOG_LEVEL="FATAL")

    def run(*args):
        return subprocess.run(
            [sys.executable, "-m", "gofr_tpu_torch.examples.sample_cmd", *args],
            cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120,
        )

    ok = run("hello", "--name=x")
    assert (ok.returncode, ok.stdout) == (0, "Hello x!\n")
    missing = run("nope")
    assert missing.returncode == 1 and "No Command Found!" in missing.stderr
