"""A replica process: ``python -m gofr_tpu_torch.devtools.replica_proc``
(copy of ``gofr_tpu/devtools/replica_proc.py``).

The in-process :class:`~gofr_tpu_torch.devtools.chaos.ChaosReplica` can fake
every failure EXCEPT process death — a ``kill -9`` needs a real OS
process to kill. This entry boots the same serving surface
``chaos.build_replica`` wires (echo runner, OpenAI routes, the
``/generate`` token surface) in its own interpreter, configured purely
through the inherited environment (``HTTP_PORT``, ``MODEL_NAME`` (echo,
or a real model such as llama3-8b with ``MODEL_PATH``), ``FLEET_ROLE``,
``KV_TRANSFER_TRUST_HINT``, ``JOURNAL_DIR`` for WAL durability, ...), and
blocks in ``app.run()`` until SIGTERM. Under ``GOFR_SANITIZE=1`` it runs
on the lock sanitizer and writes its report as it ends
(``devtools/sanitizer.py::write_report``).

Spawned by :class:`~gofr_tpu_torch.devtools.chaos.SubprocessReplica` (usually
under a :class:`~gofr_tpu_torch.devtools.supervise.Supervisor`, so a SIGKILL
is followed by a respawn that rehydrates the journal WAL).
"""

from __future__ import annotations


def main() -> None:
    import threading

    from gofr_tpu_torch.devtools import sanitizer

    # GOFR_SANITIZE=1: every lock the app builds is a sanitizing wrapper;
    # the verdict (cycles, hold warnings, threads left after the
    # shutdown) goes to GOFR_SANITIZE_REPORT as the process ends
    armed = sanitizer.enabled()
    if armed:
        sanitizer.install()
    before = set(threading.enumerate())

    import gofr_tpu_torch
    from gofr_tpu_torch.devtools.chaos import _generate_handler
    from gofr_tpu_torch.openai import register_openai_routes

    app = gofr_tpu_torch.new()
    register_openai_routes(app)
    app.post("/generate", _generate_handler)
    app.run()  # blocks until SIGTERM, then drains + shuts down
    if armed:
        sanitizer.write_report(before)


if __name__ == "__main__":
    main()
