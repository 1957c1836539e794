"""Fleet router process: ``python -m gofr_tpu_torch.devtools.router_proc``
(the JAX package's ``tools/router.py``).

    FLEET_REPLICAS=pre=http://127.0.0.1:8001,dec=http://127.0.0.1:8002 \\
    HTTP_PORT=7000 python -m gofr_tpu_torch.devtools.router_proc

A plain gofr_tpu_torch app (middleware, ``/metrics``, the admin surface,
the SIGTERM drain) whose serving routes forward to the replicas through
:func:`gofr_tpu_torch.fleet.wire_fleet`. No model boots here: leave
``MODEL_NAME``/``TPU_ENABLED`` unset; the front door needs no device.
"""

from __future__ import annotations


def main() -> int:
    import gofr_tpu_torch
    from gofr_tpu_torch.fleet import wire_fleet

    app = gofr_tpu_torch.new()
    if app.container.tpu is not None:
        app.logger.errorf(
            "router process booted a device — unset MODEL_NAME/TPU_ENABLED; "
            "a front door must stay device-free"
        )
        app.shutdown()
        return 2
    try:
        wire_fleet(app)
    except ValueError as exc:
        app.logger.errorf("fleet wiring failed: %s", exc)
        app.shutdown()
        return 2
    # SIGTERM -> App.run's handler -> shutdown() -> fleet.drain() finishes
    # in-flight requests before the listener stops
    app.run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
