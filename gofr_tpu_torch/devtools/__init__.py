"""Developer-facing fleet tooling, never imported by the serving path
(copies of ``gofr_tpu/devtools/``): ``chaos`` (the failure switchboard,
in-process and subprocess replicas, the chaos router), ``supervise``
(restart-on-exit), ``replica_proc`` (a replica process), ``router_proc``
(a router process) and ``trace_capture``. Each process entry runs as
``python -m gofr_tpu_torch.devtools.<name>``."""
