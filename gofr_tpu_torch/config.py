"""Config: the process environment over ``<configs_dir>/.env``.

Trimmed copy of ``gofr_tpu/config.py``'s ``EnvFileConfig``. The port
reads only the keys in ``DECLARED_KEYS``; asking for any other raises, so
a key the port does not honor cannot be read by mistake.

``UNHONORED_KEYS`` lists the reference's settings the port does not honor
yet, each with why and the ROADMAP item that ports it; with
``DECLARED_KEYS`` it covers every key the JAX package declares, and no key
is in both. At boot, :func:`check_unhonored` reads each listed key from the
environment and the ``.env`` file: a set key whose absence would change
the answers, the topology, a durability guarantee or the memory the
process takes stops the boot with its name; any other set key is logged
once at WARN.
"""

from __future__ import annotations

import os
from typing import Any, Optional

DECLARED_KEYS: dict[str, str] = {
    "MODEL_NAME": "mlp (default) | bert-tiny | bert-base | tiny | small | llama3-8b | llama3-70b",
    "MODEL_MAX_SEQ": "KV cache length per request (<= the model's max_seq)",
    "MODEL_BUCKETS": "comma-separated prefill sequence buckets",
    "MODEL_SEED": "seed of the random weight init (without MODEL_PATH)",
    "MODEL_PATH": "weights: an HF safetensors file or directory, or a torch checkpoint dir",
    "MODEL_QUANT": "weight quantization: int8 | int4 | w8a8 (default: off)",
    "MODEL_KV_DTYPE": "KV cache storage: bf16 (default) | f8 (float8 e4m3)",
    "BATCH_MAX_SIZE": "prefill batch rows",
    "BATCH_TIMEOUT_MS": "prefill batch fill deadline",
    "DECODE_CHUNK": "decode steps per host fetch",
    "DECODE_POOL": "'on' (default): continuous-batching decode pool; 'off': solo decode",
    "DECODE_SLOTS": "decode pool slots (default BATCH_MAX_SIZE)",
    "DECODE_PIPELINE": "decode pool chunks in flight (default 3)",
    "DECODE_POOL_PENALTIES": "penalized requests in the pool: lazy (default) | eager | off",
    "KV_PAGED": "'on' (default): block-table prefix cache and KV admission ledger",
    "KV_BLOCK_TOKENS": "tokens per KV block (default 64; must divide max_seq)",
    "KV_BLOCKS": "KV admission ledger in blocks (0 = auto: slots + prefix entries)",
    "PREFIX_CACHE": "prompts whose KV the prefix cache keeps (0 = off)",
    "PREFIX_LCP_MIN": "shared tokens for a partial hit (0 = smallest bucket, -1 = exact only)",
    "PREFILL_CHUNK_TOKENS": "prefill compute budget: longer prompts prefill in slices (0 = off)",
    "SCHED_POLICY": "prefill/decode interleave: fair | decode-first | prefill-first",
    "SCHED_MAX_DEFER_MS": "longest a prefill dispatch waits for its decode turn",
    "TOKENIZER": "'byte' for the byte-level tokenizer",
    "TOKENIZER_PATH": "BPE merges file, or an HF tokenizer.json (wins over TOKENIZER)",
    "CHAT_TEMPLATE": "per-message chat template with {role} and {content}",
    "CHAT_TEMPLATE_OPENER": "assistant-turn opener (default: the template before {content})",
    "CHAT_TEMPLATE_JINJA": "jinja chat template: a file path or the template itself",
    "GEN_STOP_TOKENS": "comma-separated default stop ids (instead of the tokenizer's EOS)",
    "GEN_STOP_EOS": "'off': no default stop ids",
    "DRAFT_MODEL_NAME": "speculative decoding's draft model config (same vocab as the target)",
    "DRAFT_TOKENS": "draft tokens proposed per speculative cycle (default 4, >= 2)",
    "DRAFT_MODEL_PATH": "draft weights, as MODEL_PATH (default: a seeded init)",
    "SPEC_POOLED": "'on': speculate through the decode pool (default off)",
    "SPEC_NGRAM": "pooled speculation drafts by prompt lookup (default on)",
    "SPEC_K_MAX": "pooled speculation's most draft tokens a cycle (default 4)",
    "LORA_ADAPTERS": "LoRA adapters served over the base: name=path[,name2=path2...]",
    "ADMIN_TOKEN": "bearer token the /admin routes require (unset: open)",
    "OPENAI_FANOUT_WORKERS": "n/best_of candidates decoded at once (default 3/4 of the pool)",
    "HTTP_PORT": "HTTP listen port",
    "GRPC_PORT": "gRPC listen port (default 9000; the server starts when a service is registered)",
    "DB_DIALECT": "sql datasource dialect: sqlite (default) | mysql",
    "DB_HOST": "sql host (mysql), or with DB_NAME set, the sql datasource is wired",
    "DB_PORT": "sql port (mysql default 3306)",
    "DB_NAME": "sql database: a sqlite file (:memory: allowed) or a mysql schema",
    "DB_USER": "sql user (mysql)",
    "DB_PASSWORD": "sql password (mysql)",
    "REDIS_HOST": "redis host (set: the redis datasource is wired)",
    "REDIS_PORT": "redis port (default 6379)",
    "BATCH_COHORT": "'off': FIFO mixed-length prefill batches (default: per-bucket cohorts)",
    "OPENAI_ACCEPT_UNKNOWN_MODEL": "'on': an unknown \"model\" serves the base model, not a 404",
    "TORCH_DEVICE": "'cuda' (default) or 'cpu'",
    "APP_NAME": "service name stamped on traces",
    "LOG_LEVEL": "DEBUG | INFO (default) | NOTICE | WARN | ERROR | FATAL",
    "HANDLER_THREADS": "sync handler thread-pool size (default 64)",
    "TPU_ENABLED": "true: build the device even without MODEL_NAME (it serves mlp)",
    "TPU_BOOT": "'background': boot the device off-thread, readiness 503 until ready",
    "ECHO_STEP_MS": "the echo runner's delay a decode step (and a prefill)",
    "SPEC_FAKE_ACCEPT": "echo runner only: cyclic per-cycle accept counts, e.g. 3,1,0",
    "METRICS_MAX_SERIES": "label-sets any one metric may mint (default 1000)",
    "METRICS_EXEMPLARS": "'off': no trace_id exemplars in OpenMetrics",
    "TRACER_HOST": "zipkin collector host (set: spans are exported)",
    "TRACER_PORT": "zipkin collector port (default 9411)",
    "FLIGHT_RECORDER_SIZE": "finished flight records kept (default 512)",
    "FLIGHT_RECORDER_KEEP": "slow or errored records kept past the ring (default 128)",
    "FLIGHT_SLOW_MS": "a request this slow (duration or TTFT) is slow (default 2000)",
    "TENANT_LEDGER_SIZE": "tenants the usage ledger tracks exactly (default 256)",
    "PROFILE_DIR": "where /admin/profiler/start writes its trace (default a temp dir)",
    "DISPATCH_TIMELINE_SIZE": "dispatch records /admin/dispatches keeps (default 512)",
    "WATCHDOG_DISPATCH_TIMEOUT_S": "stall deadline of a watched wait (default 120 on cuda, off on cpu)",
    "COSTMODEL": "'off': no dispatch cost model, /admin/costmodel or anomalies",
    "COSTMODEL_PROFILE": "cost-profile JSON (default gofr_tpu_torch/tpu/cost_profile.json)",
    "COSTMODEL_ANOMALY_FACTOR": "observed/predicted that flags a slow dispatch (default 4)",
    "COSTMODEL_MIN_ANOMALY_MS": "least excess over the prediction an anomaly needs (default 50)",
    "COSTMODEL_EMA_ALPHA": "residual EMA weight (default 0.2)",
    "COSTMODEL_EMA_BAND": "residual EMA that flags a family's drift (default 2.5)",
    "ANOMALY_RING_SIZE": "anomaly events /admin/anomalies keeps (default 256)",
    "REQUEST_DEADLINE_S": "default end-to-end request deadline in seconds (0 = none)",
    "PRIORITY_DEFAULT": "shed tier of a request without X-Priority (0-9, default 5)",
    "BROWNOUT_QUEUE_DEPTH": "queue depth that arms brownout level 1 (2x: level 2; 0 = off)",
    "BROWNOUT_KV_UTIL": "committed KV fraction that arms brownout level 1 (0 = off)",
    "BROWNOUT_SHED_PRIORITY": "brownout tier boundary: level 1 sheds below, level 2 at or below",
    "BROWNOUT_CLAMP_TOKENS": "max_tokens clamp at brownout level 2 (0 = off)",
    "TIMEBASE_ENABLED": "'off': no metric history sampler",
    "TIMEBASE_INTERVAL_S": "seconds between metric snapshots (default 5)",
    "TIMEBASE_WINDOW_S": "seconds of metric history kept (default 900)",
    "POSTMORTEM_DIR": "postmortem bundle directory (set: crash hooks armed too)",
    "POSTMORTEM_KEEP": "postmortem bundles kept (default 20)",
    "POSTMORTEM_MIN_INTERVAL_S": "least seconds between automatic bundles (default 30)",
    "POSTMORTEM_SNAPSHOTS": "timebase snapshots a bundle carries (default 60)",
    "SLO": "'off': no SLO engine",
    "SLO_TARGETS": "objectives: [scope:]metric=target clauses joined by ';'",
    "SLO_BURN_FAST_S": "fast burn window, short (default 300)",
    "SLO_BURN_FAST_LONG_S": "fast burn window, long (default 3600)",
    "SLO_BURN_FAST_RATE": "fast burn page threshold (default 14.4)",
    "SLO_BURN_SLOW_S": "slow burn window, short (default 21600)",
    "SLO_BURN_SLOW_LONG_S": "slow burn window, long, and the budget window (default 259200)",
    "SLO_BURN_SLOW_RATE": "slow burn ticket threshold (default 6)",
    "SLO_EVAL_INTERVAL_S": "seconds between SLO evaluations (default 15)",
    "RECOVERY_ENABLED": "'off': a wedge is observed only, never rebuilt",
    "RECOVERY_MAX_ATTEMPTS": "rebuilds an incident tries before failed (default 3)",
    "RECOVERY_BACKOFF_S": "backoff after a failed rebuild, doubling (default 1)",
    "RECOVERY_BACKOFF_MAX_S": "backoff cap (default 30)",
    "RECOVERY_ATTEMPT_TIMEOUT_S": "a rebuild running longer is hung: failed (default 300)",
    "JOURNAL": "'off': no generation journal (streams cannot resume)",
    "JOURNAL_CAPACITY": "interrupted generations the journal keeps (default 256)",
    "JOURNAL_MAX_TOKENS": "ids one journal entry records (default 8192)",
    "JOURNAL_DIR": "write-ahead log directory of the journal (unset: in memory)",
    "JOURNAL_FSYNC": "WAL durability: interrupt (default) | always | off",
    "JOURNAL_SEGMENT_BYTES": "WAL segment size before rotation (default 1 MiB)",
    "JOURNAL_SEGMENTS": "WAL segments kept (default 4)",
    "KV_HBM_BUDGET_MB": "paged KV arena size in device MiB (0 = auto; KV_BLOCKS wins)",
    "KV_TRANSFER": "'off': serve and pull no KV across replicas (default on)",
    "KV_TRANSFER_TIMEOUT_S": "one KV pull's budget, and the export's default deadline (default 2)",
    "KV_TRANSFER_PIN_TTL_S": "longest an export pins blocks if its thread dies (default 60)",
    "KV_TRANSFER_TRUST_HINT": "'on': act on the router's X-KV-Donor hint (trusted front door only)",
    "FLEET_TRACE_SCRAPE_TIMEOUT_S": "per-replica budget of /admin/fleet/trace's scrapes (default 1)",
    "FLEET_REPLICAS": "router: replica base URLs, [name=]url comma-separated",
    "FLEET_ROUTES": "router: forwarded 'METHOD /path' pairs (default the serving surface)",
    "FLEET_ROUTER_ID": "router: this instance's id on /admin/fleet and X-Gofr-Hop",
    "FLEET_RETRIES": "router: retries of a failed forward (default 2)",
    "FLEET_DEADLINE_S": "router: a request's budget across attempts (default 30)",
    "FLEET_CONNECT_TIMEOUT_S": "router: connect timeout to a replica (default 2)",
    "FLEET_READ_TIMEOUT_S": "router: read timeout from a replica (default 30)",
    "FLEET_AFFINITY": "router: 'off': least-outstanding routing only (default on)",
    "FLEET_AFFINITY_MAX_SKEW": "router: outstanding skew affinity tolerates (default 4)",
    "FLEET_PROBE_INTERVAL_S": "router: seconds between readiness probes (default 1)",
    "FLEET_PROBE_TIMEOUT_S": "router: a probe's timeout (default 1)",
    "FLEET_PROBE_HEDGE_MS": "router: hedge a probe slower than this (0 = off)",
    "FLEET_PROBE_JITTER": "router: per-replica probe jitter, a fraction of the interval (default 0.2)",
    "FLEET_OUT_AFTER": "router: failed probes that take a replica out (default 2)",
    "FLEET_PROBATION_PROBES": "router: good probes a returning replica needs (default 3)",
    "FLEET_BREAKER_THRESHOLD": "router: failures that open a replica's breaker (default 5)",
    "FLEET_BREAKER_COOLDOWN_S": "router: an open breaker's cooldown (default 5)",
    "FLEET_QUOTA_RPS": "router: per-tenant requests a second (0 = off)",
    "FLEET_QUOTA_BURST": "router: per-tenant burst (default 2x rps)",
    "FLEET_QUOTA_CACHE_TTL_S": "router: lease cache over a shared quota bucket (default 0.05)",
    "FLEET_TRUST_TENANT_HEADER": "'on': X-Tenant names the tenant (behind an authenticating gateway)",
    "FLEET_MAX_INFLIGHT": "router: requests in flight before sheds (default 256)",
    "FLEET_SATURATION_QUEUE": "router: replica queue depth that saturates it (default 64)",
    "FLEET_RETRY_AFTER_S": "router: Retry-After of a shed (default 1)",
    "FLEET_DRAIN_TIMEOUT_S": "router: the shutdown drain's bound (default 10)",
    "FLEET_RESUME": "router: 'off': a stream cut mid-body is not resumed (default on)",
    "FLEET_MAX_RESUMES": "router: resumes of one stream (default 4)",
    "FLEET_ROLE": "replica role advertised to the router: prefill | decode | mixed (default)",
    "FLEET_ROLE_ROUTING": "router: 'off': ignore replica roles, stamp no X-KV-Donor (default on)",
}

# The reference's keys the port does not honor yet: key -> (refuse, why,
# with the ROADMAP item that ports it). ``refuse``: ignoring the key would
# change the answers, the topology, a durability guarantee or the memory
# the process takes, so a boot with it set fails; the others warn.
_MESH = "§A7: the port serves on one device, unsharded"
_MULTIHOST = "§A7: the port runs one process, no multi-host runtime"
_TOOLING = "§A6: the port has no native tokenizer backend or lock sanitizer"
UNHONORED_KEYS: dict[str, tuple[bool, str]] = {
    "TPU_MESH": (True, _MESH),
    "TPU_TOPOLOGY": (True, _MESH),
    "TPU_COORDINATOR": (True, _MULTIHOST),
    "TPU_NUM_PROCESSES": (True, _MULTIHOST),
    "TPU_PROCESS_ID": (True, _MULTIHOST),
    "MODEL_ATTN_IMPL": (False, "§B: every attention call runs the port's own kernels"),
    "COSTMODEL_HLO": (False, "§C: the port compiles no HLO; its cost sheets are analytic"),
    "GOFR_NATIVE_LIB": (False, _TOOLING),
    "GOFR_NATIVE_CACHE": (False, _TOOLING),
    "GOFR_NATIVE_DISABLE": (False, _TOOLING),
    "GOFR_POOL_DEBUG": (False, _TOOLING),
    "GOFR_SANITIZE": (False, _TOOLING),
    "GOFR_SANITIZE_ALL": (False, _TOOLING),
    "GOFR_SANITIZE_HOLD_MS": (False, _TOOLING),
    "GOFR_SANITIZE_REPORT": (False, _TOOLING),
    "GOFR_SANITIZE_GRAPH": (False, _TOOLING),
}


def parse_env_file(path: str) -> dict[str, str]:
    """Parse a dotenv file: KEY=VALUE lines, ``#`` comments, optional
    quotes, ``export`` prefix tolerated. A missing file is empty."""
    out: dict[str, str] = {}
    try:
        with open(path, "r", encoding="utf-8") as f:
            lines = f.readlines()
    except OSError:
        return out
    for raw in lines:
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("export "):
            line = line[len("export "):].lstrip()
        if "=" not in line:
            continue
        key, _, value = line.partition("=")
        key, value = key.strip(), value.strip()
        if not key:
            continue
        if value[:1] in ("'", '"'):
            closing = value.find(value[0], 1)
            value = value[1:closing] if closing != -1 else value[1:]
        elif " #" in value:
            value = value.split(" #", 1)[0].rstrip()
        out[key] = value
    return out


class EnvFileConfig:
    """Loads ``<configs_dir>/.env`` into a private map; the environment
    wins over the file."""

    def __init__(self, configs_dir: str = "./configs") -> None:
        self.configs_dir = configs_dir
        self._file = parse_env_file(os.path.join(configs_dir, ".env"))

    def get(self, key: str) -> Optional[str]:
        if key not in DECLARED_KEYS:
            raise KeyError(f"config key {key!r} is not read by gofr_tpu_torch")
        value = os.environ.get(key)
        return value if value is not None else self._file.get(key)

    def get_or_default(self, key: str, default: str) -> str:
        value = self.get(key)
        return value if value not in (None, "") else default

    def unhonored(self) -> list[str]:
        """The listed keys set (non-empty) in the environment or the file."""
        return [
            key for key in UNHONORED_KEYS
            if os.environ.get(key) or self._file.get(key)
        ]


def check_unhonored(config: EnvFileConfig, logger: Any) -> None:
    """Refuse a boot with a set key the port cannot ignore; warn once
    about each other set key of the reference's the port does not honor."""
    set_keys = config.unhonored()
    refused = [key for key in set_keys if UNHONORED_KEYS[key][0]]
    if refused:
        raise ValueError(
            "gofr_tpu_torch does not honor "
            + "; ".join(f"{key} ({UNHONORED_KEYS[key][1]})" for key in refused)
            + " — unset it to boot"
        )
    for key in set_keys:
        logger.warnf(
            "%s is set but gofr_tpu_torch does not honor it yet (ROADMAP %s)",
            key, UNHONORED_KEYS[key][1],
        )
