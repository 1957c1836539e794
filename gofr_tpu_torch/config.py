"""Config: the process environment over ``<configs_dir>/.env``.

Trimmed copy of ``gofr_tpu/config.py``'s ``EnvFileConfig``. The port
reads only the keys in ``DECLARED_KEYS``; asking for any other raises, so
a key the port does not honor cannot be read by mistake.
"""

from __future__ import annotations

import os
from typing import Optional

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
    "TORCH_DEVICE": "'cuda' (default) or 'cpu'",
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
