"""Fixtures of the benchmark's own tests: a copy of the benchmark in a
temporary checkout with a tiny cell dropped in as files (its
configuration, mix and limits, and entries in ``BENCHMARK.json``), and the
look for a card, made inside a fixture.

    python -m pytest portbench/tests -q            # here: card tests skip
    python -m pytest portbench/tests -q -m cuda    # on the card
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

SERVING = {"DECODE_CHUNK": 4, "BATCH_MAX_SIZE": 4, "BATCH_TIMEOUT_MS": 5,
           "PREFILL_CHUNK_TOKENS": 64, "PREFIX_CACHE": 8, "PREFIX_LCP_MIN": 16,
           "DECODE_SLOTS": 4, "MODEL_MAX_SEQ": 256, "MODEL_BUCKETS": "16,32,64,128,256"}
MIXES = {
    "open": {"kind": "open_poisson", "rate_per_s": 4, "warm_s": 1,
             "prompt": {"median": 60, "sigma": 0.5, "min": 16, "max": 180},
             "output": {"min": 2, "max": 6}, "check_tokens": 24, "schedule_seed": 1,
             "serving": SERVING},
    "closed": {"kind": "closed_sessions", "workers": 3, "questions": 3, "sessions_per_worker": 8,
               "warm_s": 1, "document": {"min": 100, "max": 160}, "question": {"min": 8, "max": 24},
               "output": {"min": 2, "max": 6}, "check_tokens": 24, "schedule_seed": 1,
               "serving": SERVING},
    "train": {"kind": "train_packed", "batch": 2, "seq": 33, "eos": 2,
              "document": {"median": 12, "sigma": 1.0, "min": 2, "max": 64}, "lr": 3e-4,
              "checked_steps": 2, "warm_steps": 1},
}
# float32 products on the CPU: the program and the reference agree to
# rounding (about 2e-6 in a logprob), and the float8 control reads 0.1 or more
TINY_LIMITS = {"token_gap": 1e-3, "logprob_err": 1e-3}
# training: the program's float32 step and the reference's agree to about
# 1e-7 in a loss and 1e-5 in a leaf's change; the float8 control reads 3e-3
# and more
TINY_TRAIN_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3}


def tiny_config(kv_heads: int = 2) -> dict:
    return {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
            "num_attention_heads": 4, "num_key_value_heads": kv_heads, "vocab_size": 512,
            "max_position_embeddings": 256, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
            "torch_dtype": "float32", "reference": "decoder"}


def make_checkout(tmp: Path, mix: str = "open", kv_heads: int = 2, cell: str = "tiny.cell",
                  metric: "str | None" = None, metric_source: str = "") -> Path:
    """A checkout holding a copy of the benchmark and, as new files only, a
    tiny configuration, a mix, the cell's limits, and optionally a metric."""
    root = tmp / "checkout"
    shutil.copytree(BENCH, root / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    b = root / BENCH.name
    (b / "configs" / "tiny.json").write_text(json.dumps(tiny_config(kv_heads)))
    (b / "traffic" / "tinymix.json").write_text(json.dumps(MIXES[mix]))
    limits = TINY_TRAIN_LIMITS if mix == "train" else TINY_LIMITS
    (b / "limits" / f"{cell}.json").write_text(json.dumps({"limits": limits}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "test", "reduced": [], "why": "test",
                             "file": f"{BENCH.name}/configs/tiny.json"})
    bench["workloads"].append({"name": cell, "config": "tiny", "traffic": "tinymix",
                               "chips": 1, "why": "test"})
    wanted = ("train_tokens_per_s",) if mix == "train" else ("tpot_p50_ms",)
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] in wanted:
            m["workloads"].append(cell)
    if metric:
        (b / "metrics" / f"{metric}.py").write_text(metric_source)
        bench["per_layer"].append({"name": metric, "unit": "%", "better": "higher",
                                   "source": "program_counter", "layer": "test",
                                   "moves": "tpot_p50_ms", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def card():
    """Skip unless a CUDA card is visible (decided here, at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.cuda.get_device_name(0)
