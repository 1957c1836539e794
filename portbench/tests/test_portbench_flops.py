"""The frozen operation and byte counts against hand counts."""

from __future__ import annotations

import pytest

from portbench import flops, readings, weights

MISTRAL = {"vocab_size": 32768, "dim": 4096, "n_layers": 32, "n_heads": 32, "n_kv_heads": 8,
           "hidden_dim": 14336}


def test_matmul_params_mistral():
    # per layer: q 4096², k and v 4096·1024, o 4096², three 4096·14336
    layer = 4096 * 4096 * 2 + 2 * 4096 * 1024 + 3 * 4096 * 14336
    assert flops.matmul_params(MISTRAL) == 32 * layer + 4096 * 32768
    # with the embedding: the published 7.25 B
    assert (flops.matmul_params(MISTRAL) + 32768 * 4096) / 1e9 == pytest.approx(7.248, abs=1e-3)


def test_causal_pairs():
    assert flops.causal_pairs(0, 1) == 1
    assert flops.causal_pairs(0, 4) == 1 + 2 + 3 + 4
    assert flops.causal_pairs(10, 2) == 11 + 12
    # slices of 512 add up to the whole prompt's pairs
    calls = flops.prefill_calls(1300, 0, 512)
    assert calls == [(512, 0), (512, 512), (276, 1024)]
    assert sum(flops.causal_pairs(o, r) for r, o in calls) == flops.causal_pairs(0, 1300)


def test_attention_bound_by_hand():
    # one decode row over 1000 keys, 32 q heads, 8 kv heads, D 128, bf16
    s, ops, nbytes = flops.attention_bound_s(1, 999, 32, 8, 128)
    assert ops == 4 * 128 * 32 * 1000
    assert nbytes == 2 * 32 * 128 * 2 + 2 * 1000 * 8 * 128 * 2 + 32 * 4
    assert s == pytest.approx(nbytes / 3.35e12)  # a decode row is bound by bytes
    s, ops, nbytes = flops.attention_bound_s(512, 0, 32, 8, 128)
    assert ops == 4 * 128 * 32 * (512 * 513 // 2)
    assert s == pytest.approx(nbytes / 3.35e12)  # a first 512-row slice: still by bytes
    s, ops, _ = flops.attention_bound_s(512, 2048, 32, 8, 128)
    assert ops == 4 * 128 * 32 * (512 * 2048 + 512 * 513 // 2)
    assert s == pytest.approx(ops / 989e12)  # a later slice by operations


def test_forward_and_train_flops():
    n = flops.matmul_params(MISTRAL)
    attn = 4 * 128 * 32 * flops.causal_pairs(0, 2048) * 32
    assert flops.forward_flops(MISTRAL, 2048, 0) == pytest.approx(2 * n * 2048 + attn)
    t = flops.train_flops(MISTRAL, 4, 2048)
    attn = 12 * 32 * 32 * 128 * 4 * flops.causal_pairs(0, 2048)
    assert t == pytest.approx(6 * n * 4 * 2048 + attn)


def test_request_work_counts_what_the_cache_cannot_skip():
    run = {"model": MISTRAL, "prefill_width": 512}
    first = {"prompt_len": 3500, "tokens": [1, 2, 3], "q": 0, "doc_len": 3300}
    later = dict(first, q=1)
    assert readings.prefill_calls(run, first)[0] == (512, 0)
    assert readings.prefill_calls(run, later) == [(200, 3300)]
    assert list(readings.decode_offsets(first)) == [3500, 3501]
    def prefill_work(r):
        return sum(flops.forward_flops(MISTRAL, rows, off)
                   for rows, off in readings.prefill_calls(run, r))

    assert prefill_work(later) < prefill_work(first) / 10


def test_config_dims():
    import json
    from pathlib import Path

    path = Path(__file__).parent.parent / "configs" / "mistral-7b-v0.3.json"
    cfg = json.loads(path.read_text())
    m = weights.dims(cfg)
    assert {k: m[k] for k in MISTRAL} == MISTRAL


def test_the_window_counts_every_record_by_its_token_times():
    """Work is placed by when it ran, whatever the request: a request sent
    before the trace counts the steps whose tokens came inside it, one
    still in flight at the close counts what came before it, and a prefill
    slice sits at its share of the way from the send to the first token."""
    run = {"model": MISTRAL, "prefill_width": 512,
           "trace": {"start": 10.0, "end": 20.0, "window_s": 10.0}}
    straddles_start = {"prompt_len": 1024, "q": 0, "sent": 8.0, "tokens": [1, 2, 3, 4],
                       "token_times": [9.0, 9.5, 10.5, 11.0]}
    straddles_end = {"prompt_len": 1536, "q": 0, "sent": 17.0, "tokens": [5, 6, 7],
                     "token_times": [20.0, 21.0, 21.0], "status": "no answer"}
    prefill, decode = readings.window_calls({**run, "records": [straddles_start, straddles_end]})
    # the first request's slices sat at 8.5 and 9.0; the second's at 18, 19 and 20
    assert prefill == [(512, 0), (512, 512), (512, 1024)]
    # tokens 2 and 3 of the first (offsets 1025, 1026); none of the second
    assert decode == [(1, 1025), (1, 1026)]
    work = sum(flops.forward_flops(MISTRAL, 1, o) for o in (1025, 1026))
    assert readings.step_mfu({**run, "records": [straddles_start]}) == pytest.approx(
        100 * work / (10 * 989e12))
