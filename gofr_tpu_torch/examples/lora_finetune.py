"""LoRA fine-tuning CLI (copy of ``examples/lora-finetune/main.py``):
adapter-only training through the framework's CMD transport.

    python -m gofr_tpu_torch.examples.lora_finetune finetune --model=tiny \
        --base=/ckpts/pretrained --data=/path/tokens.bin --steps=50 --rank=8 \
        --out=/tmp/lora_out

Trains rank-``--rank`` adapters over a frozen base with Adam (lr 1e-3):
``--base`` restores a ``training/checkpoint.py`` checkpoint (a seeded init
without it, for smoke runs), ``--quant`` packs it int8/int4 first (QLoRA),
``--data`` reads a token file (without it, a repeating ramp the adapters
can memorize). Each step's loss and time go to the framework logger. It
writes the MERGED weights as a checkpoint that serving loads through
``MODEL_PATH``. It runs on ``cuda`` unless ``TORCH_DEVICE=cpu``.
"""

import time

import gofr_tpu_torch


def finetune(ctx):
    import numpy as np
    import torch

    from gofr_tpu_torch.models.llama import CONFIGS
    from gofr_tpu_torch.models.lora import (
        add_lora,
        init_lora_train_state,
        make_lora_train_step,
        merge_lora,
    )
    from gofr_tpu_torch.models.transformer import Transformer
    from gofr_tpu_torch.training import optim
    from gofr_tpu_torch.training.checkpoint import save_params
    from gofr_tpu_torch.training.data import TokenDataset

    model = ctx.param("model") or "tiny"
    steps = int(ctx.param("steps") or 20)
    if steps < 1:
        raise ValueError("--steps must be >= 1")
    rank = int(ctx.param("rank") or 8)
    out = ctx.param("out") or "/tmp/gofr_lora_out"
    data = ctx.param("data")
    base = ctx.param("base")  # pretrained checkpoint to fine-tune
    quant = ctx.param("quant") or ""  # "int8"/"int4" -> QLoRA
    device = torch.device(ctx.config.get_or_default("TORCH_DEVICE", "cuda"))

    cfg = CONFIGS[model]
    if base:
        from gofr_tpu_torch.training.checkpoint import restore_params

        params = Transformer(cfg, device)
        params.load_state_dict(restore_params(base, device))
    else:
        params = Transformer.random(cfg, device, seed=0)
    if quant:
        params = params.quantized(quant)
    wrapped = add_lora(params, seed=1, rank=rank)

    if data:
        ds = TokenDataset(data, seq_len=64, batch_size=4)
        batches = ds.batches(0)
    else:  # demo corpus: a repeating ramp the adapters can memorize
        tokens = np.arange(4000) % min(cfg.vocab_size, 199)

        def gen():
            rng = np.random.RandomState(0)
            while True:
                start = rng.randint(0, len(tokens) - 65 * 4)
                yield tokens[start : start + 65 * 4].reshape(4, 65).astype(np.int32)

        batches = gen()

    # Adam: the port's AdamW without weight decay (optax.adam's update)
    opt = optim.adamw(1e-3, weight_decay=0.0)
    state = init_lora_train_state(wrapped, opt)
    step = make_lora_train_step(cfg, opt)
    first = last = None
    for i, batch in zip(range(steps), batches):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        last = float(metrics["loss"])  # the step's one host sync
        first = first if first is not None else last
        ctx.logger.infof("step %d loss %.4f (%.2f ms)", i, last,
                         (time.perf_counter() - t0) * 1000.0)

    t0 = time.perf_counter()
    merged = merge_lora(state["model"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    merge_s = time.perf_counter() - t0
    del state, wrapped, params
    t0 = time.perf_counter()
    save_params(out, merged.state_dict())
    write_s = time.perf_counter() - t0
    return (
        f"trained {steps} steps (loss {first:.4f} -> {last:.4f}); "
        f"merged in {merge_s:.2f} s, written in {write_s:.2f} s; "
        f"merged checkpoint at {out} (serve with MODEL_PATH={out})"
    )


def build():
    app = gofr_tpu_torch.new_cmd()
    app.sub_command("finetune", finetune)
    return app


def main():
    build().run()


if __name__ == "__main__":
    main()
