"""Training for gofr_tpu_torch: loss, AdamW, data and checkpoints (port of
``gofr_tpu/training``)."""
