"""The port's copies of the repo's example binaries, run as modules:

    python -m gofr_tpu_torch.examples.http_server
    python -m gofr_tpu_torch.examples.grpc_server
    python -m gofr_tpu_torch.examples.sample_cmd hello --name=x
    python -m gofr_tpu_torch.examples.lora_finetune finetune --model=tiny --steps=2

Each reads its settings from ``examples/configs/<name>/.env`` under this
package, and the environment wins over the file. They run on ``cuda``
unless ``TORCH_DEVICE=cpu`` asks for the CPU.
"""

import os

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
