"""Compute ops: RMSNorm, RoPE, attention (flash kernel on CUDA), sampling.

``__all__`` names the counterparts of ``gofr_tpu.ops``' exports, under
the same names."""

from gofr_tpu_torch.ops.attention import attention
from gofr_tpu_torch.ops.norms import layer_norm, rms_norm
from gofr_tpu_torch.ops.rope import apply_rope, rope_frequencies

__all__ = ["attention", "rms_norm", "layer_norm", "apply_rope", "rope_frequencies"]
