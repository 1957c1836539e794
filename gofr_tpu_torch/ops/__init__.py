"""Compute ops: RMSNorm, RoPE, attention (flash kernel on CUDA), sampling."""
