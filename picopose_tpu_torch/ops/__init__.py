"""Tensor ops; the kernel-backed ones dispatch on the tensor's device."""
