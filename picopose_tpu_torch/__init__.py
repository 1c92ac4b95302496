"""PicoPose in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``picopose_tpu`` that mirrors its layout
(``geom/``, ``ops/``, ``models/``, ``eval/``, ``data/``, ``train/``,
``utils/``) and keeps its layouts at public functions: NHWC features,
(x, y) points, (..., 3, 3) affines.  It imports neither JAX nor anything
of ``picopose_tpu``.

Entry points run on the GPU unless the caller passes ``device="cpu"``; on
the CPU every kernel wrapper uses its plain PyTorch version.
"""

from picopose_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
