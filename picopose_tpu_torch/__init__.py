"""PicoPose in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``picopose_tpu`` that mirrors its layout
(``geom/``, ``ops/``, ``models/``, ``eval/``, ``data/``, ``train/``,
``utils/``) and keeps its layouts at public functions: NHWC features,
(x, y) points, (..., 3, 3) affines.  It imports neither JAX nor anything
of ``picopose_tpu``.

Entry points run on the GPU unless the caller passes ``device="cpu"``; on
the CPU every kernel wrapper uses its plain PyTorch version.
"""

__all__ = ["resolve_device"]


def __getattr__(name: str):
    # imported on first use, so that the host-only entry points
    # (render_templates, score_csv) start without importing torch
    if name == "resolve_device":
        from picopose_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
