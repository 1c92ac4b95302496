"""Tensor ops; the kernel-backed ones dispatch on the tensor's device.

Re-exports the names picopose_tpu/ops/__init__.py does, each imported
from its module at first use, so that importing one op module does not
import them all.
"""

_EXPORTS = {
    "avg_pool2d": "resize",
    "resize_bilinear": "resize",
    "resize_nearest": "resize",
    "bilinear_sample": "sample",
    "warp_by_flow": "sample",
    "feature_similarity_volume": "matching",
    "match_templates": "matching",
    "correlation_pyramid": "corr",
    "corr_lookup": "corr",
    "preprocess_frame": "preprocess",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
