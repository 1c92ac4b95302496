"""Neural stages of PicoPose as torch.nn modules (NHWC at public methods)."""

from picopose_tpu_torch.models.picopose import PicoPose

__all__ = ["PicoPose"]
