"""Batched fp32 geometry on (x, y) points and (..., 3, 3) affines, and the
template viewpoint tables (numpy).

Re-exports the names picopose_tpu/geom/__init__.py does, each imported
from its module at first use, so that the host-only users of
``geom.templates`` (the template renderer) do not import torch.
"""

_EXPORTS = {
    **dict.fromkeys((
        "apply_affine", "compose_affine", "homogenize", "inverse_crop_affine", "make_affine",
        "normalize_affine", "relative_affine", "relative_scale_inplane", "affine_from_prediction",
        "gt_translation_scale_inplane",
    ), "affine"),
    **dict.fromkeys(("depth_to_points", "project_points", "unproject_points"), "projection"),
    **dict.fromkeys(("cos_sin", "geodesic_distance", "inplane_angle_zxy", "rotation_2d"), "rotation"),
    "pose_from_affine_2d": "pose2d",
    **dict.fromkeys(
        ("icosphere_cam_positions", "look_at_opengl", "opencv_from_opengl", "template_object_poses"), "templates"
    ),
    **dict.fromkeys(("patch_center_grid", "pixel_coords_grid"), "grids"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
