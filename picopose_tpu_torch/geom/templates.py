"""Template viewpoint tables: icosphere camera positions and object poses.

The port's own copy of picopose_tpu/geom/templates.py: ``_icosahedron``,
``_subdivide``, ``icosphere_cam_positions``, ``look_at_opengl``,
``template_camera_poses``, ``template_object_poses`` (:25-170) and
``load_pose_table``, the same numpy arithmetic, so the tables are equal
bit for bit.  They regenerate the reference's pose tables
(utils/predefined_poses/{cam,obj}_poses_levelN.npy): a Blender-oriented
icosahedron subdivided ``level + 1`` times (42/162/642 views), vertices
sorted by (elevation rounded to 1e-6 rad, azimuth), cameras looking at the
origin with up-hint (0, 0, -1), object poses their inverses.  Within a
ring the order is this module's own, not Blender's: banks rendered by the
reference toolchain carry their own table (``load_pose_table``).
``MegaPoseTrainingDataset`` picks training templates from level 1.
"""

from __future__ import annotations

import functools

import numpy as np


def _icosahedron() -> tuple[np.ndarray, np.ndarray]:
    """Regular icosahedron in Blender's orientation, with exact trig coords.

    Poles on +-z; lower ring (z = -1/sqrt(5)) at azimuths -36 - 72k degrees,
    upper ring (z = +1/sqrt(5)) at -72 - 72k degrees (atan2(y, x) convention).
    Exact coordinates matter: band-edge midpoints must cancel to exactly
    z == 0 so the (elevation, azimuth) sort breaks ties the same way as the
    reference tables.
    """
    r, z = 2.0 / np.sqrt(5.0), 1.0 / np.sqrt(5.0)
    lower_az = np.deg2rad(-36.0 - 72.0 * np.arange(5))
    upper_az = np.deg2rad(-72.0 - 72.0 * np.arange(5))
    lower_v = np.stack([r * np.cos(lower_az), r * np.sin(lower_az), -z * np.ones(5)], 1)
    upper_v = np.stack([r * np.cos(upper_az), r * np.sin(upper_az), z * np.ones(5)], 1)
    verts = np.concatenate(
        [np.array([[0.0, 0.0, -1.0]]), lower_v, upper_v, np.array([[0.0, 0.0, 1.0]])]
    )
    lower, upper = np.arange(1, 6), np.arange(6, 11)
    faces = []
    for i in range(5):
        j = (i + 1) % 5
        faces.append([0, lower[j], lower[i]])                      # bottom cap
        faces.append([lower[i], lower[j], upper[i]])               # lower band
        faces.append([lower[j], upper[j], upper[i]])               # upper band
        faces.append([11, upper[i], upper[j]])                     # top cap
    return verts, np.array(faces)


def _subdivide(verts: np.ndarray, faces: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One round of midpoint subdivision, re-projected onto the unit sphere."""
    verts = list(verts)
    midpoint_cache: dict[tuple[int, int], int] = {}

    def midpoint(a: int, b: int) -> int:
        key = (min(a, b), max(a, b))
        if key not in midpoint_cache:
            m = verts[a] + verts[b]
            m = m / np.linalg.norm(m)
            midpoint_cache[key] = len(verts)
            verts.append(m)
        return midpoint_cache[key]

    new_faces = []
    for a, b, c in faces:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
    return np.array(verts), np.array(new_faces)


@functools.lru_cache(maxsize=None)
def icosphere_cam_positions(level: int, radius: float = 1000.0) -> np.ndarray:
    """(N, 3) camera positions for level 0/1/2 -> 42/162/642 views, sorted by
    (elevation, azimuth) exactly like the reference tables."""
    verts, faces = _icosahedron()
    # Blender's default icosphere (42 verts) is one midpoint subdivision of
    # the icosahedron; each level adds one more.
    for _ in range(level + 1):
        verts, faces = _subdivide(verts, faces)
    az = np.arctan2(verts[:, 0], verts[:, 1])
    el = np.arctan2(verts[:, 2], np.hypot(verts[:, 0], verts[:, 1]))
    order = np.lexsort((az, el.round(6)))
    return verts[order] * radius


def look_at_opengl(cam_location: np.ndarray, point: np.ndarray) -> np.ndarray:
    """Camera-to-world pose with +z forward (toward `point`).

    Matches rendering/src/lib3d/create_template_poses.py:76-103: columns are
    (right, up, forward, location), up-hint (0, 0, -1) with a (0, -1, 0)
    fallback when looking straight along z.
    """
    forward = point - cam_location
    forward = forward / np.linalg.norm(forward)
    tmp = np.array([0.0, 0.0, -1.0])
    if min(
        np.linalg.norm(cam_location - tmp), np.linalg.norm(cam_location + tmp)
    ) < 1e-3 or np.linalg.norm(np.cross(tmp, forward)) < 1e-8:
        tmp = np.array([0.0, -1.0, 0.0])
    right = np.cross(tmp, forward)
    right = right / np.linalg.norm(right)
    up = np.cross(forward, right)
    up = up / np.linalg.norm(up)
    mat = np.eye(4)
    mat[:3, 0], mat[:3, 1], mat[:3, 2], mat[:3, 3] = right, up, forward, cam_location
    return mat


@functools.lru_cache(maxsize=None)
def template_camera_poses(level: int, radius: float = 1000.0) -> np.ndarray:
    """(N, 4, 4) camera-to-world poses, byte-identical (to fp tolerance) with
    the reference's cam_poses_levelN.npy."""
    positions = icosphere_cam_positions(level, radius)
    return np.stack([look_at_opengl(p, np.zeros(3)) for p in positions])


@functools.lru_cache(maxsize=None)
def template_object_poses(level: int, radius: float = 1000.0) -> np.ndarray:
    """(N, 4, 4) object poses = inverse camera poses; equals the reference's
    obj_poses_levelN.npy (verified inverse relation in tests).

    These are what utils/template_utils.py:114-133 loads with
    pose_distribution='all'; translations are in the same unit as `radius`
    (reference uses mm at radius 1000, rescaled per object by diameter at
    rendering/scripts/render_bop_templates.py:104-115).
    """
    return np.linalg.inv(template_camera_poses(level, radius))


def load_pose_table(path: str) -> np.ndarray:
    """Load an external (N, 4, 4) object-pose table (.npy).

    Accepts the reference's utils/predefined_poses/obj_poses_levelN.npy or a
    template bank's object_poses/*.npy — use this when working with banks
    rendered by the reference toolchain, whose view order is Blender-specific
    (see module docstring).
    """
    table = np.load(path)
    if table.ndim != 3 or table.shape[-2:] != (4, 4):
        raise ValueError(f"pose table {path} must be (N, 4, 4), got {table.shape}")
    return table
