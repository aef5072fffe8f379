"""Orbit cameras and look-at extrinsics for the preview renderer.

Counterpart of ``actionmesh_tpu/render/cameras.py``: cameras orbit the
origin at distance 3.0 with the elevation cycle [70, 55, 85, 40] and focal
2.1875 (the reference's pytorch3d conventions).
"""

from __future__ import annotations

import numpy as np

DEFAULT_DISTANCE = 3.0
DEFAULT_FOCAL = 2.1875
ELEVATION_CYCLE = (70.0, 55.0, 85.0, 40.0)


def location_to_extrinsic(
    cam_location: np.ndarray, target: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Look-at extrinsics: returns (R (3,3), t (3,)) world->camera.

    Camera looks at `target` (default origin), up = +z world.
    """
    if target is None:
        target = np.zeros(3)
    forward = target - cam_location
    forward = forward / np.linalg.norm(forward)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(forward, up)) > 0.999:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, forward)
    R = np.stack([right, true_up, forward])  # rows: camera axes in world
    t = -R @ cam_location
    return R, t


def orbit_location(
    azimuth_deg: float, elevation_deg: float, distance: float = DEFAULT_DISTANCE
) -> np.ndarray:
    az = np.deg2rad(azimuth_deg)
    el = np.deg2rad(elevation_deg)
    return distance * np.array(
        [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)]
    )


def get_uniform_cameras(
    n_views: int = 3,
    distance: float = DEFAULT_DISTANCE,
    focal: float = DEFAULT_FOCAL,
) -> list[dict]:
    """n_views cameras uniformly spaced in azimuth, cycling elevations."""
    cams = []
    for i in range(n_views):
        azim = 360.0 * i / n_views
        elev = 90.0 - ELEVATION_CYCLE[i % len(ELEVATION_CYCLE)]
        loc = orbit_location(azim, elev, distance)
        R, t = location_to_extrinsic(loc)
        cams.append({"R": R, "t": t, "focal": focal, "location": loc})
    return cams
