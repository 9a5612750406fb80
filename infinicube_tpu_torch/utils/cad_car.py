"""Procedural canonical car model; the port's copy of
``infinicube_tpu/utils/cad_car.py`` (numpy).

One canonical occupancy block on the unit box [-0.5, 0.5]^3, raycast or
splatted per object at a per-object voxel size lwh/dims: no asset file and
no per-frame scene rebuild. The car is a two-box sedan silhouette (body +
cabin with sloped windshields and wheel cutouts).

Canonical frame: x = length (forward), y = width (left), z = height (up),
box spans [-0.5, 0.5] in every axis before lwh scaling."""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=4)
def canonical_car_occupancy(dims: tuple[int, int, int] = (32, 16, 16)
                            ) -> np.ndarray:
    """bool [Dx, Dy, Dz] occupancy of the canonical car on [-0.5, 0.5]^3."""
    dx, dy, dz = dims
    x = (np.arange(dx) + 0.5) / dx - 0.5
    y = (np.arange(dy) + 0.5) / dy - 0.5
    z = (np.arange(dz) + 0.5) / dz - 0.5
    X, Y, Z = np.meshgrid(x, y, z, indexing="ij")

    # body: lower slab from wheel-bottom to beltline
    body = (Z >= -0.5) & (Z <= 0.1) & (np.abs(Y) <= 0.5) & (np.abs(X) <= 0.5)
    # nose/tail taper below bumper line
    body &= ~((Z <= -0.3) & (np.abs(X) >= 0.45))
    # cabin: upper slab, shorter, with sloped front/rear windshields
    cabin_half_len = 0.28
    slope = (0.5 - Z) * 0.45  # recedes with height
    cabin = (Z > 0.1) & (np.abs(Y) <= 0.42) & \
        (np.abs(X - 0.02) <= cabin_half_len + slope - 0.18)
    # wheel cutouts: remove low corners between wheels
    wheels = (Z <= -0.28) & (np.abs(np.abs(X) - 0.32) > 0.13)
    return (body & ~wheels) | cabin


def canonical_car_points(dims: tuple[int, int, int] = (32, 16, 16)
                         ) -> np.ndarray:
    """f32 [N, 3] occupied voxel centers of the canonical car on
    [-0.5, 0.5]^3; scale by lwh to get an object's points."""
    occ = canonical_car_occupancy(dims)
    idx = np.argwhere(occ).astype(np.float32)
    return (idx + 0.5) / np.asarray(dims, np.float32) - 0.5
