"""Waymo semantic taxonomy, palette mapping and colorization; the port's
copy of ``infinicube_tpu/utils/semantic.py`` (numpy): the 23-class Waymo
Open Dataset segmentation taxonomy, a 10-entry visualization palette
grouping (matplotlib's colormaps where matplotlib is installed, a fixed
table otherwise, as the reference), and instance-aware recoloring of car
pixels.
"""

from __future__ import annotations

import numpy as np

WAYMO_CATEGORY_NAMES = [
    "UNDEFINED", "CAR", "TRUCK", "BUS", "OTHER_VEHICLE", "MOTORCYCLIST",
    "BICYCLIST", "PEDESTRIAN", "SIGN", "TRAFFIC_LIGHT", "POLE",
    "CONSTRUCTION_CONE", "BICYCLE", "MOTORCYCLE", "BUILDING", "VEGETATION",
    "TREE_TRUNK", "CURB", "ROAD", "LANE_MARKER", "OTHER_GROUND", "WALKABLE",
    "SIDEWALK",
]
NUM_CLASSES = len(WAYMO_CATEGORY_NAMES)  # 23

CAR_LIKE = ("CAR", "TRUCK", "BUS", "OTHER_VEHICLE")
CAR_LIKE_IDS = tuple(WAYMO_CATEGORY_NAMES.index(n) for n in CAR_LIKE)

# palette grouping: visualization buckets -> member classes
_PALETTE_GROUPS = {
    0: ["SIGN", "TRAFFIC_LIGHT", "CONSTRUCTION_CONE"],
    1: ["MOTORCYCLIST", "BICYCLIST", "PEDESTRIAN", "BICYCLE", "MOTORCYCLE"],
    2: ["WALKABLE", "SIDEWALK"],
    3: ["CAR", "TRUCK", "BUS", "OTHER_VEHICLE"],
    4: ["VEGETATION", "TREE_TRUNK"],
    5: ["CURB", "LANE_MARKER"],
    6: ["BUILDING"],
    7: ["ROAD", "OTHER_GROUND"],
    8: ["UNDEFINED"],
    9: ["POLE"],
}


def _build_mapping_and_palette():
    mapping = np.zeros(NUM_CLASSES, dtype=np.int32)
    for pal_idx, names in _PALETTE_GROUPS.items():
        for n in names:
            mapping[WAYMO_CATEGORY_NAMES.index(n)] = pal_idx
    try:
        from matplotlib import colormaps
        set2 = np.array(colormaps["Set2"].colors, np.float32)
        set3 = np.array(colormaps["Set3"].colors, np.float32)
        set1 = np.array(colormaps["Set1"].colors, np.float32)
        paired = np.array(colormaps["Paired"].colors, np.float32)
        palette = np.zeros((10, 3), np.float32)
        palette[:8] = set2[:8]
        palette[3] = set3[9]
        palette[4] = set1[2]
        palette[8] = paired[1]
        palette[9] = set3[10]
    except Exception:  # matplotlib-free fallback
        palette = np.array([
            [0.40, 0.76, 0.65], [0.99, 0.55, 0.38], [0.55, 0.63, 0.80],
            [0.74, 0.50, 0.74], [0.30, 0.69, 0.29], [1.00, 0.85, 0.18],
            [0.90, 0.77, 0.58], [0.70, 0.70, 0.70], [0.12, 0.47, 0.71],
            [0.80, 0.92, 0.77]], np.float32)
    return mapping, palette


WAYMO_MAPPING, WAYMO_PALETTE = _build_mapping_and_palette()


def semantic_to_color(semantics: np.ndarray) -> np.ndarray:
    """int class ids (...,) -> float RGB (..., 3) in [0, 1]."""
    semantics = np.asarray(semantics)
    return WAYMO_PALETTE[WAYMO_MAPPING[np.clip(semantics, 0, NUM_CLASSES - 1)]]


def instance_colors(instance_ids: np.ndarray, seed: int = 0) -> np.ndarray:
    """Stable pseudo-random distinct color per instance id (...,) ->
    (..., 3)."""
    ids = np.asarray(instance_ids).astype(np.int64)
    h = (ids * 2654435761 + seed * 97) % (2 ** 31)
    rng_r = ((h >> 0) & 255) / 255.0
    rng_g = ((h >> 8) & 255) / 255.0
    rng_b = ((h >> 16) & 255) / 255.0
    c = np.stack([rng_r, rng_g, rng_b], axis=-1).astype(np.float32)
    return 0.25 + 0.7 * c  # keep away from black/white


def generate_rgb_semantic_buffer(semantic_buffer: np.ndarray,
                                 instance_buffer: np.ndarray) -> np.ndarray:
    """Colorize a semantic buffer, giving each car instance a distinct
    color.

    semantic_buffer int (..., H, W); instance_buffer int (..., H, W).
    Returns float32 (..., H, W, 3) in [0, 1]."""
    rgb = semantic_to_color(semantic_buffer)
    inst = np.asarray(instance_buffer)
    car_mask = inst > 0
    if car_mask.any():
        rgb = rgb.copy()
        rgb[car_mask] = instance_colors(inst[car_mask])
    return rgb
