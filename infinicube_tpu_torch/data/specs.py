"""Batch key vocabulary and collation; counterpart of
``infinicube_tpu/data/specs.py``.

``list_collate`` groups ragged per-sample arrays into lists;
``pad_collate`` pads ragged leading dimensions to a common (or given)
capacity and stacks them, with a mask beside each padded key. Plain
numpy."""

from __future__ import annotations

from enum import Enum

import numpy as np


class DatasetSpec(Enum):
    SHAPE_NAME = 100
    INPUT_PC = 200
    TARGET_NORMAL = 300
    INPUT_COLOR = 350
    INPUT_INTENSITY = 360
    GT_DENSE_PC = 400
    DATASET_CFG = 1000
    GT_DYN_FLAG = 1100
    GT_SEMANTIC = 1200
    LATENT_SEMANTIC = 1300
    SINGLE_SCAN_CROP = 1400
    SINGLE_SCAN = 1450
    CLASS = 1500
    TEXT_EMBEDDING = 1600
    TEXT = 1620
    GRID_TO_FIRST_CAMERA_FLU = 1800
    GRID_CROP_RANGE = 1801
    GRID_TO_WORLD = 1802
    IMAGES_INPUT = 1900
    IMAGES_INPUT_MASK = 1901
    IMAGES_INPUT_POSE = 1910
    IMAGES_INPUT_INTRINSIC = 1917
    IMAGES_INPUT_DEPTH = 1918
    IMAGES = 2000
    IMAGES_MASK = 2001
    IMAGES_POSE = 2010
    IMAGES_INTRINSIC = 2017
    IMAGES_DEPTH_VOXEL = 2054
    MAPS_3D = 2100
    BOXES_3D = 2200


def list_collate(samples: list[dict]) -> dict:
    """Group a list of sample dicts into a dict of lists (MAPS_3D dicts stay
    dicts of lists)."""
    out: dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if key == DatasetSpec.MAPS_3D and isinstance(vals[0], dict):
            out[key] = {k: [v[k] for v in vals] for k in vals[0]}
        else:
            out[key] = vals
    return out


def pad_stack(arrays: list[np.ndarray], capacity: int | None = None,
              fill=0.0):
    """Pad ragged [N_i, ...] arrays to a common capacity and stack; an
    array longer than ``capacity`` keeps its first ``capacity`` rows.
    Returns (stacked [B, C, ...], mask bool [B, C])."""
    n_max = max(a.shape[0] for a in arrays)
    cap = capacity or n_max
    B = len(arrays)
    out = np.full((B, cap) + arrays[0].shape[1:], fill, arrays[0].dtype)
    mask = np.zeros((B, cap), bool)
    for i, a in enumerate(arrays):
        n = min(a.shape[0], cap)
        out[i, :n] = a[:n]
        mask[i, :n] = True
    return out, mask


def pad_collate(samples: list[dict], capacities: dict | None = None) -> dict:
    """Collate into padded arrays: ragged leading dims become (array, mask)
    pairs under '<key>' and '<key>_mask'."""
    capacities = capacities or {}
    cols = list_collate(samples)
    out = {}
    for key, vals in cols.items():
        name = key.name.lower() if isinstance(key, DatasetSpec) else str(key)
        if isinstance(vals[0], np.ndarray):
            shapes = {v.shape for v in vals}
            if len(shapes) == 1:
                out[name] = np.stack(vals)
            else:
                arr, mask = pad_stack(vals, capacities.get(key))
                out[name] = arr
                out[name + "_mask"] = mask
        else:
            out[name] = vals
    return out
