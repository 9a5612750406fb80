"""Artifact file formats; counterpart of ``infinicube_tpu/utils/fileio.py``
for what the port writes: the stage-1 hand-off grid file."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def save_grid_semantic(path, ijk: np.ndarray, semantics: np.ndarray,
                       voxel_size, origin):
    """Stage-1 hand-off file (npz): voxel coordinates and their labels."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, ijk=ijk.astype(np.int64),
                        semantics=semantics.astype(np.int32),
                        voxel_size=np.asarray(voxel_size, np.float64),
                        origin=np.asarray(origin, np.float64))
