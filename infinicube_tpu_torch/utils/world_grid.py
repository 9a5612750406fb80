"""Host-side unbounded world voxel grid (int64 keys, NumPy); the port's own
copy of ``infinicube_tpu/utils/world_grid.py``: packing, ``WorldGrid`` with
merge semantics where existing voxels win, point merging, the AABB crop and
its occupancy test, the rigid voxel warp and the connected-component filter
(scipy)."""

from __future__ import annotations

import numpy as np

_B = 21  # bits per axis; domain +-2^20 voxels per axis


def pack64(ijk: np.ndarray) -> np.ndarray:
    off = 1 << (_B - 1)
    i = ijk[:, 0].astype(np.int64) + off
    j = ijk[:, 1].astype(np.int64) + off
    k = ijk[:, 2].astype(np.int64) + off
    return (i << (2 * _B)) | (j << _B) | k


def unpack64(keys: np.ndarray) -> np.ndarray:
    off = 1 << (_B - 1)
    mask = (1 << _B) - 1
    i = (keys >> (2 * _B)) - off
    j = ((keys >> _B) & mask) - off
    k = (keys & mask) - off
    return np.stack([i, j, k], axis=-1).astype(np.int64)


class WorldGrid:
    """Accumulating semantic voxel world at a fixed voxel size/origin."""

    def __init__(self, voxel_size, origin=None):
        self.voxel_size = np.broadcast_to(np.asarray(voxel_size, np.float64),
                                          (3,)).copy()
        self.origin = (np.broadcast_to(np.asarray(origin, np.float64), (3,))
                       .copy() if origin is not None else self.voxel_size / 2)
        self.keys = np.zeros((0,), np.int64)
        self.semantics = np.zeros((0,), np.int32)

    def world_to_ijk(self, points: np.ndarray) -> np.ndarray:
        return np.round((points - self.origin) / self.voxel_size).astype(
            np.int64)

    def ijk_to_world(self, ijk: np.ndarray) -> np.ndarray:
        return ijk * self.voxel_size + self.origin

    @property
    def num_voxels(self) -> int:
        return len(self.keys)

    def points(self) -> np.ndarray:
        return self.ijk_to_world(unpack64(self.keys))

    def ijk(self) -> np.ndarray:
        return unpack64(self.keys)

    def merge_ijk(self, ijk: np.ndarray, semantics: np.ndarray,
                  keep_existing: bool = True):
        new_keys = pack64(np.asarray(ijk))
        new_sem = np.asarray(semantics, np.int32)
        new_keys, first = np.unique(new_keys, return_index=True)
        new_sem = new_sem[first]
        if keep_existing:
            fresh = ~np.isin(new_keys, self.keys, assume_unique=True)
            keys = np.concatenate([self.keys, new_keys[fresh]])
            sems = np.concatenate([self.semantics, new_sem[fresh]])
        else:
            stale = ~np.isin(self.keys, new_keys, assume_unique=True)
            keys = np.concatenate([self.keys[stale], new_keys])
            sems = np.concatenate([self.semantics[stale], new_sem])
        order = np.argsort(keys)
        self.keys, self.semantics = keys[order], sems[order]

    def merge_points(self, points: np.ndarray, semantics: np.ndarray,
                     keep_existing: bool = True):
        self.merge_ijk(self.world_to_ijk(points), semantics, keep_existing)

    def crop(self, bbox_min, bbox_max):
        """(ijk, semantics) of the voxels whose centers lie in the world
        AABB."""
        pts = self.points()
        m = np.all((pts >= np.asarray(bbox_min)) &
                   (pts <= np.asarray(bbox_max)), axis=-1)
        return unpack64(self.keys[m]), self.semantics[m]

    def occupancy_in(self, bbox_min, bbox_max) -> bool:
        """Whether the AABB holds any voxel (the blocks mode's skip-empty
        test)."""
        ijk, _ = self.crop(bbox_min, bbox_max)
        return len(ijk) > 0


def transform_ijk(ijk: np.ndarray, transform: np.ndarray, voxel_size,
                  origin) -> np.ndarray:
    """Rigidly warp voxel coordinates: ijk -> world -> T -> ijk."""
    vs = np.asarray(voxel_size, np.float64)
    org = np.asarray(origin, np.float64)
    world = ijk * vs + org
    warped = world @ np.asarray(transform)[:3, :3].T + transform[:3, 3]
    return np.round((warped - org) / vs).astype(np.int64)


def connected_component_filter(ijk: np.ndarray, min_size: int = 10,
                               keep_largest: bool = False) -> np.ndarray:
    """bool [N] keep-mask that removes the 6-connected components with fewer
    than ``min_size`` voxels (or keeps only the largest)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = len(ijk)
    if n == 0:
        return np.zeros((0,), bool)
    keys = pack64(ijk)
    order = np.argsort(keys)
    skeys = keys[order]
    rows, cols = [], []
    for shift in (1 << (2 * _B), 1 << _B, 1):
        nb = skeys + shift
        pos = np.clip(np.searchsorted(skeys, nb), 0, n - 1)
        hit = skeys[pos] == nb
        rows.append(order[np.nonzero(hit)[0]])
        cols.append(order[pos[hit]])
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    adj = coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    ncomp, labels = connected_components(adj, directed=False)
    sizes = np.bincount(labels, minlength=ncomp)
    if keep_largest:
        return labels == np.argmax(sizes)
    return sizes[labels] >= min_size
