"""GSM branch checkpoint merging; counterpart of
``infinicube_tpu/utils/model_merge.py``.

The reference trains the 3D-only and 2D-only GSM variants apart and merges
their checkpoints into the dual-branch model: the ``voxel_branch`` and
``pixel_branch`` entries (and optionally ``sky`` and ``encoder``) of two
trained ``state_dict``s are grafted into a dual-branch one."""

from __future__ import annotations

import torch


def merge_gsm_params(dual_sd: dict, voxel_sd: dict | None = None,
                     pixel_sd: dict | None = None,
                     take_sky_from: str = "voxel") -> dict:
    """``dual_sd``: a dual-branch GSM's ``state_dict`` (the names it holds
    are the model's); ``voxel_sd`` / ``pixel_sd``: trained single-branch
    ones. A module is grafted where both hold it: all of the dual's entries
    under it are replaced by copies of the source's. Returns a new dict."""
    out = {k: v.clone() if isinstance(v, torch.Tensor) else v
           for k, v in dual_sd.items()}

    def graft(src, names):
        for name in names:
            prefix = f"{name}."
            if any(k.startswith(prefix) for k in src) and \
                    any(k.startswith(prefix) for k in out):
                for k in [k for k in out if k.startswith(prefix)]:
                    del out[k]
                out.update({k: v.clone() for k, v in src.items()
                            if k.startswith(prefix)})

    if voxel_sd is not None:
        graft(voxel_sd, ["voxel_branch"])
        if take_sky_from == "voxel":
            graft(voxel_sd, ["sky", "encoder"])
    if pixel_sd is not None:
        graft(pixel_sd, ["pixel_branch"])
        if take_sky_from == "pixel":
            graft(pixel_sd, ["sky", "encoder"])
    return out
