"""Stage 3 of a release e2e run again, from its artifacts; counterpart of
``examples/e2e_stage3_resume.py``.

Replays only the Gaussian scene (the release ``GSMConfig`` over 16 key
views, every 6th frame) on the ``buffers/`` folder that
``e2e_pipeline`` wrote, so that a stage-3 failure does not repay stages 1,
2 and the video. The video frames come from ``video/*.png`` where that
directory exists, else random frames (numpy seed 0), as the reference's:
where a video writer is installed the pipeline writes ``video.mp4`` and no
``video/``, so the resume takes random frames; where none is (the card's
machine), ``utils.fileio.write_video`` writes the ``video/`` png frames
and the resume reads them.

    [E2E_STEADY=1] python -m infinicube_tpu_torch.examples.e2e_stage3_resume \\
        [outdir]

Runs on the card unless the caller of ``resume`` asks for the CPU."""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np

from infinicube_tpu_torch.device import resolve_device
from infinicube_tpu_torch.examples.e2e_pipeline import (RELEASE_VIEWS,
                                                        Stage3Views,
                                                        build_kernels,
                                                        stage3_data,
                                                        stage3_scene)


def resume(outdir, gsm_cfg=None, views: Stage3Views = RELEASE_VIEWS,
           device="cuda", steady: bool = False) -> dict:
    """Stage 3 on ``outdir``'s artifacts (random weights); writes
    decoded_gs_static.pkl / .splat and render0.png there. Returns
    {"static_gs", "out", "video" (whether ``video/`` frames were read),
    "seconds"}."""
    from infinicube_tpu_torch.data.codec import decode_png
    from infinicube_tpu_torch.models.gsm.model import GSMConfig
    device = resolve_device(device)
    outdir = Path(outdir)
    gsm_cfg = gsm_cfg or GSMConfig(dense_dims=(512, 256, 64),
                                   dense_ijk_min=(-32, -128, -16))
    vdir = outdir / "video"
    video = None
    if vdir.is_dir():
        video = np.stack([decode_png(f.read_bytes()) for f in
                          sorted(vdir.glob("*.png"))]).astype(
            np.float32) / 255.0
    record: dict = {}
    static_gs, _, out = stage3_scene(
        outdir, stage3_data(outdir, views, video), gsm_cfg, views, device,
        steady, record, label="stage3 GSM (resume)")
    print(f"[stage3-resume] done -> {outdir}", flush=True)
    return {"static_gs": static_gs, "out": out, "video": video is not None,
            "seconds": record}


def main(outdir="out/e2e_release"):
    from infinicube_tpu_torch.utils.precision import set_float32_precision
    set_float32_precision()
    build_kernels("cuda")
    return resume(outdir, steady=os.environ.get("E2E_STEADY", "0") == "1")


if __name__ == "__main__":
    main(*sys.argv[1:])
