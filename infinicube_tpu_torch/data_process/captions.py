"""Video captions and the DiffSynth metadata table; counterpart of
``infinicube_tpu/data_process/captions.py``. The captioner is a hook: a
VLM (Qwen2-VL, which needs downloaded weights) plugs in through
``register_captioner``; without one a template caption keeps the pipeline
runnable. ``DistributedProcessor`` gives each process its slice of the
items."""

from __future__ import annotations

import csv
import dataclasses
from pathlib import Path
from typing import Callable, Iterable


@dataclasses.dataclass
class DistributedProcessor:
    """The items of one process of ``process_count`` (index
    ``process_index``), taken cyclically."""
    process_index: int = 0
    process_count: int = 1

    def my_items(self, items: list) -> list:
        return [x for i, x in enumerate(items)
                if i % self.process_count == self.process_index]

    def run(self, items: Iterable, fn: Callable):
        return [fn(x) for x in self.my_items(list(items))]


_CAPTIONER = None


def register_captioner(fn: Callable):
    """fn(video_path) -> str; plug a VLM (Qwen2-VL in the reference) here."""
    global _CAPTIONER
    _CAPTIONER = fn


def caption_video(video_path: str | Path) -> str:
    if _CAPTIONER is not None:
        return _CAPTIONER(video_path)
    return ("A realistic driving scene captured from a vehicle-mounted "
            "front camera, with roads, vehicles and surroundings.")


def make_qwen2vl_captioner(model, processor, prompt: str | None = None,
                           num_frames: int = 8,
                           max_new_tokens: int = 128) -> Callable:
    """The VLM captioner (Qwen2-VL) around a loaded ``model`` and its
    ``processor`` (``Qwen2VLForConditionalGeneration`` and
    ``AutoProcessor`` of the ``transformers`` library, from downloaded
    weights; the port neither ships nor imports them):

        register_captioner(make_qwen2vl_captioner(model, processor))

    Samples ``num_frames`` frames of the clip and asks for a driving-scene
    caption."""
    if model is None or processor is None:
        raise ValueError("the Qwen2-VL captioner needs a loaded model and "
                         "processor (downloaded weights); without them the "
                         "template caption is used")
    prompt = prompt or ("Describe this driving video clip in one detailed "
                        "sentence: scene type, weather, time of day, and "
                        "notable objects.")

    def captioner(video_path: str | Path) -> str:
        import numpy as np
        from infinicube_tpu_torch.utils.fileio import read_video
        frames = read_video(video_path)
        sel = np.linspace(0, len(frames) - 1,
                          min(num_frames, len(frames))).astype(int)
        messages = [{"role": "user", "content": [
            {"type": "video"}, {"type": "text", "text": prompt}]}]
        text = processor.apply_chat_template(messages, tokenize=False,
                                             add_generation_prompt=True)
        inputs = processor(text=[text], videos=[list(frames[sel])],
                           return_tensors="pt")
        out_ids = model.generate(**inputs, max_new_tokens=max_new_tokens)
        new = out_ids[:, inputs["input_ids"].shape[1]:]
        return processor.batch_decode(new, skip_special_tokens=True)[0]

    return captioner


def generate_captions(video_paths: list, output_json: str | Path,
                      proc: DistributedProcessor | None = None):
    import json
    proc = proc or DistributedProcessor()
    caps = {str(p): caption_video(p) for p in proc.my_items(video_paths)}
    out = Path(output_json)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(caps, indent=1))
    return caps


def generate_metadata_csv(captions: dict, output_csv: str | Path):
    """DiffSynth-format metadata.csv (file_name, text)."""
    out = Path(output_csv)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["file_name", "text"])
        for path, text in sorted(captions.items()):
            w.writerow([Path(path).name, text])
