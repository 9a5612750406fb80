"""Sample member codec for tar shards; counterpart of
``infinicube_tpu/data/codec.py``: encode and decode by extension.

The png codec is written here on ``zlib`` and ``struct`` (the card's machine
has no PIL): 8-bit gray, 8-bit RGB(A) and 16-bit gray, big-endian as the
format has it, so depth and instance pngs keep their uint16 values.
``encode_png`` writes every row unfiltered; ``decode_png`` reads
non-interlaced pngs of those kinds with any of the format's five row
filters, as PIL, cv2 and the reference's converter write them."""

from __future__ import annotations

import io
import json
import pickle
import struct
import zlib
from typing import Any

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# channels -> png color type (gray, gray + alpha, RGB, RGBA)
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}
_CHANNELS = {v: k for k, v in _COLOR_TYPE.items()}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def encode_png(arr: np.ndarray) -> bytes:
    """uint8 or uint16 [H, W] or [H, W, C] (C in 1-4) -> png bytes."""
    arr = np.asarray(arr)
    if arr.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"png takes uint8 or uint16, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"png takes 1-4 channels, got {c}")
    depth = 8 * arr.dtype.itemsize
    rows = arr.astype(arr.dtype.newbyteorder(">")).reshape(h, -1).view(
        np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return _PNG_SIG + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, _COLOR_TYPE[c], 0, 0, 0)) + \
        _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + \
        _chunk(b"IEND", b"")


def _unfilter(filters: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Undo the png row filters: ``filters`` uint8 [H], ``rows`` uint8
    [H, W, bpp] as stored -> the pixel bytes uint8 [H, W, bpp].

    A pixel's predictor reads its reconstructed left (a), up (b) and
    up-left (c) neighbours: 0 None, 1 Sub a, 2 Up b, 3 Average
    floor((a + b) / 2), 4 Paeth. Pixels on one anti-diagonal depend on
    none of each other, so the rows are undone one anti-diagonal at a time,
    every row by its own filter."""
    if filters.max(initial=0) > 4:
        raise ValueError(f"png row filter {int(filters.max())} is not one "
                         "the format defines")
    if not filters.any():
        return np.ascontiguousarray(rows)
    h, w, _ = rows.shape
    # reconstructed bytes, with a zero row above and a zero column left
    out = np.zeros((h + 1, w + 1, rows.shape[2]), np.int32)
    f = filters.astype(np.int32)[:, None]
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        x = d - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        fy = f[y]
        pred = np.select([fy == 1, fy == 2, fy == 3, fy == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (rows[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """png bytes -> uint8 or uint16 [H, W] (gray) or [H, W, C]."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a png")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth not in (8, 16) or ctype not in _CHANNELS or interlace:
        raise ValueError(f"png of bit depth {depth}, color type {ctype}, "
                         f"interlace {interlace} is not read here")
    c = _CHANNELS[ctype]
    bpp = c * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(
        h, 1 + w * bpp)
    out = _unfilter(raw[:, 0], raw[:, 1:].reshape(h, w, bpp))
    dt = np.dtype(">u2") if depth == 16 else np.dtype(np.uint8)
    img = out.view(dt).reshape(h, w, c).astype(dt.newbyteorder("="))
    return img[..., 0] if c == 1 else img


def decode_member(ext: str, data: bytes) -> Any:
    ext = ext.lower().lstrip(".")
    if ext == "png":
        return decode_png(data)
    if ext == "json":
        return json.loads(data.decode())
    if ext in ("txt", "text"):
        return data.decode()
    if ext == "npy":
        return np.load(io.BytesIO(data), allow_pickle=False)
    if ext == "npz":
        return dict(np.load(io.BytesIO(data), allow_pickle=False))
    if ext in ("pkl", "pickle"):
        return pickle.loads(data)
    return data


def encode_member(ext: str, value: Any) -> bytes:
    ext = ext.lower().lstrip(".")
    if ext == "png":
        return encode_png(value)
    if ext == "json":
        return json.dumps(value).encode()
    if ext in ("txt", "text"):
        return str(value).encode()
    if ext == "npy":
        buf = io.BytesIO()
        np.save(buf, np.asarray(value))
        return buf.getvalue()
    if ext == "npz":
        buf = io.BytesIO()
        np.savez_compressed(buf, **value)
        return buf.getvalue()
    if ext in ("pkl", "pickle"):
        return pickle.dumps(value)
    if isinstance(value, bytes):
        return value
    raise ValueError(f"cannot encode extension {ext}")
