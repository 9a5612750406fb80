"""Tar shard I/O in pure Python; counterpart of
``infinicube_tpu/data/tario.py``. Standard tar files, members written in
order under the names given, readable by the reference's ``TarReader``.

The reader indexes a shard once by walking its 512-byte headers, with the
reference's native reader's rules: regular members (and GNU long names),
the ustar prefix joined to the name, the walk stopped at the first member
whose size field is not octal or base-256 or whose data runs past the end
of the file, so a truncated or malformed member is never served."""

from __future__ import annotations

import io
import os
import tarfile
from pathlib import Path

_BLOCK = 512


def _parse_size(field: bytes) -> int | None:
    """A tar numeric field: octal, or GNU base-256 (high bit of the first
    byte set). None where it is neither."""
    if field[0] & 0x80:
        v = field[0] & 0x7F
        for b in field[1:]:
            v = (v << 8) | b
        return v
    v, any_digit = 0, False
    for b in field:
        if b == 0:
            break
        if b == 0x20:
            continue
        if not 0x30 <= b <= 0x37:
            return None
        v = v * 8 + (b - 0x30)
        any_digit = True
    return v if any_digit else 0


def _index(f, file_size: int) -> dict[str, tuple[int, int]]:
    """name -> (data offset, size) of every healthy regular member, in
    order; the first of two members of one name is kept."""
    members: dict[str, tuple[int, int]] = {}
    off, longname = 0, None
    while off + _BLOCK <= file_size:
        f.seek(off)
        hdr = f.read(_BLOCK)
        if hdr[0] == 0:
            break
        size = _parse_size(hdr[124:136])
        kind = hdr[156:157]
        name = hdr[:100].split(b"\0", 1)[0].decode()
        if hdr[257:262] == b"ustar" and hdr[345] != 0:
            name = hdr[345:500].split(b"\0", 1)[0].decode() + "/" + name
        payload = off + _BLOCK
        if size is None or size > file_size or payload > file_size - size:
            break
        if kind == b"L":
            f.seek(payload)
            longname = f.read(max(size - 1, 0)).decode()
        elif kind in (b"0", b"\0"):
            members.setdefault(longname or name, (payload, size))
            longname = None
        else:
            longname = None
        off = payload + (size + _BLOCK - 1) // _BLOCK * _BLOCK
    return members


class TarWriter:
    """Sequential tar shard writer."""

    def __init__(self, path: str | Path):
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        self.path = str(path)
        self._tf = tarfile.open(self.path, "w", format=tarfile.USTAR_FORMAT)

    def add(self, name: str, data: bytes):
        info = tarfile.TarInfo(name)
        info.size = len(data)
        self._tf.addfile(info, io.BytesIO(data))

    def close(self):
        if self._tf:
            self._tf.close()
            self._tf = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class TarReader:
    """Random-access member reads from a tar shard."""

    def __init__(self, path: str | Path):
        self.path = str(path)
        self._f = open(self.path, "rb")
        try:
            self._members = _index(self._f, os.fstat(self._f.fileno()).st_size)
        except BaseException:
            self._f.close()
            raise

    def names(self) -> list[str]:
        return list(self._members)

    def read(self, name: str) -> bytes:
        m = self._members.get(name)
        if m is None:
            raise KeyError(name)
        self._f.seek(m[0])
        return self._f.read(m[1])

    def __contains__(self, name: str) -> bool:
        return name in self._members

    def close(self):
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def get_sample(tar_path: str | Path, key: str) -> dict[str, bytes]:
    """All members of one sample key (name = '<key>.<ext...>') from a
    shard, keyed by the extension."""
    with TarReader(tar_path) as r:
        out = {}
        for name in r.names():
            stem, _, ext = name.partition(".")
            if stem == key:
                out[ext] = r.read(name)
        return out
