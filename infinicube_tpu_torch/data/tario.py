"""Tar shard I/O in pure Python (``tarfile``); counterpart of
``infinicube_tpu/data/tario.py``. Standard tar files, members written in
order under the names given, readable by the reference's ``TarReader``."""

from __future__ import annotations

import io
import tarfile
from pathlib import Path


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
        self._tf = tarfile.open(self.path, "r")
        self._members = {m.name: m for m in self._tf.getmembers()
                         if m.isfile()}

    def names(self) -> list[str]:
        return list(self._members)

    def read(self, name: str) -> bytes:
        m = self._members.get(name)
        if m is None:
            raise KeyError(name)
        return self._tf.extractfile(m).read()

    def __contains__(self, name: str) -> bool:
        return name in self._members

    def close(self):
        if self._tf:
            self._tf.close()
            self._tf = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
