"""Raw-file / gzip-file storage backends (StorageFactory modes
STORAGE_FILE / STORAGE_GZFILE / STORAGE_COMPRESSED_FILE,
tools/storage/impl/Storage.hpp:66-76 + StorageFile.hpp:49-200 +
CollectionFile.hpp).

The reference's STORAGE_FILE keeps a ``<name>_gatb/`` directory whose
group tree is flattened into per-group JSON property files
(``<parent-id>.<group>``, StorageFile.hpp:60-90) and one raw binary
file per collection (CollectionFile). The same on-disk shape is kept
here — a directory of JSON property files + one blob per dataset —
with a small sidecar header per dataset (dtype/shape) since our
datasets are typed numpy arrays rather than template-instantiated C++
item streams. The gz variants transparently gzip every dataset blob
(STORAGE_GZFILE / STORAGE_COMPRESSED_FILE, CollectionGzFile /
CollectionCompressedFile roles).

API-compatible with storage.hdf5.Storage (group / set_dataset /
set_property / ostream / istream / state bits), so every algorithm's
persistence path can run against any backend via
``StorageFactory.create``.
"""

from __future__ import annotations

import gzip
import io
import json
import os
import shutil

import numpy as np

from .hdf5 import IStream, OStream


class FileGroup:
    """One group of a directory-backed storage: properties in a JSON
    file, datasets as sibling blobs (GroupFile, StorageFile.hpp:49)."""

    def __init__(self, storage: "FileStorage", full_id: str):
        self._storage = storage
        self._id = full_id          # '.'-joined path ('' = root)
        self._props_file = os.path.join(
            storage.folder, (full_id or "root") + ".json")
        self._props = {}
        if os.path.exists(self._props_file):
            with open(self._props_file) as f:
                self._props = json.load(f)

    # ---- tree --------------------------------------------------------
    def group(self, name: str) -> "FileGroup":
        full = f"{self._id}.{name}" if self._id else name
        return self._storage._group(full)

    def _data_path(self, name: str) -> str:
        base = f"{self._id}.{name}" if self._id else name
        return os.path.join(self._storage.folder, base + ".data")

    # ---- properties (JSON file per group, like GroupFile) ------------
    def set_property(self, key: str, value) -> None:
        if isinstance(value, np.generic):
            value = value.item()
        elif isinstance(value, np.ndarray):
            value = value.tolist()
        self._props[key] = value
        self._flush_props()

    def get_property(self, key: str, default=None):
        return self._props.get(key, default)

    def _flush_props(self) -> None:
        with open(self._props_file, "w") as f:
            json.dump(self._props, f)

    # ---- datasets (one blob per collection, like CollectionFile) -----
    def set_dataset(self, name: str, data: np.ndarray) -> None:
        data = np.asarray(data)
        header = json.dumps({
            "dtype": data.dtype.descr if data.dtype.names
            else data.dtype.str,
            "shape": list(data.shape),
        }).encode()
        raw = header + b"\n" + data.tobytes()
        opener = gzip.open if self._storage.compressed else open
        with opener(self._data_path(name), "wb") as f:
            f.write(raw)

    def get_dataset(self, name: str) -> np.ndarray | None:
        path = self._data_path(name)
        if not os.path.exists(path):
            return None
        opener = gzip.open if self._storage.compressed else open
        with opener(path, "rb") as f:
            raw = f.read()
        nl = raw.index(b"\n")
        meta = json.loads(raw[:nl].decode())
        descr = meta["dtype"]
        dtype = np.dtype([tuple(x[0:1]) + (x[1],) + tuple(
            (tuple(x[2]),) if len(x) > 2 else ())
            for x in descr] if isinstance(descr, list) else descr)
        arr = np.frombuffer(raw[nl + 1:], dtype=dtype)
        return arr.reshape(meta["shape"])

    def __contains__(self, name: str) -> bool:
        """A dataset or a subgroup of this group (like h5py's ``in``)."""
        if os.path.exists(self._data_path(name)):
            return True
        full = f"{self._id}.{name}" if self._id else name
        return any(f == full + ".json" or f.startswith(full + ".")
                   for f in os.listdir(self._storage.folder))

    # ---- byte streams (Storage::ostream/istream) ---------------------
    def ostream(self, name: str) -> OStream:
        return OStream(self, name)

    def istream(self, name: str) -> IStream:
        return IStream(self, name)


class FileStorage(FileGroup):
    """Directory-backed storage root (StorageFileFactory,
    StorageFile.hpp:160-200). ``compressed=True`` gzips every dataset
    blob (the GZFILE / COMPRESSED_FILE experimental modes)."""

    def __init__(self, name: str, mode: str = "a",
                 compressed: bool = False):
        # the reference appends '_gatb/' to the storage name unless it
        # already ends with it (StorageFile.hpp:57-59)
        folder = name if name.rstrip("/").endswith("_gatb") \
            else name + "_gatb"
        if mode == "w" and os.path.isdir(folder):
            shutil.rmtree(folder)
        os.makedirs(folder, exist_ok=True)
        self.folder = folder
        self.compressed = compressed
        self.path = folder
        self._groups: dict[str, FileGroup] = {}
        super().__init__(self, "")
        self._groups[""] = self

    def _group(self, full_id: str) -> FileGroup:
        g = self._groups.get(full_id)
        if g is None:
            g = FileGroup(self, full_id)
            self._groups[full_id] = g
        return g

    def close(self) -> None:
        pass

    def flush(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- graph-build state machine helpers (Storage parity) ----------
    def get_state(self) -> int:
        return int(self.get_property("state", 0) or 0)

    def set_state_bit(self, bit: int) -> None:
        self.set_property("state", int(self.get_state() | bit))

    def check_state(self, bit: int) -> bool:
        return bool(self.get_state() & bit)


class StorageFactory:
    """Backend dispatch (StorageFactory, Storage.hpp:78-120 +
    Storage.tpp): mode 'hdf5' (default production format), 'file'
    (raw directory), 'gzfile' / 'compressed-file' (gzipped blobs)."""

    MODES = ("hdf5", "file", "gzfile", "compressed-file")

    @staticmethod
    def create(name: str, mode: str = "hdf5", file_mode: str = "a"):
        if mode == "hdf5":
            from .hdf5 import Storage

            return Storage(name, file_mode)
        if mode == "file":
            return FileStorage(name, file_mode, compressed=False)
        if mode in ("gzfile", "compressed-file"):
            return FileStorage(name, file_mode, compressed=True)
        raise ValueError(f"unknown storage mode {mode!r} "
                         f"(expected one of {StorageFactory.MODES})")

    @staticmethod
    def exists(name: str, mode: str = "hdf5") -> bool:
        if mode == "hdf5":
            return os.path.exists(name)
        folder = name if name.rstrip("/").endswith("_gatb") \
            else name + "_gatb"
        return os.path.isdir(folder)


def open_storage(path: str, mode: str = "a"):
    """Storage for a graph path: HDF5 for a ``.h5`` path, otherwise the
    numpy-only file backend (a ``<path>_gatb/`` directory), which needs
    no h5py."""
    return StorageFactory.create(
        path, "hdf5" if path.endswith(".h5") else "file", mode)
