"""Raw-file / gz-file storage backends (StorageFactory modes
STORAGE_FILE / STORAGE_GZFILE, Storage.hpp:66-76 + StorageFile.hpp):
same Group API as the HDF5 backend, so algorithm persistence round-trips
through any backend."""

import os

import numpy as np
import pytest

from gatb_core_tpu.storage.filedir import FileStorage, StorageFactory
from gatb_core_tpu.storage.hdf5 import STATE_SORTING_COUNT_DONE


@pytest.mark.parametrize("mode", ["file", "gzfile", "compressed-file"])
def test_file_storage_roundtrip(tmp_path, mode):
    st = StorageFactory.create(str(tmp_path / "store"), mode=mode,
                               file_mode="w")
    g = st.group("dsk")
    data = np.arange(100, dtype=np.uint64).reshape(25, 4)
    g.set_dataset("solid", data)
    g.set_property("nb", 25)
    sub = g.group("inner")
    sub.set_property("note", "deep")
    st.set_state_bit(STATE_SORTING_COUNT_DONE)

    st2 = StorageFactory.create(str(tmp_path / "store"), mode=mode)
    g2 = st2.group("dsk")
    assert np.array_equal(g2.get_dataset("solid"), data)
    assert g2.get_property("nb") == 25
    assert g2.group("inner").get_property("note") == "deep"
    assert st2.check_state(STATE_SORTING_COUNT_DONE)
    assert "solid" in g2 and "missing" not in g2


def test_file_storage_compound_and_streams(tmp_path):
    st = FileStorage(str(tmp_path / "s"), "w")
    dt = np.dtype([("value", np.uint64, (2,)), ("abundance", np.int32)])
    rec = np.zeros(5, dtype=dt)
    rec["value"] = np.arange(10).reshape(5, 2)
    rec["abundance"] = np.arange(5)
    g = st.group("dsk")
    g.set_dataset("solid", rec)
    back = st.group("dsk").get_dataset("solid")
    assert back.dtype == dt
    assert np.array_equal(back["value"], rec["value"])
    assert np.array_equal(back["abundance"], rec["abundance"])

    with g.ostream("blob") as os_:
        os_.write(b"hello ")
        os_.write(b"bytes")
    s = g.istream("blob")
    assert s.read() == b"hello bytes"


def test_file_storage_reference_layout(tmp_path):
    """The on-disk shape matches the reference's STORAGE_FILE scheme:
    a <name>_gatb/ directory with '.'-joined flat group files
    (StorageFile.hpp:57-75)."""
    st = FileStorage(str(tmp_path / "graph"), "w")
    st.group("dsk").group("histogram").set_property("cutoff", 3)
    folder = str(tmp_path / "graph_gatb")
    assert os.path.isdir(folder)
    assert os.path.exists(os.path.join(folder, "dsk.histogram.json"))


def test_factory_mode_errors(tmp_path):
    with pytest.raises(ValueError):
        StorageFactory.create(str(tmp_path / "x"), mode="nope")


def test_file_group_contains_subgroups(tmp_path):
    st = FileStorage(str(tmp_path / "s"), "w")
    st.group("outer").group("inner").set_property("x", 1)
    assert "outer" in st
    assert "inner" in st.group("outer")
    assert "absent" not in st and "inn" not in st.group("outer")


@pytest.mark.parametrize("name,kind", [("g.h5", "hdf5"), ("g", "file")])
def test_open_storage_picks_backend_by_suffix(tmp_path, name, kind):
    from gatb_core_tpu.storage import hdf5
    from gatb_core_tpu.storage.filedir import open_storage

    if kind == "hdf5" and not hdf5.HAVE_H5PY:
        pytest.skip("h5py not installed")
    st = open_storage(str(tmp_path / name), "w")
    st.group("dsk").set_property("nb", 3)
    st.close()
    again = open_storage(str(tmp_path / name), "r")
    assert isinstance(again, hdf5.Storage if kind == "hdf5"
                      else FileStorage)
    assert again.group("dsk").get_property("nb") == 3
    again.close()


def test_h5_path_without_h5py_names_the_package(tmp_path, monkeypatch):
    from gatb_core_tpu.storage import hdf5
    from gatb_core_tpu.storage.filedir import open_storage

    monkeypatch.setattr(hdf5, "HAVE_H5PY", False)
    with pytest.raises(RuntimeError, match="h5py"):
        open_storage(str(tmp_path / "g.h5"), "w")
