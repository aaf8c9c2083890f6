"""The port's HDF5 layer: the native backend (``io/native/`` through
``io/native_backend.py``), the h5py backend and the ``io/h5.py`` façade.

* every dtype of the JAX package's native tests round-trips through the
  port's native backend (float64, complex128, int64, float32, int32,
  complex64, the {r, i} int32 compound), with slices, stacked reads,
  ``list_group``, ``dataset_shape``, overwrite and ``.h5`` defaulting;
* files written by the JAX package's h5py backend read in the port's native
  backend, its files read in the JAX package's h5py backend and in h5py,
  each dataset read without a dtype at its stored width;
* the façade's selection (``SKA_SDP_TPU_H5_BACKEND``: auto, native, h5py;
  auto takes h5py where no HDF5 1.10 runtime is found), and ``find_hdf5``
  refusing a runtime of another ABI;
* ``w_gridding`` and the CLI's ``--mode idg`` file entry giving bit-equal
  images on both backends, and equal to each other's files.

It skips only where the native library cannot load.
"""

import numpy as np
import pytest

from ska_sdp_tpu_torch.io import h5, h5py_backend as hb
from ska_sdp_tpu_torch.io.native import build


@pytest.fixture(scope="module")
def nb():
    from ska_sdp_tpu_torch.io import native_backend

    try:
        native_backend.ensure_loaded()
    except (OSError, RuntimeError) as e:
        pytest.skip(f"native HDF5 library unavailable: {e}")
    return native_backend


@pytest.fixture(scope="module")
def jhb():
    """The JAX package's h5py backend (it imports no jax)."""
    from ska_sdp_tpu.io import h5py_backend

    return h5py_backend


def _data(rng, dtype, shape):
    dtype = np.dtype(dtype)
    if dtype.kind == "c":
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(dtype)
    if dtype.kind == "i":
        hi = 2 ** 60 if dtype.itemsize == 8 else 2 ** 30
        return rng.integers(-hi, hi, shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


DTYPES = [np.float64, np.complex128, np.int64, np.float32, np.int32,
          np.complex64]


class TestNativeRoundTrip:
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_roundtrip(self, nb, tmp_path, dtype):
        p = str(tmp_path / "r.h5")
        a = _data(np.random.default_rng(1), dtype, (3, 4, 5))
        nb.create_file(p)
        nb.write_dataset(p, "/deep/group/tree/x", a)
        got = nb.read_dataset(p, "/deep/group/tree/x")
        assert got.dtype == a.dtype
        np.testing.assert_array_equal(got, a)
        np.testing.assert_array_equal(
            nb.read_dataset(p, "/deep/group/tree/x", dtype=a.dtype), a)
        assert nb.dataset_shape(p, "/deep/group/tree/x") == (3, 4, 5)

    def test_complex_int_compound(self, nb, tmp_path):
        import h5py

        p = str(tmp_path / "ci.h5")
        ci = np.zeros((2, 3), dtype=nb.COMPLEX_INT_DTYPE)
        ci["r"] = np.arange(6).reshape(2, 3)
        ci["i"] = -np.arange(6).reshape(2, 3)
        nb.create_file(p)
        nb.write_dataset(p, "/ci", ci)
        got = nb.read_dataset(p, "/ci")
        assert got.dtype == nb.COMPLEX_INT_DTYPE
        np.testing.assert_array_equal(got, ci)
        with h5py.File(p, "r") as f:
            np.testing.assert_array_equal(np.asarray(f["/ci"])["i"], ci["i"])

    @pytest.mark.parametrize("dtype", [np.complex128, np.float32])
    def test_slices_match_h5py(self, nb, tmp_path, dtype):
        p = str(tmp_path / "sl.h5")
        c = _data(np.random.default_rng(2), dtype, (10, 3, 2))
        nb.create_file(p)
        nb.write_dataset(p, "/g/c", c)
        for start, count in [(0, 10), (2, 5), (9, 1), (3, 0)]:
            got = nb.read_dataset_slice(p, "/g/c", start, count)
            assert got.dtype == c.dtype
            np.testing.assert_array_equal(got, c[start:start + count])
            np.testing.assert_array_equal(
                got, hb.read_dataset_slice(p, "/g/c", start, count))
        with pytest.raises(OSError):
            nb.read_dataset_slice(p, "/g/c", 5, 10)     # beyond the extent

    def test_stacked(self, nb, tmp_path):
        p = str(tmp_path / "st.h5")
        nb.create_file(p)
        rng = np.random.default_rng(3)
        arrs = [_data(rng, np.complex128, (4, 4)) for _ in range(4)]
        for k, a in enumerate(arrs):
            nb.write_dataset(p, f"/g/{k}/kern", a)
        names = [f"/g/{k}/kern" for k in range(4)]
        got = nb.read_datasets_stacked(p, names, dtype=np.complex128)
        np.testing.assert_array_equal(got, np.stack(arrs))
        np.testing.assert_array_equal(hb.read_datasets_stacked(p, names), got)

    def test_list_group(self, nb, tmp_path):
        p = str(tmp_path / "lg.h5")
        nb.create_file(p)
        for name in ["-200", "0", "1500.5"]:
            nb.write_dataset(p, f"/wkern/0.1/{name}/kern", np.zeros((2, 2)))
        assert nb.list_group(p, "/wkern/0.1") == ["-200", "0", "1500.5"]
        assert nb.list_group(p, "/wkern/0.1") == hb.list_group(p,
                                                             "/wkern/0.1")

    def test_ext_defaulting(self, nb, tmp_path):
        p = str(tmp_path / "noext")
        nb.create_file(p)
        nb.write_dataset(p, "/d", np.ones(3))
        np.testing.assert_array_equal(nb.read_dataset(p + ".h5", "/d"),
                                      np.ones(3))

    def test_overwrite_is_native(self, nb, tmp_path, monkeypatch):
        import sys

        monkeypatch.setitem(sys.modules, "h5py", None)   # no h5py to lean on
        p = str(tmp_path / "ow.h5")
        nb.create_file(p)
        nb.write_dataset(p, "/d", np.ones(3))
        nb.write_dataset(p, "/d", np.zeros((5, 2), np.float32))
        assert nb.dataset_shape(p, "/d") == (5, 2)
        assert nb.read_dataset(p, "/d").dtype == np.float32

    def test_missing_dataset_raises(self, nb, tmp_path):
        p = str(tmp_path / "m.h5")
        nb.create_file(p)
        for call in (lambda: nb.read_dataset(p, "/nope", dtype=np.float64),
                     lambda: nb.read_dataset(p, "/nope"),
                     lambda: nb.dataset_shape(p, "/nope")):
            with pytest.raises(OSError):
                call()


class TestCrossBackend:
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_native_reads_jax_h5py_file(self, nb, jhb, tmp_path, dtype):
        p = str(tmp_path / "x1.h5")
        a = _data(np.random.default_rng(4), dtype, (5, 3))
        jhb.create_file(p)
        jhb.write_dataset(p, "/vis/vis", a)
        got = nb.read_dataset(p, "/vis/vis")
        assert got.dtype == a.dtype
        np.testing.assert_array_equal(got, a)

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_jax_h5py_reads_native_file(self, nb, jhb, tmp_path, dtype):
        p = str(tmp_path / "x2.h5")
        a = _data(np.random.default_rng(5), dtype, (5, 3))
        nb.create_file(p)
        nb.write_dataset(p, "/vis/vis", a)
        got = jhb.read_dataset(p, "/vis/vis")
        assert got.dtype == a.dtype
        np.testing.assert_array_equal(got, a)
        np.testing.assert_array_equal(hb.read_dataset(p, "/vis/vis"), a)


def _select(monkeypatch, choice):
    monkeypatch.setenv("SKA_SDP_TPU_H5_BACKEND", choice)


class TestFacade:
    def test_selection(self, nb, tmp_path, monkeypatch):
        p = str(tmp_path / "f.h5")
        d = np.random.default_rng(6).standard_normal((6, 4))
        for choice, name in (("auto", "native"), ("native", "native"),
                             ("h5py", "h5py")):
            _select(monkeypatch, choice)
            assert h5.backend_name() == name
            h5.create_file(p)
            h5.write_dataset(p, "/d", d)
            np.testing.assert_array_equal(h5.read_dataset_slice(p, "/d", 2,
                                                                3), d[2:5])
            assert h5.dataset_shape(p, "/d") == (6, 4)
            assert h5.list_group(p, "/") == ["d"]

    def test_unknown_choice_raises(self, monkeypatch):
        _select(monkeypatch, "hdf5")
        with pytest.raises(ValueError):
            h5.backend_name()

    def test_auto_without_a_runtime_is_h5py(self, monkeypatch):
        _select(monkeypatch, "auto")
        monkeypatch.setattr(build, "find_hdf5",
                            lambda: build.HDF5Runtime(None, (), ()))
        assert h5.backend_name() == "h5py"

    def test_other_abi_is_not_linked(self, tmp_path, monkeypatch):
        (tmp_path / "libhdf5.so.310").touch()
        (tmp_path / "libhdf5_hl.so.310").touch()
        monkeypatch.setattr(build, "LIB_DIRS", (str(tmp_path),))
        monkeypatch.setenv("LD_LIBRARY_PATH", "")
        rt = build.find_hdf5.__wrapped__()
        assert rt.path is None
        assert rt.other_abi == (str(tmp_path / "libhdf5.so.310"),)
        assert str(tmp_path / "libhdf5_serial.so.103") in rt.searched
        assert "another ABI" in build.describe(rt)
        monkeypatch.setattr(build, "find_hdf5", lambda: rt)
        with pytest.raises(FileNotFoundError, match="libhdf5.so.310"):
            build.build()


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from ska_sdp_tpu_torch.io.synthetic import (SyntheticConfig,
                                                generate_dataset)

    cfg = SyntheticConfig(theta=0.05, lam=1800, nant=6, ntime=3,
                          nw_planes=4, qpx=2, npix_ff=64, npix_kern=9,
                          seed=3)
    d = tmp_path_factory.mktemp("h5data")
    paths = {}
    for backend in ("h5py", "native"):
        with pytest.MonkeyPatch.context() as mp:
            _select(mp, backend)
            paths[backend] = generate_dataset(str(d / backend), cfg)[0]
    return paths


class TestFileEntries:
    def test_w_gridding_on_both_backends(self, nb, dataset, monkeypatch):
        from ska_sdp_tpu_torch.config import GridParams, ImagingConfig
        from ska_sdp_tpu_torch.models import runs

        icfg = ImagingConfig(grid=GridParams(theta=0.05, lam=1800),
                             precision_name="double")
        out = {}
        for backend in ("h5py", "native"):
            _select(monkeypatch, backend)
            for src, paths in dataset.items():
                out[backend, src] = runs.w_gridding(
                    paths["wkern"], paths["vis"], config=icfg, device="cpu")
        ref_max, ref = out["h5py", "h5py"]
        for mx, img in out.values():
            assert mx == ref_max
            np.testing.assert_array_equal(img, ref)

    def test_cli_idg_on_both_backends(self, nb, dataset, tmp_path,
                                      monkeypatch):
        from ska_sdp_tpu_torch import cli

        imgs = {}
        for backend in ("h5py", "native"):
            _select(monkeypatch, backend)
            out = str(tmp_path / f"{backend}.h5")
            data_dir = dataset[backend]["vis"].rsplit("/", 1)[0]
            assert cli.main(["--mode", "idg", "-i", data_dir, "--all",
                             "--device", "cpu", "--theta", "0.05", "--lam",
                             "1800", "-o", out, "-dphases"]) == 0
            imgs[backend] = h5.read_dataset(out, "/img")
        assert imgs["native"].dtype == np.float64
        np.testing.assert_array_equal(imgs["native"], imgs["h5py"])
