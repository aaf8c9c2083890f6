"""Every caller array an entry copies to its device goes through
``utils.hostmem.to_device``: the one copy path that picks the registered
or the pageable copy, makes the host cast and counts ``h2d_bytes``.

For each entry, on the CPU, a spy on ``hostmem.to_device`` records the
arrays it is handed.  Each caller array the entry copies (uvw, the
visibilities, the antenna ids, the times where the entry copies them)
must be among them, as itself or as a view of its buffer.  The file
entries' caller arrays are the ones their HDF5 readers return.
"""

import numpy as np
import pytest
import torch

from ska_sdp_tpu_torch.config import GridParams, ImagingConfig
from ska_sdp_tpu_torch.io import h5, inputs
from ska_sdp_tpu_torch.io.synthetic import SyntheticConfig, generate_dataset
from ska_sdp_tpu_torch.models import dataset as ds
from ska_sdp_tpu_torch.models import runs, spectral
from ska_sdp_tpu_torch.parallel import ingest
from ska_sdp_tpu_torch.parallel.mesh import Mesh
from ska_sdp_tpu_torch.utils import hostmem
from ska_sdp_tpu_torch.utils.timing import PhaseTimer

torch.set_num_threads(2)

THETA, LAM = 0.05, 3600
CFG = SyntheticConfig(theta=THETA, lam=LAM, nant=6, ntime=6, nsources=2,
                      nw_planes=4, qpx=4, npix_ff=128, npix_kern=15,
                      nchan=2, chan_bw=2.0e6, seed=5)
CONFIG = ImagingConfig(grid=GridParams(theta=THETA, lam=LAM))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    paths, _ = generate_dataset(str(tmp_path_factory.mktemp("routes")), CFG)
    return paths


@pytest.fixture
def copied(monkeypatch):
    """The arrays handed to ``hostmem.to_device`` while the test runs."""
    seen = []
    real = hostmem.to_device

    def spy(x, device, **kw):
        seen.append(x)
        return real(x, device, **kw)

    monkeypatch.setattr(hostmem, "to_device", spy)
    return seen


@pytest.fixture
def loaded(monkeypatch):
    """The :class:`VisData` the file entries read, as the readers return
    them."""
    got = []
    real = inputs.load_vis_data

    def load(path):
        got.append(real(path))
        return got[-1]

    monkeypatch.setattr(runs, "load_vis_data", load)
    return got


def _caller(vd, *fields):
    return {f: getattr(vd, f) for f in fields}


def psf_image(data, loaded, monkeypatch):
    vd = inputs.load_vis_data(data["vis"])
    ds.psf_image(vd, "simple", theta=THETA, lam=LAM, device="cpu")
    return _caller(vd, "uvw", "vis", "antenna1", "antenna2", "time")


def aw_gridding_fused_staged(data, loaded, monkeypatch):
    runs.aw_gridding(data["wkern"], data["akern"], data["vis"],
                     config=CONFIG, device_phases=True, device="cpu")
    return _caller(loaded[0], "uvw", "vis", "antenna1", "antenna2")


def aw_gridding_idg_staged(data, loaded, monkeypatch):
    runs.aw_gridding(None, data["akern"], data["vis"], config=CONFIG,
                     idg=True, device_phases=True, device="cpu")
    return _caller(loaded[0], "uvw", "vis", "antenna1", "antenna2")


def aw_idg_cube(data, loaded, monkeypatch):
    vd = inputs.load_vis_data(data["vis"])
    ak = inputs.get_akernels(data["akern"], THETA, float(vd.time[0]),
                             vd.frequency)
    spectral.aw_idg_cube(vd, ak, theta=THETA, lam=LAM, device="cpu")
    return _caller(vd, "uvw", "vis_chan", "antenna1", "antenna2")


def w_image_streamed(data, loaded, monkeypatch):
    vd = inputs.load_vis_data(data["vis"])
    bank, centres = inputs.get_wkernels(data["wkern"], THETA)
    n = vd.uvw.shape[0]
    readers = {"uvw": lambda s0, c: vd.uvw[s0:s0 + c],
               "vis": lambda s0, c: vd.vis[s0:s0 + c]}
    ds.w_image_streamed(readers, n, vd.frequency, bank, centres,
                        theta=THETA, lam=LAM, slab=n // 3, device="cpu",
                        timer=PhaseTimer())
    return _caller(vd, "uvw", "vis")


def load_vis_sharded(data, loaded, monkeypatch):
    reads = {}
    real = h5.read_dataset_slice

    def read(path, name, start, count):
        reads[name] = real(path, name, start, count)
        return reads[name]

    monkeypatch.setattr(h5, "read_dataset_slice", read)
    mesh = Mesh(None, 0, 1, torch.device("cpu"))
    ingest.load_vis_sharded(data["vis"], mesh)
    return reads


ENTRIES = [psf_image, aw_gridding_fused_staged, aw_gridding_idg_staged,
           aw_idg_cube, w_image_streamed, load_vis_sharded]


@pytest.mark.parametrize("entry", ENTRIES, ids=[e.__name__ for e in ENTRIES])
def test_caller_arrays_reach_the_device_through_to_device(
        entry, data, copied, loaded, monkeypatch):
    caller = entry(data, loaded, monkeypatch)
    assert caller
    arrays = [x for x in copied if isinstance(x, np.ndarray)]
    for name, arr in caller.items():
        assert any(np.shares_memory(x, arr) for x in arrays), \
            f"{entry.__name__}: {name} reached the device another way"
