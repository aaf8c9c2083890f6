"""The port's ``--distributed`` CLI on the CPU: two OS processes of ``python
-m ska_sdp_tpu_torch.cli --distributed --device cpu`` meeting at
``SKA_SDP_TPU_COORDINATOR=127.0.0.1:<free port>`` (gloo), as the JAX
package's ``tests/test_parallel.py`` runs its own.

* ``--mode w`` and ``--mode idg``: rank 0's ``/img`` within 1e-5 (rel-L2;
  IDG over the central 75%) of the single-process image of the same mode,
  and rank 1 writes nothing;
* ``--mode idg --channels 4``: the two-process cube within 1e-5 (central
  75%) of the one-process ``--distributed`` cube (a world of one);
* ``--mode predict --distributed`` exits 1 with the reference's message.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from ska_sdp_tpu_torch import cli
from ska_sdp_tpu_torch.io import h5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEO = ["--theta", "0.05", "--lam", "2560"]       # a 128² grid
TOL = 1e-5


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _crop(a):
    c = a.shape[-1] // 8
    return a[..., c:-c, c:-c]


@pytest.fixture(scope="module")
def obs_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist") / "obs")
    assert cli.main(["--make-data", d, "--nant", "8", "--ntime", "6",
                     "--nw", "4", "--qpx", "2", "--nchan", "4", *GEO]) == 0
    return d


def _two_processes(argv, tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO,
                   SKA_SDP_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   SKA_SDP_TPU_NPROCS="2", SKA_SDP_TPU_PROC_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ska_sdp_tpu_torch.cli", "--distributed",
             "--device", "cpu", *argv, *GEO], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=str(tmp_path)))
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [out for out, _ in outs]


@pytest.mark.parametrize("mode", ["w", "idg"])
def test_two_processes_match_one(obs_dir, tmp_path, mode):
    one = str(tmp_path / "one.h5")
    assert cli.main(["--mode", mode, "-i", obs_dir, "--all", "-o", one,
                     "--device", "cpu", *GEO]) == 0
    outs = _two_processes(["--mode", mode, "-i", obs_dir, "--all", "-o",
                           "two.h5"], tmp_path)
    for out in outs:
        assert "distributed: 2 process(es), 2 device(s), mesh axes " \
            "('host', 'vis')" in out
        assert "image max: " in out
    got = h5.read_dataset(str(tmp_path / "two.h5"), "/img")
    want = h5.read_dataset(one, "/img")
    assert got.shape == want.shape == (128, 128)
    sel = _crop if mode == "idg" else (lambda a: a)
    assert _rel(sel(got), sel(want)) < TOL


def test_two_process_cube(obs_dir, tmp_path, capsys):
    one = str(tmp_path / "one.h5")
    argv = ["--mode", "idg", "--channels", "4", "-i", obs_dir, "--all"]
    assert cli.main([*argv, "-o", one, "--distributed", "--device", "cpu",
                     *GEO]) == 0
    assert "imaged 4 channels (sharded over 1 devices)" in \
        capsys.readouterr().out
    outs = _two_processes([*argv, "-o", "two.h5"], tmp_path)
    assert all("imaged 4 channels (sharded over 2 devices)" in o
               for o in outs)
    got = h5.read_dataset(str(tmp_path / "two.h5"), "/img_cube")
    want = h5.read_dataset(one, "/img_cube")
    assert got.shape == want.shape == (4, 128, 128)
    for c in range(4):
        assert _rel(_crop(got[c]), _crop(want[c])) < TOL


def test_unsupported_mode_exits_1(obs_dir, tmp_path, capsys):
    model = str(tmp_path / "m.h5")
    assert cli.main(["--mode", "w", "-i", obs_dir, "--all", "-o", model,
                     "--device", "cpu", *GEO]) == 0
    assert cli.main(["--mode", "predict", "--model", model, "-i", obs_dir,
                     "--all", "--distributed", "--device", "cpu",
                     *GEO]) == 1
    cap = capsys.readouterr()
    assert "distributed: 1 process(es), 1 device(s)" in cap.out
    assert ("--distributed supports --mode w, --mode idg and --mode idg "
            "--channels N") in cap.err
    import torch.distributed as dist

    assert not dist.is_initialized()        # the group is gone again
