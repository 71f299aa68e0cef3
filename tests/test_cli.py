"""The CLI end to end without matplotlib: the main path needs only jax,
numpy, scipy and the standard library; figures are skipped and logged."""

import glob
import json
import os
import sys

import numpy as np


def test_cli_runs_without_matplotlib(tmp_path, monkeypatch, capsys):
    from cnmf_e_tpu.io.tiff import write_tiff
    from cnmf_e_tpu.run import main
    from cnmf_e_tpu.utils.simulate import simulate_movie

    gt = simulate_movie(seed=33, H=32, W=32, T=200, K=4, gSig=2.5,
                        sn=0.08, bg_strength=0.7, min_dist=10.0,
                        spike_rate=0.04)
    movie = str(tmp_path / "movie.tif")
    write_tiff(movie, gt.Y)
    # an entry of None in sys.modules makes `import matplotlib` raise
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    # keep the CLI from pointing this test process's compile cache at the
    # checkout (with the variable set it configures nothing)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    rc = main([movie, "--workdir", str(tmp_path / "out"), "--gsig", "2.5",
               "--gsiz", "8", "--min-corr", "0.8", "--min-pnr", "8",
               "--ring-radius", "6", "--max-neurons", "8", "--quiet"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    run_dir = summary["run_dir"]
    assert summary["n_neurons"] > 0
    assert os.path.exists(os.path.join(run_dir, "results.npz"))
    assert not glob.glob(os.path.join(run_dir, "*.png"))
    log = open(os.path.join(run_dir, "logs.txt")).read()
    assert "summary figure skipped: matplotlib is not installed" in log
    res = np.load(os.path.join(run_dir, "results.npz"))
    assert np.all(np.isfinite(res["C"]))
