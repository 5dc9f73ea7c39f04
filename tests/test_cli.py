"""CLI smoke test (``python -m gaussian_process_edge_trace_tpu``)."""

import json

import numpy as np
import pytest

from gaussian_process_edge_trace_tpu.__main__ import main
from gaussian_process_edge_trace_tpu.utils.synthetic import construct_test_img


@pytest.mark.slow
def test_cli_trace(tmp_path, capsys):
    img, edge = construct_test_img((72, 72), 22, 2, 0.01, "sinusoidal",
                                   0.3, gaps=False)
    p = tmp_path / "img.npy"
    np.save(p, img)
    out = tmp_path / "res.npz"
    main(["trace", str(p),
          "--init", f"0,{edge[0, 0]}", f"71,{edge[71, 0]}",
          "--sigma-f", "18", "--length-scale", "6",
          "--n-samples", "120", "--delta-x", "5", "--seed", "3",
          "--out", str(out)])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["converged"]
    z = np.load(out)
    assert z["edge_trace"].shape == (72, 2)
    assert np.all(z["cred_upper"] >= z["cred_lower"])


@pytest.mark.slow
def test_cli_batch_and_sequence(tmp_path, capsys):
    from gaussian_process_edge_trace_tpu.utils.image import (
        comp_grad_img, kernel_builder)

    frames = tmp_path / "frames"
    frames.mkdir()
    for f in range(3):
        img, edge = construct_test_img((72, 72), 22, 2, 0.01, "sinusoidal",
                                       0.3, gaps=False, seed=f + 1)
        np.save(frames / f"f{f}.npy", np.asarray(img))
    out_dir = tmp_path / "out"
    common = ["--init", f"0,{edge[0, 0]}", f"71,{edge[71, 0]}",
              "--sigma-f", "18", "--length-scale", "6",
              "--n-samples", "120", "--delta-x", "5", "--seed", "3",
              "--out-dir", str(out_dir)]
    main(["batch", str(frames / "*.npy")] + common)
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    assert lines[-1]["frames"] == 3 and lines[-1]["mode"] == "batch"
    for row in lines[:-1]:
        assert row["converged"]
        z = np.load(row["out"])
        assert z["edge_trace"].shape == (72, 2)

    main(["batch", str(frames / "*.npy"), "--sequence"] + common)
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    assert lines[-1]["mode"] == "sequence"
    assert all(row["converged"] for row in lines[:-1])


def test_console_script_entry_point():
    # pyproject [project.scripts] installs `gpet-tpu`.
    # Exercised when the package is installed (pip install -e .); falls
    # back to invoking the module entry the script points at.
    import shutil
    import subprocess
    import sys

    exe = shutil.which("gpet-tpu")
    cmd = ([exe, "--help"] if exe else
           [sys.executable, "-m", "gaussian_process_edge_trace_tpu",
            "--help"])
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0
    assert "trace" in out.stdout
