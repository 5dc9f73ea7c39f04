"""The program's contract with the machine it runs on: the device peak
table, the compile-cache placement, the GPU-only smoke script, and that no
module keeps a path for another accelerator."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("kind,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12),
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_device_peak_flops(kind, peak):
    """The H100 SXM's published bf16 dense peak; any other device kind is
    an error, never a default."""
    from benchmarks.flops import device_peak_flops

    if peak is None:
        with pytest.raises(ValueError, match="no peak"):
            device_peak_flops(kind)
    else:
        assert device_peak_flops(kind) == peak


@pytest.mark.parametrize("env_dir", [True, False])
def test_compilation_cache_placement(env_dir, tmp_path, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set the program sets no directory of
    its own; without it the cache goes to <checkout>/.jax_cache."""
    import jax

    from gaussian_process_edge_trace_tpu.utils import cache

    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.enable_compilation_cache() == str(tmp_path)
        assert "jax_compilation_cache_dir" not in updates
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = str(ROOT / ".jax_cache")
        assert cache.enable_compilation_cache() == want
        assert updates["jax_compilation_cache_dir"] == want


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py needs a GPU: on the CPU it exits non-zero and prints
    no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_no_tpu_only_paths():
    """No module imports Pallas's TPU dialect, compares the backend with
    the TPU's name, or keys interpret mode on the backend."""
    bad = re.compile(r"pallas(\.| import )tpu|pltpu"
                     r"|default_backend\(\)\s*[!=]=\s*[\"']tpu"
                     r"|interpret\s*=\s*jax\.default_backend")
    hits = []
    sources = [p for d in ("gaussian_process_edge_trace_tpu", "benchmarks",
                           "examples", "tests")
               for p in (ROOT / d).rglob("*.py")] + list(ROOT.glob("*.py"))
    for path in sources:
        rel = path.relative_to(ROOT)
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if bad.search(line) and path.name != "test_platform.py":
                hits.append(f"{rel}:{i}: {line.strip()}")
    assert not hits, hits
