"""The port imports torch and never jax, touches no card at import time, and
never falls back when its CUDA kernels cannot be built."""

import os
import re
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

from openintel_tpu_torch.ops import _kernels

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "openintel_tpu_torch"
SLICE = [
    "openintel_tpu_torch",
    "openintel_tpu_torch.convert",
    "openintel_tpu_torch.models",
    "openintel_tpu_torch.models.embedding",
    "openintel_tpu_torch.models.retrievers",
    "openintel_tpu_torch.ops",
    "openintel_tpu_torch.ops._kernels",
    "openintel_tpu_torch.ops.bm25",
    "openintel_tpu_torch.ops.dense",
    "openintel_tpu_torch.ops.dense_topk",
    "openintel_tpu_torch.ops.fusion",
    "openintel_tpu_torch.ops.ranking",
]


def test_port_imports_no_jax_and_initialises_no_cuda():
    code = (
        "import importlib, sys, torch\n"
        f"for name in {SLICE!r}:\n"
        "    importlib.import_module(name)\n"
        "import openintel_tpu_torch as p\n"
        "assert p.HybridRetriever.__module__.endswith('retrievers')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"


def test_port_sources_hold_no_jax_and_no_compile():
    for path in PORT.rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "torch.compile" not in text, path


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_kernels, "CUDA_ROOT", str(tmp_path / "cuda"))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_kernels.KernelBuildError, match="nvcc"):
        _kernels.build()
    for name in ("oi_i8_top2g", "oi_turbo_f32", "oi_turbo_i4"):
        with pytest.raises(_kernels.KernelBuildError, match="nvcc"):
            _kernels.launch(name)
    assert not (tmp_path / "build").exists()


def test_library_name_follows_the_sources():
    """The build is cached by a hash of the sources, headers and flags, so
    a change to any kernel source or shared header builds a new library."""
    so = _kernels.library_path()
    assert so.parent == _kernels.BUILD_DIR
    assert so.name.startswith("libopenintel_tpu_torch_") and so.suffix == ".so"
    assert {p.name for p in _kernels.sources()} == {
        "fused_topk.cu", "i8_top2g.cu", "turbo_f32.cu", "turbo_i4.cu"
    }
    assert {p.name for p in _kernels.headers()} == {"turbo_common.cuh"}


def test_package_data_ships_every_included_kernel_file():
    """Every kernel source, and every file a source includes with
    ``#include "..."``, is matched by the package-data globs, so an
    installed (non-editable) package can still build the kernels."""
    with open(REPO / "pyproject.toml", "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "openintel_tpu_torch"
        ]
    shipped = {p for g in globs for p in PORT.glob(g)}
    csrc = _kernels.CSRC
    needed = set(_kernels.sources())
    for src in sorted(needed):
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', src.read_text(), re.M):
            inc = (src.parent / name).resolve()
            assert inc.is_file(), f"{src.name} includes missing {name}"
            needed.add(inc)
    assert needed and all(p.parent == csrc for p in needed)
    assert needed <= shipped, sorted(p.name for p in needed - shipped)
    assert set(_kernels.headers()) <= shipped
