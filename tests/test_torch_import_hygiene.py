"""The port imports torch and never jax, nor anything of the JAX package;
it touches no card at import time, runs on the card unless asked for the
CPU, and never falls back when its CUDA kernels cannot be built."""

import ast
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
    "openintel_tpu_torch.index",
    "openintel_tpu_torch.index.build",
    "openintel_tpu_torch.index.schema",
    "openintel_tpu_torch.index.synthetic",
    "openintel_tpu_torch.models",
    "openintel_tpu_torch.models.embedding",
    "openintel_tpu_torch.models.retrievers",
    "openintel_tpu_torch.ops",
    "openintel_tpu_torch.ops._kernels",
    "openintel_tpu_torch.ops.bm25",
    "openintel_tpu_torch.ops.dense",
    "openintel_tpu_torch.ops.dense_topk",
    "openintel_tpu_torch.serving",
    "openintel_tpu_torch.ops.fusion",
    "openintel_tpu_torch.native",
    "openintel_tpu_torch.ops.ranking",
    "openintel_tpu_torch.ops.tokenizer",
    "openintel_tpu_torch.tools",
    "openintel_tpu_torch.tools.common",
    "openintel_tpu_torch.tools.grouped_ab",
    "openintel_tpu_torch.tools.kernel_decomp",
    "openintel_tpu_torch.tools.serving_ab",
    "openintel_tpu_torch.tools.topk_reduce_ab",
]


def _imports_reference(module: str) -> bool:
    return module == "openintel_tpu" or module.startswith("openintel_tpu.")


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


def test_port_imports_nothing_of_the_jax_package_after_a_search():
    """Importing the port and running a small CPU search (the hybrid
    retriever, the int8 candidate op, a measurement tool's core, a short
    pipelined stream and a coalesced call) loads no ``openintel_tpu``
    module and no jax."""
    code = (
        "import importlib, sys, torch\n"
        f"for name in {SLICE!r}:\n"
        "    importlib.import_module(name)\n"
        "from openintel_tpu_torch import HybridRetriever, dense_topk_fast_i8, dot_only\n"
        "from openintel_tpu_torch.tools import kernel_decomp\n"
        "docs = ['apple beats earnings', 'nvda to the moon', 'rates rise again']\n"
        "r = HybridRetriever.build(docs, dim=16, device='cpu')\n"
        "assert r.search(['apple moon'], k=2).ids.shape == (1, 2)\n"
        "c = torch.ones((300, 16), dtype=torch.int8)\n"
        "q = torch.ones((3, 16), dtype=torch.int8)\n"
        "assert dense_topk_fast_i8(c, q, k=4)[1].shape == (3, 4)\n"
        "assert dot_only(c, q).shape == (3, 128)\n"
        "kernel_decomp.decompose(c, q[None], 300, reps=1)\n"
        "from openintel_tpu_torch.serving import BatchCoalescer, PipelinedSearcher\n"
        "waves = [['apple moon'], ['rates', 'nvda earnings']]\n"
        "out = list(PipelinedSearcher(r).search_stream(iter(waves), k=2))\n"
        "assert [o.ids.shape for o in out] == [(1, 2), (2, 2)]\n"
        "assert BatchCoalescer(r.search, max_batch=4).search(['apple'], k=2).ids.shape == (1, 2)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'openintel_tpu'))\n"
        "assert not bad, bad\n"
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
    """No module of the port, and not ``chip_smoke.py``, imports jax or the
    JAX package (any import statement, lazy ones included) or compiles."""
    for path in [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]:
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "torch.compile" not in text, path
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(map(_imports_reference, names)), (path, node.lineno)
        assert not re.search(r"""import_module\(\s*["']openintel_tpu[."']""", text), path


def test_default_device_is_the_card():
    """Entry points run on the card unless the caller passes device="cpu";
    nothing moves to the CPU when no card is present."""
    import torch

    import openintel_tpu_torch

    assert openintel_tpu_torch.default_device() == torch.device("cuda")


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_kernels, "CUDA_ROOT", str(tmp_path / "cuda"))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_kernels.KernelBuildError, match="nvcc"):
        _kernels.build()
    for name in ("oi_i8_top2g", "oi_turbo_f32", "oi_turbo_i4", "oi_turbo_i4_tma",
                 "oi_turbo_i8", "oi_turbo_i8_tma", "oi_dot_only"):
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
        "dot_only.cu", "dot_only_tma.cu", "fused_topk.cu", "fused_topk_v2.cu", "i8_top2g.cu",
        "i8_top2g_tma.cu", "turbo_bf16_tma.cu", "turbo_f32.cu", "turbo_i4.cu",
        "turbo_i4_tma.cu", "turbo_i8.cu", "turbo_i8_tma.cu",
    }
    assert set(_kernels._SIGNATURES) == {
        "oi_dot_only", "oi_dot_only_tma", "oi_fused_topk", "oi_fused_topk_v2",
        "oi_fused_topk_v2_tma",
        "oi_i8_top2g", "oi_i8_top2g_tma",
        "oi_i8_fold", "oi_turbo_bf16_tma", "oi_turbo_f32", "oi_turbo_i4",
        "oi_turbo_i4_tma", "oi_turbo_i8", "oi_turbo_i8_tma",
    }
    assert {p.name for p in _kernels.headers()} == {"tma_stream.cuh", "turbo_common.cuh"}


def test_package_data_ships_every_included_kernel_file():
    """Every kernel source, every file a source includes with ``#include
    "..."``, and the port's native C++ sources are matched by the
    package-data globs, so an installed (non-editable) package can still
    build the kernels and the native library."""
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
    from openintel_tpu_torch import native

    cpp = set((PORT / "native").glob("*.cpp"))
    assert set(native._SRCS) == cpp and {p.name for p in cpp} == {
        "planner.cpp", "postings.cpp", "tokenizer.cpp"
    }
    assert cpp <= shipped, sorted(p.name for p in cpp - shipped)
