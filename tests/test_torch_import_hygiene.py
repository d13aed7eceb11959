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
    "openintel_tpu_torch.application",
    "openintel_tpu_torch.application.analyze",
    "openintel_tpu_torch.application.pulse",
    "openintel_tpu_torch.application.request",
    "openintel_tpu_torch.application.risk",
    "openintel_tpu_torch.cli",
    "openintel_tpu_torch.cli.main",
    "openintel_tpu_torch.cli.render",
    "openintel_tpu_torch.cli.setup",
    "openintel_tpu_torch.config",
    "openintel_tpu_torch.config.secrets",
    "openintel_tpu_torch.config.settings",
    "openintel_tpu_torch.config.store",
    "openintel_tpu_torch.convert",
    "openintel_tpu_torch.domain",
    "openintel_tpu_torch.domain.engine",
    "openintel_tpu_torch.domain.engine_batch",
    "openintel_tpu_torch.domain.entities",
    "openintel_tpu_torch.domain.ports",
    "openintel_tpu_torch.domain.risk",
    "openintel_tpu_torch.domain.values",
    "openintel_tpu_torch.errors",
    "openintel_tpu_torch.index",
    "openintel_tpu_torch.index.build",
    "openintel_tpu_torch.index.checkpoint",
    "openintel_tpu_torch.index.pipeline",
    "openintel_tpu_torch.index.schema",
    "openintel_tpu_torch.index.synthetic",
    "openintel_tpu_torch.mcp",
    "openintel_tpu_torch.mcp.server",
    "openintel_tpu_torch.mcp.tools",
    "openintel_tpu_torch.models",
    "openintel_tpu_torch.models.checkpoint",
    "openintel_tpu_torch.models.embedding",
    "openintel_tpu_torch.models.encoder",
    "openintel_tpu_torch.models.eval",
    "openintel_tpu_torch.models.lexicon",
    "openintel_tpu_torch.models.neural_analyzer",
    "openintel_tpu_torch.models.reranker",
    "openintel_tpu_torch.models.retrievers",
    "openintel_tpu_torch.models.train",
    "openintel_tpu_torch.models.updatable",
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
    "openintel_tpu_torch.parallel",
    "openintel_tpu_torch.parallel.distributed",
    "openintel_tpu_torch.parallel.mesh",
    "openintel_tpu_torch.parallel.retriever",
    "openintel_tpu_torch.parallel.sharded",
    "openintel_tpu_torch.parallel.tensor",
    "openintel_tpu_torch.parallel.updatable",
    "openintel_tpu_torch.sources",
    "openintel_tpu_torch.sources.bluesky",
    "openintel_tpu_torch.sources.fixtures",
    "openintel_tpu_torch.sources.http",
    "openintel_tpu_torch.sources.reddit",
    "openintel_tpu_torch.sources.x",
    "openintel_tpu_torch.sources.yahoo",
    "openintel_tpu_torch.tools",
    "openintel_tpu_torch.tools.common",
    "openintel_tpu_torch.tools.grouped_ab",
    "openintel_tpu_torch.tools.kernel_decomp",
    "openintel_tpu_torch.tools.serving_ab",
    "openintel_tpu_torch.tools.topk_reduce_ab",
    "openintel_tpu_torch.utils",
    "openintel_tpu_torch.utils.profiling",
    "openintel_tpu_torch.utils.retry",
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


def test_port_entry_points_import_nothing_of_jax_or_ml_dtypes(tmp_path):
    """The CLI's ``index`` and ``search`` (every mode), the MCP server's
    ``search_corpus`` through the coalescer and a live corpus's update
    tools, in a subprocess: no ``jax``, no ``openintel_tpu`` and no
    ``ml_dtypes`` module is loaded, and no card is touched."""
    code = (
        "import asyncio, contextlib, io, json, sys, torch\n"
        "from openintel_tpu_torch.cli.main import main\n"
        "from openintel_tpu_torch.mcp.server import build_server\n"
        "open('c.txt', 'w').write('apple beats earnings\\nnvda to the moon\\nrates rise\\n')\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    assert main(['index', 'c.txt', '--out', 'idx', '--dim', '16', '--bf16']) == 0\n"
        "    for mode in ('hybrid', 'bm25', 'dense'):\n"
        "        assert main(['search', 'apple', '--index', 'idx', '--mode', mode,\n"
        "                     '--device', 'cpu', '--format', 'json']) == 0\n"
        "def call(server, name, args):\n"
        "    msg = {'jsonrpc': '2.0', 'id': 1, 'method': 'tools/call',\n"
        "           'params': {'name': name, 'arguments': args}}\n"
        "    resp = asyncio.run(server.handle(msg))\n"
        "    assert not resp['result']['isError'], resp\n"
        "call(build_server(index='idx', device='cpu'), 'search_corpus', {'queries': ['apple']})\n"
        "live = build_server(index='idx', device='cpu', updatable=True)\n"
        "call(live, 'index_documents', {'texts': ['fresh apple doc']})\n"
        "call(live, 'delete_documents', {'ids': [0]})\n"
        "call(live, 'search_corpus', {'queries': ['apple'], 'k': 3})\n"
        "call(live, 'compact_corpus', {'save': True})\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'openintel_tpu', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"


def test_port_encoder_loop_imports_nothing_of_jax_or_ml_dtypes(tmp_path):
    """``train``, ``index --encoder`` and ``search --encoder`` on the CLI
    and an MCP server with the encoder, on the CPU, in a subprocess: no
    ``jax``, no ``openintel_tpu`` and no ``ml_dtypes`` module is loaded,
    and no card is touched."""
    code = (
        "import asyncio, contextlib, io, sys, torch\n"
        "from openintel_tpu_torch.cli.main import main\n"
        "from openintel_tpu_torch.mcp.server import build_server\n"
        "open('c.txt', 'w').write('apple beats earnings\\nnvda to the moon\\nrates rise\\n')\n"
        "cpu = ['--device', 'cpu']\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    assert main(['train', 'c.txt', '--out', 'ck', '--dim', '16', '--depth', '1',\n"
        "                 '--heads', '2', '--steps', '2', '--batch-size', '3', *cpu]) == 0\n"
        "    assert main(['index', 'c.txt', '--out', 'idx', '--encoder', 'ck', *cpu]) == 0\n"
        "    assert main(['search', 'apple', '--index', 'idx', '--encoder', 'ck', *cpu]) == 0\n"
        "msg = {'jsonrpc': '2.0', 'id': 1, 'method': 'tools/call',\n"
        "       'params': {'name': 'search_corpus', 'arguments': {'queries': ['apple']}}}\n"
        "server = build_server(index='idx', encoder='ck', device='cpu')\n"
        "assert not asyncio.run(server.handle(msg))['result']['isError']\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'openintel_tpu', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"


def test_port_item12_paths_import_nothing_of_jax_or_ml_dtypes(tmp_path):
    """``train --reranker --analyzer``, ``search --rerank``, ``evaluate
    --rerank``, an MCP server with ``rerank``, the lexicon's device path,
    ``analyze_batch`` and ``risk_screen`` on the CPU, in a subprocess: no
    ``jax``, no ``openintel_tpu`` and no ``ml_dtypes`` module is loaded,
    and no card is touched."""
    code = (
        "import asyncio, contextlib, datetime, io, sys, torch\n"
        "from openintel_tpu_torch.cli.main import main\n"
        "from openintel_tpu_torch.mcp.server import build_server\n"
        "open('c.txt', 'w').write('apple beats earnings\\nnvda to the moon\\nrates rise\\n')\n"
        "cpu = ['--device', 'cpu']\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    assert main(['train', 'c.txt', '--out', 'ck', '--dim', '16', '--depth', '1', '--heads', '2',\n"
        "                 '--steps', '2', '--batch-size', '3', '--reranker', '--analyzer', *cpu]) == 0\n"
        "    assert main(['index', 'c.txt', '--out', 'idx', '--dim', '16']) == 0\n"
        "    assert main(['search', 'apple', '--index', 'idx', '--rerank', 'ck', *cpu]) == 0\n"
        "    assert main(['evaluate', 'c.txt', '--n-synthetic', '3', '--dim', '16', '--rerank', 'ck', *cpu]) == 0\n"
        "msg = {'jsonrpc': '2.0', 'id': 1, 'method': 'tools/call',\n"
        "       'params': {'name': 'search_corpus', 'arguments': {'queries': ['apple']}}}\n"
        "assert not asyncio.run(build_server(index='idx', rerank='ck', device='cpu').handle(msg))['result']['isError']\n"
        "from openintel_tpu_torch.models.lexicon import score_texts\n"
        "from openintel_tpu_torch.models.neural_analyzer import load_analyzer\n"
        "assert len(score_texts(['moon calls'] * 600, device='cpu')) == 600\n"
        "assert len(load_analyzer('ck', device='cpu').score_texts(['moon'])) == 1\n"
        "from openintel_tpu_torch.application.analyze import analyze_batch\n"
        "from openintel_tpu_torch.application.request import AnalysisRequest\n"
        "from openintel_tpu_torch.application.risk import risk_screen\n"
        "from openintel_tpu_torch.domain.values import Bar\n"
        "from openintel_tpu_torch.utils import DeviceTimer\n"
        "class Bars:\n"
        "    async def bars(self, t):\n"
        "        return [Bar(101.0, 99.0, 100.0)] + [Bar(108.0, 104.0, 106.0)] * 15\n"
        "now = datetime.datetime(2026, 1, 1)\n"
        "assert asyncio.run(risk_screen(['NVDA'], 'long', 200.0, 2.0, Bars(), now, device='cpu'))[0].stop == 98.0\n"
        "out = asyncio.run(analyze_batch([AnalysisRequest(ticker='x!')], [], None, now=now, device='cpu'))\n"
        "assert isinstance(out[0], Exception)\n"
        "DeviceTimer(reps=1).timeit(lambda: torch.ones(2))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'openintel_tpu', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"


def test_port_analysis_surface_imports_nothing_of_jax_or_ml_dtypes(tmp_path):
    """``analyze``, ``scan``, ``compare``, ``risk`` over several tickers
    and ``doctor --device cpu`` through the CLI, and the MCP server's
    analysis tools, on the CPU, in a subprocess: no ``jax``, no
    ``openintel_tpu`` and no ``ml_dtypes`` module is loaded, and no card
    is touched."""
    code = (
        "import asyncio, contextlib, io, sys, torch\n"
        "from openintel_tpu_torch.cli.main import main\n"
        "from openintel_tpu_torch.mcp.server import build_server\n"
        "cpu = ['--device', 'cpu']\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    assert main(['analyze', 'AAPL', '--offline', *cpu]) == 0\n"
        "    assert main(['scan', 'AAPL', 'TSLA', '--offline', '--format', 'json', *cpu]) == 0\n"
        "    assert main(['compare', 'AAPL', 'TSLA', '--offline', *cpu]) == 0\n"
        "    assert main(['risk', 'NVDA', 'AMD', '--budget', '200', '--offline', *cpu]) == 0\n"
        "    assert main(['doctor', *cpu]) == 0\n"
        "server = build_server(offline=True, device='cpu')\n"
        "for name, args in (('scan_watchlist', {'tickers': ['AAPL']}), ('list_sources', {}),\n"
        "                   ('risk_frame', {'ticker': 'NVDA', 'budget_usd': 200.0})):\n"
        "    msg = {'jsonrpc': '2.0', 'id': 1, 'method': 'tools/call',\n"
        "           'params': {'name': name, 'arguments': args}}\n"
        "    assert not asyncio.run(server.handle(msg))['result']['isError']\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'openintel_tpu', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"


def test_port_parallel_serving_imports_nothing_of_jax_or_ml_dtypes(tmp_path):
    """The sharded retriever (2x4 on the CPU, every mode, a filter), the
    sharded live corpus and ``search --mesh`` through the CLI, in a
    subprocess: no ``jax``, no ``openintel_tpu`` and no ``ml_dtypes``
    module is loaded, and no card is touched."""
    code = (
        "import contextlib, io, json, sys, numpy as np, torch\n"
        "from openintel_tpu_torch.parallel import make_mesh\n"
        "from openintel_tpu_torch.parallel.retriever import ShardedHybridRetriever\n"
        "from openintel_tpu_torch.parallel.updatable import ShardedUpdatableHybridRetriever\n"
        "from openintel_tpu_torch.index.build import build_postings_index\n"
        "from openintel_tpu_torch.index.schema import DenseIndex\n"
        "from openintel_tpu_torch.models.embedding import HashingEmbedder\n"
        "from openintel_tpu_torch.cli.main import main\n"
        "docs = ['apple beats earnings', 'nvda to the moon', 'rates rise again'] * 7\n"
        "p = build_postings_index(docs)\n"
        "e = HashingEmbedder(dim=16)\n"
        "d = DenseIndex.from_embeddings(e(docs))\n"
        "r = ShardedHybridRetriever(p, d, e, data=2, corpus=4, device='cpu')\n"
        "for mode in ('hybrid', 'bm25', 'dense'):\n"
        "    assert r.search(['apple moon'] * 3, k=2, mode=mode).ids.shape == (3, 2)\n"
        "mask = np.arange(21) % 2 == 0\n"
        "assert r.search(['apple'], k=2, filter_mask=mask).ids.shape == (1, 2)\n"
        "u = ShardedUpdatableHybridRetriever(p, d, e, data=1, corpus=4, device='cpu')\n"
        "u.add_documents(['fresh apple'])\n"
        "u.delete_ids([0])\n"
        "assert u.search(['apple'], k=3).ids.shape == (1, 3)\n"
        f"open({str(tmp_path / 'c.txt')!r}, 'w').write('\\n'.join(docs))\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out):\n"
        f"    assert main(['index', {str(tmp_path / 'c.txt')!r}, '--out', {str(tmp_path / 'i')!r}, '--dim', '16']) == 0\n"
        f"    assert main(['search', 'apple', '--index', {str(tmp_path / 'i')!r}, '--mesh', '2x4', '--device', 'cpu', '--format', 'json']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'openintel_tpu', 'ml_dtypes'))\n"
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


def test_port_mesh_training_imports_nothing_of_jax_or_ml_dtypes(tmp_path):
    """``train_encoder`` over a 2x2 CPU mesh (params tensor parallel, a
    resume on one device) and ``train --mesh 1x2`` through the CLI, in a
    subprocess: no ``jax``, no ``openintel_tpu`` and no ``ml_dtypes``
    module is loaded, and no card is touched."""
    code = (
        "import contextlib, io, sys, torch\n"
        "from openintel_tpu_torch.cli.main import main\n"
        "from openintel_tpu_torch.models.encoder import EncoderConfig\n"
        "from openintel_tpu_torch.models.train import train_encoder\n"
        "from openintel_tpu_torch.parallel.mesh import make_mesh\n"
        "docs = ['apple beats earnings', 'nvda to the moon', 'rates rise again'] * 3\n"
        "cfg = EncoderConfig(vocab_size=64, dim=16, depth=1, heads=2, max_len=8)\n"
        "mesh = make_mesh(data=2, corpus=2, device='cpu')\n"
        "res = train_encoder(docs, cfg, steps=2, batch_size=4, mesh=mesh, ckpt_dir='ck', device='cpu')\n"
        "assert len(res.losses) == 2\n"
        "assert len(train_encoder(docs, cfg, steps=3, batch_size=4, ckpt_dir='ck', device='cpu').losses) == 1\n"
        "open('c.txt', 'w').write('\\n'.join(docs))\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    assert main(['train', 'c.txt', '--out', 'ck2', '--mesh', '1x2', '--dim', '16', '--depth', '1',\n"
        "                 '--heads', '2', '--steps', '2', '--batch-size', '3', '--device', 'cpu']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'openintel_tpu', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"


def test_port_sources_hold_no_jax_and_no_compile():
    """No module of the port, and not ``chip_smoke.py``, imports jax, the
    JAX package or ``ml_dtypes`` (any import statement, lazy ones included)
    or compiles."""
    for path in [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]:
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "import ml_dtypes" not in text, path
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
