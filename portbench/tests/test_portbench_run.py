"""Each traffic mix end to end on the CPU at a toy size: the result line's
keys, the metrics each mix reports, a toy cell added as new files, and the
modules a run leaves loaded."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import MIXES, REPO, run_toy, tree_digest

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("mix", MIXES + ("live",))
def test_each_mix_runs_and_is_correct(toy_root, mix):
    res = run_toy(toy_root, mix)
    rec = res.pop("_record")
    assert min(rec["window"].latencies, default=1.0) > 0
    assert list(res)[:5] == KEYS and list(res)[-1] == "check"
    assert res["correct"] is True, res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"
    metrics = res["metrics"]
    assert {"setup_s", "recall_at_10"} <= set(metrics)
    if mix != "requests":
        assert metrics["batch_qps"]["value"] > 0
    for v in res["check"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(res)  # the line is plain JSON


@pytest.mark.parametrize("mix", MIXES)
def test_traced_run_reports_the_mix_per_layer_metrics(toy_root, mix):
    res = run_toy(toy_root, mix, trace=True)
    rec = res.pop("_record")
    assert res["device"]["window_s"] > 0
    names = set(res["metrics"])
    # on the CPU nothing runs on a device: device metrics stay out
    assert not names & {"dense_roofline_pct", "launches_per_subbatch.batch",
                        "bm25_fusion_device_ms_per_subbatch", "device_idle_pct.batch"}
    expect = {
        "hybrid-batch": {"prepare_us_per_query.batch", "step_host_ms_per_subbatch.batch"},
        "dense-batch": {"step_host_ms_per_subbatch.batch"},
        "requests": set(),  # no per-layer metric lists an open-loop cell yet
        "filtered-batch": {"prepare_us_per_query.batch", "step_host_ms_per_subbatch.batch",
                           "fallback_share.filtered"},
    }[mix]
    assert expect <= names, names
    assert rec["spans"]["prepare"]["calls"] > 0 or mix == "dense-batch"
    if mix == "requests":
        from portbench.harness import bench

        assert bench.reader(toy_root, "prepare_us_per_query.batch")(rec) > 0


def test_span_without_calls_yields_no_metric(toy_root):
    """The dense cell never calls prepare: a reader of that span returns
    None rather than 0."""
    from portbench.harness import bench

    res = run_toy(toy_root, "dense-batch", trace=True)
    rec = res.pop("_record")
    assert rec["spans"]["prepare"]["calls"] == 0
    assert bench.reader(toy_root, "prepare_us_per_query.batch")(rec) is None
    assert bench.reader(toy_root, "fallback_share.filtered")(rec) is None
    assert bench.reader(toy_root, "bm25_fusion_device_ms_per_subbatch")(rec) is None


def test_new_kind_of_traffic_is_a_new_driver_file(tmp_path):
    """A driver added as ``drivers/<entry>.py``, with a mix and a cell that
    name it, runs without an edit to any file the benchmark has."""
    from conftest import make_toy_root

    root = make_toy_root(tmp_path)
    before = tree_digest(root / "portbench")
    here = root / "portbench"
    (here / "drivers/halfbatch.py").write_text(
        "from portbench.drivers import dense\n"
        "HYBRID, plan = dense.HYBRID, dense.plan\n"
        "def build(cfg, traffic, inputs, seed, device):\n"
        "    d = dense.build(cfg, dict(traffic, batch=traffic['batch'] // 2), inputs, seed, device)\n"
        "    d.halved = True\n"
        "    return d\n"
    )
    tr = json.loads((here / "traffic/toy-dense-batch.json").read_text())
    (here / "traffic/toy-halfbatch.json").write_text(json.dumps(dict(tr, entry="halfbatch")))
    (here / "limits/toy.halfbatch.json").write_text((here / "limits/toy.dense-batch.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(
        {"name": "toy.halfbatch", "config": "toy", "traffic": "toy-halfbatch", "chips": 1, "why": "tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run_toy(root, "halfbatch")
    rec = res.pop("_record")
    assert res["correct"] is True, res["check"]
    assert {len(a[0]) for a in rec["window"].answers} == {tr["batch"] // 2}
    after = tree_digest(root / "portbench")
    assert not [f for f in before if after.get(f) != before[f]]


def test_same_seed_same_inputs(toy_root):
    import torch

    from portbench.harness import bench, runner

    cell = bench.load_cell(toy_root, "toy.filtered-batch", False)
    a = runner.make_inputs(cell.config, cell.traffic, 2**31 + 11, torch.device("cpu"), True)
    b = runner.make_inputs(cell.config, cell.traffic, 2**31 + 11, torch.device("cpu"), True)
    assert a.pool.texts == b.pool.texts
    assert (a.pool.emb == b.pool.emb).all() and (a.masks == b.masks).all()
    assert torch.equal(a.rows, b.rows) and (a.postings.doc_ids == b.postings.doc_ids).all()


def test_no_jax_module_after_a_run(toy_root, tmp_path):
    """A cell run in a fresh process leaves no module whose top-level name
    is jax or the JAX package loaded."""
    code = (
        "import sys, time; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from conftest import run_toy\n"
        "from pathlib import Path\n"
        "run_toy(Path(%r), 'hybrid-batch')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'openintel_tpu'}))\n"
    ) % (str(REPO), str(REPO / "portbench" / "tests"), str(toy_root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_py_refuses_without_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "msmarco-shard-int8.hybrid-batch",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"} | {
            k: v for k, v in __import__("os").environ.items() if k in ("HOME", "PYTHONPATH")},
    )
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_py_fails_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, a run
    exits non-zero and prints no result."""
    import shutil

    shutil.copytree(REPO / "portbench", tmp_path / "portbench")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "msmarco-shard-int8.hybrid-batch",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_host_shares_from_two_readings():
    from portbench.harness.window import host_shares

    a = {"proc_cpu_s": 1.0, "t": 10.0, "load1": 0.5, "jiffies": (1000, 800, 10), "stall_us": 0}
    b = {"proc_cpu_s": 1.5, "t": 12.0, "load1": 1.5, "jiffies": (1200, 900, 30), "stall_us": 200_000}
    assert host_shares(a, b) == pytest.approx(
        {"proc_cpu_pct": 25.0, "load1": [0.5, 1.5], "busy_pct": 50.0, "steal_pct": 10.0,
         "cpu_stall_pct": 10.0})
    # a host that shows nothing leaves only the process's own share
    assert host_shares({"proc_cpu_s": 0.0, "t": 0.0}, {"proc_cpu_s": 1.0, "t": 2.0}) == {
        "proc_cpu_pct": 50.0}
