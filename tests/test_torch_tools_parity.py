"""Three of the port's measurement tools against the reference's JAX
scripts, each script run as a subprocess with ``JAX_PLATFORMS=cpu`` and
the tool in this process on the CPU, at the same small arguments:

- ``fusion_ab``: the tables equal (the hashing regime, and the neural one
  over a checkpoint the reference trained, which the port loads);
- ``encoder_quality``: the port's run resumes the reference's checkpoint
  (the shared format) and measures the hashing rows equal and the neural
  rows within 0.02 (one encoder, other sum orders);
- ``arrival``: the JSON carries every field the reference's does, and both
  pass ``tests/test_bench_arrival.py``'s checks (the times differ).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from openintel_tpu_torch.tools import arrival, encoder_quality, fusion_ab

REPO = Path(__file__).resolve().parents[1]
EQ_ARGS = [
    "--n-docs", "200", "--n-concepts", "30", "--steps", "3", "--rerank-steps", "1",
    "--batch", "8", "--dim", "16", "--depth", "1", "--heads", "2", "--vocab", "256",
    "--queries", "20",
]
NEURAL_TOL = 0.02


def _script(name: str, args, env=None) -> subprocess.CompletedProcess:
    res = subprocess.run(
        [sys.executable, str(REPO / "scripts" / name), *map(str, args)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu", **(env or {})),
    )
    assert res.returncode == 0, res.stderr[-3000:]
    return res


@pytest.fixture(scope="module")
def reference_encoder(tmp_path_factory):
    """The reference script's run: its JSON and its checkpoint directory."""
    tmp = tmp_path_factory.mktemp("eq")
    _script("encoder_quality.py", [*EQ_ARGS, "--ckpt-dir", tmp / "ck", "--out", tmp / "ref.json"])
    return json.loads((tmp / "ref.json").read_text()), tmp / "ck"


def test_encoder_quality_matches_the_reference_script(reference_encoder, tmp_path):
    ref, ck = reference_encoder
    out = tmp_path / "port.json"
    argv = [*EQ_ARGS, "--ckpt-dir", str(ck), "--out", str(out), "--device", "cpu"]
    assert encoder_quality.main(argv) == 0
    port = json.loads(out.read_text())
    assert port["encoder_step"] == ref["encoder_step"] == 3
    assert port["train_steps_run"] == 0  # resumed the reference's checkpoint
    assert port["config"] == ref["config"]
    for dist, rows in ref["tables"].items():
        assert set(port["tables"][dist]) == set(rows)
        for name, want in rows.items():
            got = port["tables"][dist][name]
            if name.startswith("hashing"):
                assert got == want, (dist, name)
            else:
                for metric in want:
                    assert abs(got[metric] - want[metric]) <= NEURAL_TOL, (dist, name, metric)
    assert set(port["rerank_uplift_exact"]) == set(ref["rerank_uplift_exact"])
    # the first stage is the hashing hybrid: equal; the reranked rows come
    # from each package's own reranker training
    for key in ("first_stage_mrr@10", "first_stage_recall@10"):
        assert port["rerank_uplift_exact"][key] == ref["rerank_uplift_exact"][key]


def test_fusion_ab_matches_the_reference_script(reference_encoder, tmp_path):
    _, ck = reference_encoder
    args = ["--n-docs", "500", "--n-concepts", "60", "--queries", "30", "--dim", "32", "--encoder", str(ck)]
    _script("fusion_ab.py", [*args, "--out", tmp_path / "ref.json"])
    assert fusion_ab.main([*args, "--out", str(tmp_path / "port.json"), "--device", "cpu"]) == 0
    ref = json.loads((tmp_path / "ref.json").read_text())
    port = json.loads((tmp_path / "port.json").read_text())
    assert port["config"] == ref["config"]
    assert set(port["tables"]) == {"hashing", "neural"}
    assert port["tables"] == ref["tables"]


def _check_curves(doc: dict) -> None:
    """``tests/test_bench_arrival.py``'s checks of the reference's JSON."""
    assert doc["direct_capacity_rps"] > 0 and doc["coalesced_capacity_rps"] > 0
    for mode in ("direct", "coalesced"):
        pts = doc["curves"][mode]
        assert [p["fraction_of_direct_cap"] for p in pts] == [0.5, 1.5]
        for p in pts:
            assert p["completed"] > 0, (mode, p)
            assert p["errors"] == [], (mode, p)
            assert p["p50_ms"] <= p["p95_ms"] <= p["p99_ms"]
            assert p["achieved_rps"] <= p["offered_rps"] * 1.5 + 5


def test_arrival_carries_the_reference_scripts_fields(tmp_path, monkeypatch, capsys):
    args = ["--duration", "0.6", "--fractions", "0.5,1.5", "--request-b", "16", "--max-batch", "64"]
    res = _script("bench_arrival.py", [*args, "--out", tmp_path / "ref.json"], {"BENCH_DOCS": "2000"})
    monkeypatch.setenv("BENCH_DOCS", "2000")
    assert arrival.main([*args, "--out", str(tmp_path / "port.json"), "--device", "cpu"]) == 0
    ref = json.loads((tmp_path / "ref.json").read_text())
    port = json.loads((tmp_path / "port.json").read_text())
    assert ref["backend"] == port["backend"] == "cpu"
    _check_curves(ref)
    _check_curves(port)
    assert set(ref) <= set(port) and set(ref["config"]) <= set(port["config"])
    assert {k: v for k, v in port["config"].items() if k in ref["config"]} == ref["config"]
    for mode in ("direct", "coalesced"):
        for r, p in zip(ref["curves"][mode], port["curves"][mode]):
            assert set(r) == set(p)
    ref_rows = [ln for ln in res.stdout.splitlines() if ln.startswith("|")]
    port_rows = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("|")]
    assert len(port_rows) == len(ref_rows) == 4 and port_rows[0] == ref_rows[0]
