"""Toy cells for the harness's CPU tests: a copy of ``portbench/`` and of
``BENCHMARK.json`` in a temporary directory, with one small configuration,
small copies of the traffic mixes, an open-loop mix of ``search_corpus``
requests, a live corpus under writes (its own configuration, mix, limits
and driver, ``live_driver.py``), and their limits added as new files and
new entries. The program runs its kernels' plain twins on the CPU."""

from __future__ import annotations

import hashlib
import json
import shutil
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

FILED = ("hybrid-batch", "dense-batch", "filtered-batch")  # mixes in traffic/
MIXES = FILED + ("requests",)
TOY = {"n_docs": 20000, "dim": 64, "vocab_size": 3000}
TOY_TRAFFIC = {"filtered-batch": {"masks": [[0.5, 2], [0.01, 2]]}}
# the filtered mix has no committed cell: its toy reports what the hybrid
# cell reports, and the fallback's share as a new entry
LIKE = {"filtered-batch": "hybrid-batch"}
FALLBACK_SHARE = {
    "name": "fallback_share.filtered", "unit": "%", "better": "lower", "source": "program_span",
    "layer": "filtered fallback", "moves": "batch_qps", "workloads": ["toy.filtered-batch"],
}
# the open-loop driver's mix: no committed cell runs it yet
REQUESTS = {
    "entry": "requests", "loop": "open", "rate_rps": 20.0,
    "sizes": {"single_share": 0.5, "range": [2, 64]}, "k": 10,
    "coalescer": {"max_batch": 256, "max_wait_ms": 2.0}, "workers": 16, "warm_bursts": 1,
    "queries": {"pool": 2048}, "trace_seconds": 3.0,
}

# the live corpus under writes: no committed cell runs it yet
LIVE = {
    "entry": "live", "loop": "closed", "wave": 256, "k": 10, "candidates_per_arm": 20,
    "writes": {"pool": 3000, "add_batch": 400, "delete_batch": 100},
    "queries": {"pool": 2048}, "warm_waves": 1, "trace_seconds": 3.0,
}
LIVE_LIMITS = {"disagree": 0.25, "short": 0, "unanswered": 0, "invisible": 0}
CELLS = {"live": "toy-live.live"}  # toy cells not named toy.<mix>


def tree_digest(root: Path) -> dict:
    return {
        str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
        for p in sorted(root.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts
    }


def make_toy_root(dest: Path, limits: dict | None = None) -> Path:
    """A checkout-like root: the benchmark as committed plus a toy
    configuration, traffic and limits added as new files and entries."""
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    before = tree_digest(dest / "portbench")
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    here = dest / "portbench"
    cfg = json.loads((here / "configs/msmarco-shard-int8.json").read_text())
    cfg.update(TOY, name="toy")
    (here / "configs/toy.json").write_text(json.dumps(cfg))
    bench["configs"].append(
        {"name": "toy", "source": "tests", "file": "portbench/configs/toy.json", "reduced": [], "why": "tests"}
    )
    for mix in MIXES:
        if mix in FILED:
            tr = json.loads((here / f"traffic/{mix}.json").read_text())
            tr["queries"]["pool"] = 2048
            tr.update(warm_waves=2, warm_batches=2)
            if "wave" in tr:
                tr["wave"] = 256
            tr.update(TOY_TRAFFIC.get(mix, {}))
        else:
            tr = REQUESTS
        (here / f"traffic/toy-{mix}.json").write_text(json.dumps(tr))
        name = f"toy.{mix}"
        bench["workloads"].append(
            {"name": name, "config": "toy", "traffic": f"toy-{mix}", "chips": 1, "why": "tests"}
        )
        lim = {"disagree": 0.25, "short": 0, "unanswered": 0}
        if mix == "dense-batch":
            lim["score_gap"] = 1e-4
        if mix == "filtered-batch":
            lim["masked"] = 0
        (here / f"limits/{name}.json").write_text(json.dumps((limits or {}).get(mix, lim)))
        like = LIKE.get(mix, mix)
        for m in bench["end_to_end"] + bench["per_layer"]:
            cells = m.get("workloads")
            if cells and any(c.endswith("." + like) for c in cells):
                cells.append(name)
    bench["per_layer"].append(FALLBACK_SHARE)
    add_live_cell(dest, bench, (limits or {}).get("live", LIVE_LIMITS))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    after = tree_digest(dest / "portbench")
    changed = [f for f in before if after.get(f) != before[f]]
    assert not changed, f"adding the toy cells edited {changed}"
    return dest


def add_live_cell(dest: Path, bench: dict, limits: dict) -> None:
    """The live corpus as a later cell would bring it: a driver, a
    configuration, a mix with writes and limits, each a new file, and
    entries for them."""
    here = dest / "portbench"
    shutil.copy(Path(__file__).with_name("live_driver.py"), here / "drivers/live.py")
    cfg = json.loads((here / "configs/toy.json").read_text())
    cfg.update(name="toy-live", fusion="rrf")
    (here / "configs/toy-live.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "toy-live", "source": "tests", "file": "portbench/configs/toy-live.json",
                             "reduced": [], "why": "tests"})
    (here / "traffic/toy-live.json").write_text(json.dumps(LIVE))
    (here / f"limits/{CELLS['live']}.json").write_text(json.dumps(limits))
    bench["workloads"].append(
        {"name": CELLS["live"], "config": "toy-live", "traffic": "toy-live", "chips": 1, "why": "tests"})
    next(m for m in bench["end_to_end"] if m["name"] == "batch_qps")["workloads"].append(CELLS["live"])


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory) -> Path:
    return make_toy_root(tmp_path_factory.mktemp("toy"))


def run_toy(root: Path, mix: str, trace: bool = False, seconds: float = 1.5, seed: int = 3_000_000_017):
    """One run of a toy cell on the CPU, as ``run.py`` runs it on the card."""
    from portbench.harness import runner

    return runner.run_cell(root, CELLS.get(mix, f"toy.{mix}"), seed, seconds, trace, "cpu",
                           time.perf_counter(), log=lambda msg: None)
