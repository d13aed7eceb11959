"""The control of a cell's comparison: the plain reference, computed in the
next precision below the configuration's (int8 dense scores for the bf16
store and its rescore; bfloat16 BM25 scores for float32), put in the
program's place on the cell's own inputs and queries and judged by the
same comparison. Its numbers set the upper readings of the limits. A
driver of a live corpus gives the states to judge in through its
``control_states(cfg, traffic, inputs, seed, idx)``: (states, deletes,
each query's state).

    python3 portbench/control.py --workload NAME --seeds 1,2,3 [--device cuda]

Prints one JSON line per seed. The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(root: Path, workload: str, seed: int, device: str) -> dict:
    import numpy as np
    import torch

    from portbench.harness import bench, check, data, runner

    cell = bench.load_cell(root, workload, False)
    cfg, traffic = cell.config, cell.traffic
    entry = bench.driver(root, traffic["entry"])
    inputs = runner.make_inputs(cfg, traffic, seed, torch.device(device), entry.HYBRID)
    plan = entry.plan(cfg, traffic, inputs)
    r = data.rng(seed, "sample", 1)
    idx = np.sort(r.choice(len(inputs.pool), size=min(check.SAMPLE, len(inputs.pool)), replace=False))
    states, deletes, st = (), (), None
    if hasattr(entry, "control_states"):
        states, deletes, st = entry.control_states(cfg, traffic, inputs, seed, idx)
    ref = check.Reference(inputs, cfg, plan, states=states, deletes=deletes)
    low = check.Reference(inputs, cfg, plan, low_precision=True, states=states, deletes=deletes)
    ids, scores = check.control_answers(low, idx, st)
    groups = inputs.pool.groups[idx] if inputs.masks is not None else None
    numbers = check.compare(ref, idx, ids, scores, inputs.masks, groups, st)
    ok, shown = check.verdict({**numbers, "unanswered": 0}, cell.limits)
    return {"workload": workload, "seed": seed, "control_correct": ok, "numbers": numbers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        out = control_numbers(ROOT, args.workload, int(s), args.device)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
