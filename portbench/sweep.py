"""The knee of an open-loop cell: its traffic at a list of offered rates, one
window each after one set-up, with the saturation rule of the program's
``tools/arrival.py``: a rate is saturated when the requests a second
completed fall below 95 % of those offered (completed over the time from
the window's opening to the last answer).

    python3 portbench/sweep.py --workload NAME --seed N --seconds S --rates 100,200,400

Prints one JSON line per rate. The knee is the highest rate not saturated;
a cell's traffic file records it beside the rate the cell offers.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench.harness import bench, program, runner
    from portbench.harness.window import Tracer

    cell = bench.load_cell(ROOT, args.workload, False)
    if cell.traffic["entry"] != "requests":
        raise SystemExit("the sweep is for open-loop cells")
    dev = torch.device("cuda")
    program.build_native()
    entry = bench.driver(ROOT, "requests")
    inputs = runner.make_inputs(cell.config, cell.traffic, args.seed, dev, entry.HYBRID)
    driver = entry.build(cell.config, cell.traffic, inputs, args.seed, dev)
    driver.warm()
    for rate in (float(r) for r in args.rates.split(",")):
        win = driver.run(args.seconds, Tracer(), rate=rate)
        done = win.requests - win.failed
        achieved = done / max(args.seconds, win.last_done - win.t0)
        lat = win.latencies
        print(json.dumps({
            "offered_rps": rate, "achieved_rps": achieved, "requests": win.requests,
            "failed": win.failed, "queries": win.queries,
            "p50_ms": 1e3 * runner.nearest_rank(lat, 0.5), "p95_ms": 1e3 * runner.nearest_rank(lat, 0.95),
            "saturated": achieved < 0.95 * rate, "at": time.time(),
        }), flush=True)
    driver.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
