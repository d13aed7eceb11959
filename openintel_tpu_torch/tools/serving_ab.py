"""Serving of two checkouts, timed on one card in one call: phases 14 and 15
of each checkout's ``chip_smoke.py`` (pipelined against sequential waves,
and coalesced callers, at 1.25M docs x 384), each run in a process of its
own, in turns (a, b, b, a per round), so that a host's drift during the
call falls on both.

    python -m openintel_tpu_torch.tools.serving_ab TREE_A TREE_B
        [--rounds 2] [--log-dir DIR]

Each tree is the root of a checkout (a ``git archive`` of a commit);
the child imports that tree's ``chip_smoke.py`` and package. Prints each
run's rates and, per tree, their medians; ``--log-dir`` keeps each run's
whole output. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import re
import statistics
import subprocess
import sys
from pathlib import Path

_CHILD = (
    "import chip_smoke as cs\n"
    "env = cs.phase_environment()\n"
    "retr = cs.phase_pipelined(cs.build_corpus(), env['card'])\n"
    "cs.phase_coalesced(retr, env['card'])\n"
)
_FIELDS = {
    "sequential": re.compile(r"sequential (\d+) q/s"),
    "pipelined": re.compile(r"pipelined (\d+) q/s"),
    "prepare_ms": re.compile(r"per wave alone: prepare ([\d.]+) ms"),
    "coalesced": re.compile(r"queries_run \d+, (\d+) q/s"),
    "p50_ms": re.compile(r"caller latency p50 ([\d.]+) ms"),
    "p99_ms": re.compile(r"p99 ([\d.]+) ms, max"),
}


def run_order(rounds: int) -> list[int]:
    """Which tree (0 or 1) runs at each turn: a, b, b, a per round."""
    return [0, 1, 1, 0] * rounds


def parse(text: str) -> dict:
    """The rates and latencies of one run's phase 14 and 15 lines."""
    out = {}
    for name, pattern in _FIELDS.items():
        found = pattern.search(text)
        if found is None:
            raise ValueError(f"no {name} in the run's output")
        out[name] = float(found.group(1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs=2, type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=300.0, help="seconds per run")
    ap.add_argument("--log-dir", type=Path)
    args = ap.parse_args(argv)
    trees = [t.resolve() for t in args.trees]
    runs: list[list[dict]] = [[], []]
    for turn, which in enumerate(run_order(args.rounds)):
        tree = trees[which]
        done = subprocess.run(
            [sys.executable, "-c", _CHILD], cwd=tree, capture_output=True, text=True,
            timeout=args.timeout,
        )
        if args.log_dir is not None:
            args.log_dir.mkdir(parents=True, exist_ok=True)
            (args.log_dir / f"{turn}_{tree.name}.txt").write_text(done.stdout + done.stderr)
        if done.returncode != 0:
            print(done.stdout[-2000:] + done.stderr[-2000:], file=sys.stderr)
            raise SystemExit(f"{tree.name} failed (rc {done.returncode})")
        got = parse(done.stdout)
        runs[which].append(got)
        print(f"turn {turn} {tree.name}: " + ", ".join(f"{k} {v:g}" for k, v in got.items()),
              flush=True)
    for tree, made in zip(trees, runs):
        medians = {k: statistics.median(r[k] for r in made) for k in _FIELDS}
        print(f"{tree.name} medians of {len(made)}: "
              + ", ".join(f"{k} {v:g}" for k, v in medians.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
