"""Run one cell of the benchmark once and print its result as the last line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout on a machine with the cards the cell asks
for. With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the device's busy time. Each
number the comparison with the reference judges is printed beside its
limit, as the last lines of standard error and under ``check``, the last
key of the line. Exits non-zero, printing no result, without enough CUDA
devices, or when a JAX module or the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is counted from here, before ``import torch``

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench" / "cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # build and kernel caches live in the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench.harness import bench, runner

    chips = bench.load_cell(ROOT, args.workload, bool(args.trace)).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = runner.run_cell(
        ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START
    )
    result.pop("_record")
    bad = runner.forbidden_modules()
    if bad:
        print(f"error: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, v in result["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
