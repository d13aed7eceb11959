"""One run of one cell: inputs, the program, warm-up, the window, the
readings, the reference, the result line."""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from portbench import roofline
from portbench.harness import bench, check, data, program, trace
from portbench.harness.spans import Spans
from portbench.harness.window import Tracer, host_load, host_shares

FORBIDDEN = ("jax", "jaxlib", "flax", "openintel_tpu")
TRACE_LEAD = 0.3  # the profiled stretch starts this share of the window in


@dataclass
class Inputs:
    postings: Optional[data.Postings]
    rows: torch.Tensor
    pool: data.QueryPool
    masks: Optional[np.ndarray]
    n_base: int  # docs in the corpus at the start; those after them are the write pool


def make_inputs(cfg: dict, traffic: dict, seed: int, device, hybrid: bool) -> Inputs:
    """The cell's inputs; postings only where its driver searches them. A
    mix with ``"writes": {"pool": N}`` gets N more docs after the
    configuration's ``n_docs``, for its driver to add in the window."""
    n_docs, dim, vocab = cfg["n_docs"], cfg["dim"], cfg["vocab_size"]
    n_all = n_docs + int(traffic.get("writes", {}).get("pool", 0))
    if n_all > n_docs and traffic.get("masks"):
        raise ValueError("a mix with a write pool takes no masks")
    postings = None
    if hybrid:
        postings = data.make_postings(n_all, vocab, cfg["postings"], seed, device)
        if n_all > n_docs:
            data.pooled_lengths(postings, n_docs)
    rows = data.make_rows(n_all, dim, cfg["store"], seed, device)
    pool = data.make_queries(rows, vocab, traffic["queries"]["pool"], cfg["query_model"], seed)
    masks = None
    if traffic.get("masks"):
        masks = data.make_masks(n_docs, traffic["masks"], seed, device)
        r = data.rng(seed, "masks", 1)
        groups = np.resize(np.arange(masks.shape[0], dtype=np.int32), len(pool))
        r.shuffle(groups)
        pool.groups = groups
    return Inputs(postings, rows, pool, masks, n_docs)


def profile_factory(device):
    """A ``torch.profiler.profile`` over the host (every thread) and, on the
    card, the device."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        from torch._C._profiler import _ExperimentalConfig

        cfg = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        cfg = None

    def make():
        return torch.profiler.profile(activities=acts, experimental_config=cfg)

    return make


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def nearest_rank(values, q: float) -> float:
    v = sorted(values)
    return v[max(0, int(np.ceil(q * len(v))) - 1)]


def run_cell(
    root: Path, workload: str, seed: int, seconds: float, trace_on: bool, device, t_start: float,
    log=lambda msg: print(msg, file=sys.stderr, flush=True),
) -> dict:
    cell = bench.load_cell(root, workload, trace_on)
    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    program.build_native()
    entry = bench.driver(root, traffic["entry"])
    inputs = make_inputs(cfg, traffic, seed, dev, entry.HYBRID)
    if dev.type == "cuda":  # the peak is the program's, not the generator's
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"inputs: {cfg['n_docs']} docs x {cfg['dim']}, {len(inputs.pool)} queries "
        f"({time.perf_counter() - t_start:.1f} s since start)")
    plan = entry.plan(cfg, traffic, inputs)
    driver = entry.build(cfg, traffic, inputs, seed, dev)
    spans = None
    tracer = Tracer()
    if trace_on:
        spans = Spans()
        spans.install()
        make = profile_factory(dev)
        warm = make()  # the profiler's own first start, outside the window
        warm.start()
        torch.zeros(1, device=dev).add_(1)
        warm.stop()
        tracer = Tracer(make, lead=seconds * TRACE_LEAD,
                        length=min(seconds * 0.4, float(traffic["trace_seconds"])))
    driver.warm()
    win = driver.run(seconds, tracer)
    host = host_shares(win.host0, host_load())
    setup_s = win.t0 - t_start
    log(f"window: {win.queries} queries in {seconds} s after {setup_s:.1f} s of set-up")
    log(f"host over the window: {host}")
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    record = {
        "cell": {"name": cell.name, "config": cfg, "traffic": traffic},
        "seconds": seconds, "setup_s": setup_s, "window": win, "spans": None, "trace": None,
        "host": host,
    }
    if trace_on:
        spans.uninstall()
        record["spans"] = spans.summary(win.t0, win.t1)
        if tracer.prof is not None:
            record["trace"] = trace.from_profiler(tracer.prof)
            tracer.prof = None
    driver.close()
    del driver
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, after the window, the peak and the program's state
    ref = check.Reference(inputs, cfg, plan, states=win.states, deletes=win.deletes)
    idx, ids, scores, states = check.sample(
        win.answers, check.SAMPLE, seed,
        whole_requests=traffic["entry"] == "requests",
    )
    numbers = check.compare(
        ref, idx, ids, scores, inputs.masks,
        inputs.pool.groups[idx] if inputs.masks is not None else None, states,
    )
    numbers["unanswered"] = win.failed
    record["check"] = {"recall": 1.0 - numbers["missed"], **numbers}
    ok, shown = check.verdict(numbers, cell.limits)
    ok = ok and numbers["queries"] > 0  # a window that answered nothing is no sound run
    metrics = {}
    for m in cell.metrics:
        value = bench.reader(root, m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1 if dev.type == "cuda" else 0,
        "memory_peak_bytes": peak,
    }
    result = {"correct": bool(ok), "attempted": int(win.attempted), "failed": int(win.failed),
              "metrics": metrics, "device": dev_info}
    if trace_on:
        t = record["trace"]
        dev_info["busy_s"] = t["busy_s"] if t else 0.0
        dev_info["window_s"] = t["window_s"] if t else 0.0
        if t:
            result["breakdown"] = {
                "device_ops": [[n, s] for n, s in t["top_ops"]],
                "idle_gaps": [[n, s] for n, s in t["idle_gaps"]],
            }
            log(f"trace: {t['kernels']} kernels, {t['unattributed']} of {t['device_ops']} device "
                f"ops outside a span, spans {t['span_calls']}")
        log(f"rooflines against the H100 SXM's published peaks at {roofline.H100_POWER_W:.0f} W; "
            f"this card: {roofline.power_limit()}")
    if win.errors:
        log(f"errors: {win.errors[:3]}")
    result["host"] = host
    result["check"] = shown
    result["_record"] = record
    return result
