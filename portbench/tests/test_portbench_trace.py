"""The trace reduction on hand-made events: attribution through the
launching thread's open spans, unions of overlapping operations, idle gaps
and the readers' None where nothing was read."""

from __future__ import annotations

import pytest

from portbench.harness.readings import device_under, idle_pct
from portbench.harness.trace import reduce_events, union_seconds


def test_union_counts_overlaps_once():
    assert union_seconds([(0, 10), (5, 20), (30, 40)]) == pytest.approx(30e-9)
    assert union_seconds([]) == 0.0


def _events():
    # thread 1 runs a step with the dense arm nested in it; thread 2 plans
    host = [
        (100, 1, 0, 1000, "pb.run_prepared_device", "user_annotation"),
        (101, 1, 100, 500, "pb.dense_arm_topk", "user_annotation"),
        (102, 1, 120, 130, "aten::mm", "cpu_op"),
        (7, 1, 125, 126, "cudaLaunchKernel", "cuda_runtime"),
        (103, 1, 600, 700, "aten::add", "cpu_op"),
        (200, 2, 0, 2000, "pb.prepare", "user_annotation"),
    ]
    device = [
        (7, 102, 200, 400, "gemm", "kernel"),  # by the runtime's correlation
        (8, 103, 350, 450, "add", "kernel"),  # by the op it links to
        (9, 0, 1500, 1600, "Memcpy HtoD", "gpu_memcpy"),  # launched outside any span
    ]
    return host, device


def test_kernels_belong_to_the_spans_open_at_their_launch():
    host, device = _events()
    rec = reduce_events(host, device, (0, 2000))
    assert rec["kernels"] == 2 and rec["device_ops"] == 3 and rec["unattributed"] == 1
    assert rec["device_s"]["dense_arm_topk"] == pytest.approx(200e-9)
    assert rec["device_s"]["run_prepared_device"] == pytest.approx(250e-9)  # 200-450, once
    assert "prepare" not in rec["device_s"]
    assert rec["busy_s"] == pytest.approx(350e-9)
    assert rec["span_calls"] == {"run_prepared_device": 1, "dense_arm_topk": 1, "prepare": 1}
    gaps = dict(rec["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx((2000 - 350) * 1e-9)
    assert "prepare" in " ".join(gaps)


def test_launch_calls_on_another_thread_numbering_are_mapped():
    """A kernel launched outside any framework op (a ctypes entry point)
    is found through its launch call, whose thread id the runtime names
    otherwise; the mapping comes from the kernels that have both links."""
    host = [
        (100, 1, 0, 1000, "pb.dense_arm_topk", ""),
        (102, 1, 100, 200, "aten::mm", ""),
        (7, 9001, 110, 111, "cudaLaunchKernel", ""),
        (8, 9001, 300, 301, "cuLaunchKernelEx", ""),
    ]
    device = [
        (7, 102, 400, 500, "gemm", "kernel"),
        (8, 0, 500, 900, "i8_steps_tma_kernel", "kernel"),
    ]
    rec = reduce_events(host, device, (0, 1000))
    assert rec["unattributed"] == 0
    assert rec["device_s"]["dense_arm_topk"] == pytest.approx(500e-9)


def test_readers_return_none_without_a_trace_or_a_span():
    host, device = _events()
    rec = {"trace": reduce_events(host, device, (0, 2000))}
    assert device_under(rec, ["bm25_topk_device"]) is None
    assert device_under(rec, ["dense_arm_topk"]) == pytest.approx(200e-9)
    assert idle_pct(rec) == pytest.approx(100 * (1 - 350 / 2000))
    assert idle_pct({"trace": None}) is None
    assert device_under({"trace": None}, ["dense_arm_topk"]) is None
