"""The dense arm's bound per sub-batch of 256 at the two configurations."""

from __future__ import annotations

import json

import pytest

from conftest import REPO
from portbench.roofline import arm_candidates, dense_arm_work


def _cfg(name):
    return json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())


def test_shard_bound_is_bytes_0_128_ms():
    cfg = _cfg("msmarco-shard-int8")
    w = dense_arm_work(cfg["n_docs"], cfg["dim"], 256, arm_candidates(10, 20), 10)
    assert w.bytes == pytest.approx(428.9e6, rel=1e-3)
    assert w.ops == pytest.approx(217.3e9, rel=1e-3)
    assert w.bound_by == "bytes"
    assert w.seconds * 1e3 == pytest.approx(0.128, abs=5e-4)


def test_full_bound_is_bytes_1_016_ms():
    cfg = _cfg("msmarco-full-int8")
    w = dense_arm_work(cfg["n_docs"], cfg["dim"], 256, arm_candidates(10, None), 10)
    assert arm_candidates(10, None) == 32
    assert w.bytes == pytest.approx(3402e6, rel=1e-3)
    assert w.ops == pytest.approx(1738e9, rel=1e-3)
    assert w.seconds * 1e3 == pytest.approx(1.016, abs=5e-4)
