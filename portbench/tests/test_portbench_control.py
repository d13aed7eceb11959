"""The control, the reference in a lower precision in the program's place,
reads not correct under the limits: at a test's size on the CPU, and
(with a card) at each cell's own size."""

from __future__ import annotations

import pytest

from conftest import CELLS, MIXES, REPO
from portbench.control import control_numbers


@pytest.mark.parametrize("mix", MIXES + ("live",))
def test_control_fails_at_toy_size(toy_root, mix):
    out = control_numbers(toy_root, CELLS.get(mix, f"toy.{mix}"), 5, "cpu")
    assert out["control_correct"] is False, out


CARD_CELLS = [
    "msmarco-shard-int8.hybrid-batch",
    "msmarco-full-int8.dense-batch",
]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CARD_CELLS)
def test_control_fails_at_cell_size(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = control_numbers(REPO, cell, 7, "cuda")
    assert out["control_correct"] is False, out
