"""The int8 quantiser of unit-norm rows: round(127 * x), half to even,
clipped to [-127, 127]."""

from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(127.0 * x.float()), -127, 127).to(torch.int8)
