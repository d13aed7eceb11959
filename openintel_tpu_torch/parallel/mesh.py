"""Mesh construction: a ("data", "corpus") grid of torch devices.

Port of :mod:`openintel_tpu.parallel.mesh`. One canonical layout, as in
the reference: query batches split over "data", documents over "corpus".
A single device is a 1x1 mesh, so every code path is mesh-generic.

A :class:`Mesh` is the grid of devices and, when the process is one rank
of a ``torch.distributed`` group, that group and which cells this rank
owns: the cells are numbered row-major and each rank owns one contiguous
block of them (rank r of w owns cells ``[r * n / w, (r + 1) * n / w)``).
Every rank runs the same host program over its own cells; the collectives
of :mod:`openintel_tpu_torch.parallel.sharded` give each rank every cell's
candidate lists, so each returns the whole result.

Which devices a mesh spans (:func:`make_mesh`):

- on the card, the cards there are: ``torch.cuda.device_count()`` of them
  in one process; once a group is up, one card per rank (the card the rank
  set as its current device), across all ranks;
- on the CPU, the host stands in for as many devices as the mesh asks
  (the reference's test host does the same with virtual CPU devices);
- an explicit ``devices=`` list, which may repeat a device.

:class:`PartitionSpec` names, per dimension of an array, the mesh axis it
is split over (``None``: not split), as ``jax.sharding.PartitionSpec``
does; the encoder's tensor-parallel layout
(``models.encoder.param_partition_specs``) is a tree of them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
CORPUS_AXIS = "corpus"


class PartitionSpec(tuple):
    """Per array dimension, the mesh axis it is split over, or None: a
    tuple, so ``PartitionSpec(None, "corpus") == (None, "corpus")``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(map(repr, self))})"


class Mesh:
    """A (data, corpus) grid of devices, optionally spread over the ranks
    of a ``torch.distributed`` group. ``shape[axis]`` reads an axis size as
    the reference's ``jax.sharding.Mesh`` does. Meshes compare by
    identity."""

    def __init__(self, devices: Sequence[Sequence[torch.device]], group=None):
        self.devices = tuple(tuple(torch.device(d) for d in row) for row in devices)
        data, corpus = len(self.devices), len(self.devices[0])
        if data < 1 or corpus < 1 or any(len(row) != corpus for row in self.devices):
            raise ValueError("a mesh is a non-empty data x corpus grid")
        self.shape = {DATA_AXIS: data, CORPUS_AXIS: corpus}
        self.group = group
        if group is None:
            self.rank, self.world = 0, 1
        else:
            import torch.distributed as dist

            self.rank, self.world = dist.get_rank(group), dist.get_world_size(group)
        n = data * corpus
        if n % self.world:
            raise ValueError(
                f"mesh {data}x{corpus} does not split over {self.world} processes"
            )
        per = n // self.world
        cells = [(i // corpus, i % corpus) for i in range(n)]
        #: the (data row, shard) cells this process owns, in row-major order
        self.owned = tuple(cells[self.rank * per : (self.rank + 1) * per])

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[CORPUS_AXIS]

    def device(self, d: int, s: int) -> torch.device:
        return self.devices[d][s]

    @property
    def home(self) -> torch.device:
        """Where this process merges the gathered lists: its first cell's
        device."""
        return self.device(*self.owned[0])


def _group():
    """The default process group when one is up, else None."""
    import torch.distributed as dist

    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def default_devices(device="cuda", n_asked: Optional[int] = None) -> list:
    """The devices a mesh spans when none are given: on the card the
    cards there are (once a group is up, one card per rank, each rank's
    current one); on the CPU ``n_asked`` stand-ins for the host (one per
    rank without ``n_asked``)."""
    group = _group()
    device_type = torch.device(device).type
    world = 1 if group is None else torch.distributed.get_world_size(group)
    if device_type == "cpu":
        return [torch.device("cpu")] * (n_asked if n_asked is not None else world)
    if device_type != "cuda":
        raise ValueError(f"unknown device {device_type!r} (expected cuda | cpu)")
    if group is not None:
        # each rank serves from the card it set current before the group
        # started; the other ranks' cells are named after it, and only
        # their owners touch them
        return [torch.device("cuda", torch.cuda.current_device())] * world
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n_cards)]


def make_mesh(
    *,
    data: int = 1,
    corpus: Optional[int] = None,
    devices: Optional[Sequence] = None,
    device="cuda",
) -> Mesh:
    """Build a ("data", "corpus") mesh. ``corpus`` defaults to all
    remaining devices after the data axis.

    Without ``devices``: the cards there are (``device`` "cuda", the
    default), or, with ``device="cpu"``, as many host devices as the mesh
    asks. A mesh never spans fewer cards than it names unless the caller
    passes such a list.

    ``devices=`` is an instrument for tests and measurement: the list may
    repeat a device, so that several shards share one card (or the host)
    and run one after another there; it serves nothing faster."""
    if devices is None:
        devices = default_devices(device, data * corpus if corpus is not None else None)
    devices = list(devices)
    n = len(devices)
    if corpus is None:
        if n % data:
            raise ValueError(f"{n} devices not divisible by data={data}")
        corpus = n // data
    if data * corpus != n:
        raise ValueError(f"mesh {data}x{corpus} != {n} devices")
    return Mesh(
        [devices[r * corpus : (r + 1) * corpus] for r in range(data)], group=_group()
    )


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0, fill=0):
    """Pad an array along ``axis`` to a multiple (shard-even corpora)."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=fill), n
