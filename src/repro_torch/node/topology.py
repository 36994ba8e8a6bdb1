"""Socket-group topology of one multi-socket node (counterpart of
``repro.node.topology``; paper §III, §VI-C).

The paper's 8-socket node runs each expert tensor-parallel over a dedicated
inter-RDU network, and may be carved into several independent TP groups,
each serving its own expert working set. The carve is ``TP degree x group
count`` over a list of sockets: 8 sockets run as one TP = 8 group
(``8x1``), four TP = 2 groups (``2x4``), and so on. Group ``g`` owns
sockets ``[g * tp, (g + 1) * tp)``; the shared ``ExpertStore`` plays the
node-wide DDR tier.

A socket is a ``torch.device``. Where JAX forces N emulated CPU devices,
``ensure_emulated_sockets(n)`` returns n sockets that share ONE device (the
CPU in tests, the card on a one-card machine): one controller then drives
every rank of a group on it (``node.execution``), and the sharding is real
(each rank holds and computes on its own shard) while the bandwidth is one
card's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device


def ensure_emulated_sockets(n: int, device=None) -> Tuple[torch.device, ...]:
    """``n`` sockets that share one device (the card unless ``device``
    says otherwise)."""
    if n < 1:
        raise ValueError(f"need at least one socket, got {n}")
    dev = resolve_device(device)
    return (dev,) * n


@dataclass(frozen=True)
class SocketGroup:
    """One TP domain: ``tp`` sockets behind a single serving engine. Where
    JAX holds a one-axis ``('model',)`` mesh, the group holds its sockets
    (rank ``r`` is ``devices[r]``); one controller drives them, so the
    group's runner needs them to be one device."""
    gid: int
    tp: int
    devices: Tuple[torch.device, ...]

    @property
    def device(self) -> torch.device:
        return self.devices[0]


@dataclass(frozen=True)
class NodeTopology:
    tp: int
    n_groups: int
    groups: Tuple[SocketGroup, ...]

    @property
    def n_sockets(self) -> int:
        return self.tp * self.n_groups

    @property
    def name(self) -> str:
        return f"{self.tp}x{self.n_groups}"


def make_node_topology(tp: int, n_groups: Optional[int] = None,
                       devices: Optional[Sequence] = None) -> NodeTopology:
    """Carve the socket list into ``n_groups`` disjoint TP-``tp`` groups
    (default: as many as the sockets allow). ``devices`` defaults to
    ``tp * n_groups`` emulated sockets on the card (``tp`` without a group
    count)."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if devices is None:
        devices = ensure_emulated_sockets(tp * (n_groups or 1))
    devs = [torch.device(d) for d in devices]
    if n_groups is None:
        n_groups = len(devs) // tp
    if n_groups < 1:
        raise ValueError(f"n_groups must be >= 1, got {n_groups}")
    need = tp * n_groups
    if need > len(devs):
        raise ValueError(
            f"topology {tp}x{n_groups} needs {need} sockets but only "
            f"{len(devs)} were given; emulate them with "
            f"ensure_emulated_sockets({need})")
    groups = tuple(SocketGroup(g, tp, tuple(devs[g * tp:(g + 1) * tp]))
                   for g in range(n_groups))
    return NodeTopology(tp=tp, n_groups=n_groups, groups=groups)
