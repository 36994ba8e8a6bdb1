"""Multi-socket node serving (counterpart of ``repro.node``; paper §III,
§V-B, §VI-C).

Turns the single-device ``ServingEngine`` into a node of TP socket groups,
one controller driving every rank (``ensure_emulated_sockets`` shares one
device between them):

  * ``topology``  — carve the sockets into TP x group socket groups;
  * ``execution`` — tensor-parallel paged decode and prefill per group;
  * ``placement`` — bandwidth-driven expert -> group assignment under
    per-group HBM budgets;
  * ``scheduler`` — router-driven dispatch and node-level statistics.
"""
from repro_torch.node.execution import (PrefillWorker, TPPagedDecodeRunner,
                                        make_group_engine)
from repro_torch.node.placement import (ExpertProfile, Placement,
                                        plan_expert_placement)
from repro_torch.node.scheduler import GroupState, NodeStats, RDUNode
from repro_torch.node.topology import (NodeTopology, SocketGroup,
                                       ensure_emulated_sockets,
                                       make_node_topology)

__all__ = [
    "NodeTopology", "SocketGroup", "ensure_emulated_sockets",
    "make_node_topology",
    "TPPagedDecodeRunner", "PrefillWorker", "make_group_engine",
    "ExpertProfile", "Placement", "plan_expert_placement",
    "GroupState", "NodeStats", "RDUNode",
]
