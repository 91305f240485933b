"""Topology-aware rank assignment.

Copy of ``dlrover_tpu/master/net_topology.py``.

Reference parity: ``dlrover/python/master/elastic_training/
net_topology.py:20,29,50`` — ``NodeTopologyMeta``, ``TopologyQuerier``
and ``DpTopologySorter`` (sort node ranks so nodes under the same
access/pod switch get adjacent ranks, keeping allreduce ring traffic
inside a switch).

TPU form: the hierarchy is slice / pod / superpod instead of
asw / psw; DCN-attached slices benefit the same way — data-parallel
neighbors inside one slice ride ICI, cross-slice hops ride DCN, so
adjacent ranks must cluster by (superpod, pod, slice).  The querier is
pluggable: on GCE the levels come from TPU-VM metadata
(``agent_hostname``/topology env), in tests from a static table.
"""

from abc import ABCMeta, abstractmethod
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class NodeTopologyMeta:
    """One node's position in the interconnect hierarchy (ref
    ``NodeTopologyMeta`` ``net_topology.py:20``)."""

    node_rank: int = 0
    process_num: int = 8
    # hierarchy labels, outermost first (superpod, pod, slice) — the
    # reference's (psw, asw) generalized to N levels
    levels: Tuple[str, ...] = ()


class TopologyQuerier(metaclass=ABCMeta):
    """Where a node sits (ref ``TopologyQuerier:29``)."""

    @abstractmethod
    def query(self, node_id: str) -> Optional[Tuple[str, ...]]:
        ...


class StaticTopologyQuerier(TopologyQuerier):
    """Table-driven querier (tests / config-file deployments)."""

    def __init__(self, table: Dict[str, Tuple[str, ...]]):
        self._table = dict(table)

    def query(self, node_id: str) -> Optional[Tuple[str, ...]]:
        return self._table.get(node_id)


def order_by_topology(ranks, levels_map: Dict[int, Tuple[str, ...]]):
    """Order node ranks so interconnect neighbors are adjacent: known
    nodes grouped by hierarchy labels (outermost first), unknown nodes
    appended in numeric order (missing metadata never blocks)."""
    known = [r for r in ranks if levels_map.get(r)]
    unknown = [r for r in ranks if not levels_map.get(r)]
    known.sort(key=lambda r: (levels_map[r], r))
    return known + unknown


class DpTopologySorter:
    """Sort nodes so interconnect neighbors get adjacent ranks (ref
    ``DpTopologySorter:50``); thin object facade over
    :func:`order_by_topology` (one ordering logic path)."""

    def sort(
        self, nodes: Dict[int, NodeTopologyMeta]
    ) -> Dict[int, NodeTopologyMeta]:
        """node_rank -> meta, returns the same metas re-ranked."""
        order = order_by_topology(
            sorted(nodes), {r: m.levels for r, m in nodes.items()}
        )
        out: Dict[int, NodeTopologyMeta] = {}
        for new_rank, orig_rank in enumerate(order):
            meta = nodes[orig_rank]
            meta.node_rank = new_rank
            out[new_rank] = meta
        return out
