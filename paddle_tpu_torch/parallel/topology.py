"""Hybrid communicate topology.

Port of ``paddle_tpu.parallel.topology``: ``CommunicateTopology`` and
``HybridCommunicateGroup`` (the reference's ``fleet/base/topology.py``
:52 and :133) over the port's ``core.mesh``. The mesh IS the topology
and "groups" are axis names, so these classes only answer the rank-math
queries (world rank, per-axis rank, group peers, stage ids) that user
code and the fleet facade need. Ranks are row-major over the axes, as
``core.mesh.Mesh.coords`` numbers them.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence

import numpy as np

from ..core.enforce import InvalidArgumentError, enforce

__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]


class CommunicateTopology:
    """Rank/coordinate arithmetic over named axes (hybrid N-D topology)."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int]) -> None:
        enforce(len(axis_names) == len(shape), "axis_names and shape must align")
        self._names = list(axis_names)
        self._shape = list(int(s) for s in shape)
        self._world = int(np.prod(self._shape))

    @classmethod
    def from_mesh(cls, mesh) -> "CommunicateTopology":
        """The topology of a ``core.mesh.Mesh``: its axes in order."""
        return cls(list(mesh.shape.keys()), list(mesh.shape.values()))

    def get_hybrid_group_names(self) -> List[str]:
        return list(self._names)

    def get_dim(self, axis: str) -> int:
        return self._shape[self._names.index(axis)]

    def world_size(self) -> int:
        return self._world

    def get_rank(self, **coords: int) -> int:
        enforce(sorted(coords) == sorted(self._names), f"need all axes {self._names}")
        rank = 0
        for name, size in zip(self._names, self._shape):
            c = coords[name]
            if not 0 <= c < size:
                raise InvalidArgumentError(f"coord {name}={c} out of range {size}")
            rank = rank * size + c
        return rank

    def get_coord(self, rank: int) -> Dict[str, int]:
        if not 0 <= rank < self._world:
            raise InvalidArgumentError(f"rank {rank} out of range {self._world}")
        out: Dict[str, int] = {}
        for name, size in zip(reversed(self._names), reversed(self._shape)):
            out[name] = rank % size
            rank //= size
        return {n: out[n] for n in self._names}

    def get_axis_list(self, axis: str, index: int) -> List[int]:
        """All world ranks whose coordinate on ``axis`` equals ``index``."""
        ranks = []
        for coords in itertools.product(*[range(s) for s in self._shape]):
            d = dict(zip(self._names, coords))
            if d[axis] == index:
                ranks.append(self.get_rank(**d))
        return ranks

    def get_comm_list(self, axis: str) -> List[List[int]]:
        """Peer groups along ``axis``: one list per combination of the
        other axes (the reference's per-axis comm groups)."""
        others = [n for n in self._names if n != axis]
        groups = []
        for coords in itertools.product(*[range(self.get_dim(n)) for n in others]):
            fixed = dict(zip(others, coords))
            group = []
            for i in range(self.get_dim(axis)):
                group.append(self.get_rank(**{**fixed, axis: i}))
            groups.append(group)
        return groups


class HybridCommunicateGroup:
    """Per-process view of the hybrid topology
    (topology.py:133 HybridCommunicateGroup): which dp/mp/pp/sharding
    (plus cp/ep) coordinate this rank holds, who its peers are."""

    def __init__(self, topology: CommunicateTopology, global_rank: int = 0) -> None:
        self._topo = topology
        self._rank = int(global_rank)
        self._coord = topology.get_coord(self._rank)

    # -- generic ----------------------------------------------------------

    @property
    def topology(self) -> CommunicateTopology:
        return self._topo

    def get_global_rank(self) -> int:
        return self._rank

    def _axis_rank(self, axis: str) -> int:
        return self._coord.get(axis, 0)

    def _axis_world(self, axis: str) -> int:
        return self._topo.get_dim(axis) if axis in self._topo.get_hybrid_group_names() else 1

    def _axis_peers(self, axis: str) -> List[int]:
        if axis not in self._topo.get_hybrid_group_names():
            return [self._rank]
        others = {n: c for n, c in self._coord.items() if n != axis}
        return [
            self._topo.get_rank(**{**others, axis: i}) for i in range(self._topo.get_dim(axis))
        ]

    # -- reference API names ----------------------------------------------

    def get_data_parallel_rank(self) -> int:
        return self._axis_rank("dp")

    def get_data_parallel_world_size(self) -> int:
        return self._axis_world("dp")

    def get_data_parallel_group(self) -> List[int]:
        return self._axis_peers("dp")

    def get_model_parallel_rank(self) -> int:
        return self._axis_rank("mp")

    def get_model_parallel_world_size(self) -> int:
        return self._axis_world("mp")

    def get_model_parallel_group(self) -> List[int]:
        return self._axis_peers("mp")

    def get_stage_id(self) -> int:
        return self._axis_rank("pp")

    def get_pipe_parallel_world_size(self) -> int:
        return self._axis_world("pp")

    def get_pipe_parallel_group(self) -> List[int]:
        return self._axis_peers("pp")

    def get_sharding_parallel_rank(self) -> int:
        return self._axis_rank("sharding")

    def get_sharding_parallel_world_size(self) -> int:
        return self._axis_world("sharding")

    def get_sharding_parallel_group(self) -> List[int]:
        return self._axis_peers("sharding")

    def is_first_stage(self) -> bool:
        return self.get_stage_id() == 0

    def is_last_stage(self) -> bool:
        return self.get_stage_id() == self.get_pipe_parallel_world_size() - 1
