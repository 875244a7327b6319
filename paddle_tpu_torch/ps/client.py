"""The PS client interface and its in-process implementation.

The port's own copy of ``paddle_tpu.ps.client``: :class:`PSClient` is the
interface (``ps/service/ps_client.h:62``: pull/push of sparse and dense
tables, GEO deltas, save/load, barriers) that the communicator and the
stream trainer call; :class:`LocalPsClient` serves it from the tables of
one process (:class:`PsServerHandle`, the reference's PsLocalClient), and
``ps.rpc.RpcPsClient`` serves it over TCP from ``NativePsServer``s.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

from ..core.enforce import NotFoundError
from .table import (BarrierTable, GlobalStepTable, MemoryDenseTable, MemorySparseGeoTable,
                    MemorySparseTable, TableConfig, make_sparse_table)

__all__ = ["LocalPsClient", "PSClient", "PsServerHandle"]


class PsServerHandle:
    """In-process 'server': the table registry a ``LocalPsClient`` reads."""

    def __init__(self) -> None:
        self.sparse_tables: Dict[int, MemorySparseTable] = {}
        self.dense_tables: Dict[int, MemoryDenseTable] = {}
        self.geo_tables: Dict[int, MemorySparseGeoTable] = {}
        self.barrier_table: Optional[BarrierTable] = None
        self.global_step = GlobalStepTable()
        self._lock = threading.Lock()

    def create_sparse_table(self, table_id: int,
                            config: Optional[TableConfig] = None) -> MemorySparseTable:
        with self._lock:
            if table_id not in self.sparse_tables:
                self.sparse_tables[table_id] = make_sparse_table(
                    config or TableConfig(table_id=table_id))
            return self.sparse_tables[table_id]

    def create_dense_table(self, table_id: int, dim: int, optimizer: str = "adam",
                           lr: float = 0.001) -> MemoryDenseTable:
        with self._lock:
            if table_id not in self.dense_tables:
                self.dense_tables[table_id] = MemoryDenseTable(dim, optimizer, lr)
            return self.dense_tables[table_id]

    def create_geo_table(self, table_id: int, dim: int) -> MemorySparseGeoTable:
        with self._lock:
            if table_id not in self.geo_tables:
                self.geo_tables[table_id] = MemorySparseGeoTable(dim)
            return self.geo_tables[table_id]

    def close(self) -> None:
        """Stop the sparse tables' shard workers."""
        for t in self.sparse_tables.values():
            t.close()


class PSClient:
    """The client interface (ps_client.h's API shape)."""

    def pull_sparse(self, table_id: int, keys: np.ndarray, create: bool = True,
                    slots=None) -> np.ndarray:
        """``slots`` tags the rows this pull CREATES with their slot id."""
        raise NotImplementedError

    def push_sparse(self, table_id: int, keys: np.ndarray, values: np.ndarray) -> None:
        raise NotImplementedError

    def pull_dense(self, table_id: int) -> np.ndarray:
        raise NotImplementedError

    def push_dense(self, table_id: int, grad: np.ndarray) -> None:
        raise NotImplementedError

    def save(self, table_id: int, dirname: str, mode: int = 0) -> int:
        raise NotImplementedError

    def load(self, table_id: int, dirname: str) -> int:
        raise NotImplementedError

    def push_geo(self, table_id: int, keys: np.ndarray, deltas: np.ndarray) -> None:
        """GEO mode: accumulate raw parameter deltas server-side."""
        raise NotImplementedError

    def pull_geo(self, table_id: int):
        raise NotImplementedError

    def barrier(self) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def shrink(self, table_id: int) -> int:
        raise NotImplementedError

    def digest(self, table_id: int):
        """Order-independent content digest(s) of a sparse table."""
        raise NotImplementedError

    def table_stats(self, table_id: int) -> Dict[str, int]:
        """Storage statistics of a sparse table ({} for a RAM table)."""
        raise NotImplementedError


class LocalPsClient(PSClient):
    """:class:`PSClient` over one process's :class:`PsServerHandle`."""

    def __init__(self, server: PsServerHandle) -> None:
        self.server = server

    def _sparse(self, table_id: int) -> MemorySparseTable:
        try:
            return self.server.sparse_tables[table_id]
        except KeyError:
            raise NotFoundError(f"sparse table {table_id} not created") from None

    def _dense(self, table_id: int) -> MemoryDenseTable:
        try:
            return self.server.dense_tables[table_id]
        except KeyError:
            raise NotFoundError(f"dense table {table_id} not created") from None

    def _geo(self, table_id: int) -> MemorySparseGeoTable:
        try:
            return self.server.geo_tables[table_id]
        except KeyError:
            raise NotFoundError(f"geo table {table_id} not created") from None

    def pull_sparse(self, table_id, keys, create=True, slots=None):
        return self._sparse(table_id).pull_sparse(keys, create=create, slots=slots)

    def push_sparse(self, table_id, keys, values):
        self._sparse(table_id).push_sparse(keys, values)

    def pull_dense(self, table_id):
        return self._dense(table_id).pull_dense()

    def push_dense(self, table_id, grad):
        self._dense(table_id).push_dense(grad)

    def save(self, table_id, dirname, mode=0):
        return self._sparse(table_id).save(dirname, mode)

    def load(self, table_id, dirname):
        return self._sparse(table_id).load(dirname)

    def push_geo(self, table_id, keys, deltas):
        self._geo(table_id).push_delta(keys, deltas)

    def pull_geo(self, table_id):
        return self._geo(table_id).pull_geo()

    def barrier(self):
        if self.server.barrier_table is not None:
            self.server.barrier_table.barrier()

    def shrink(self, table_id):
        return self._sparse(table_id).shrink()

    def digest(self, table_id):
        return self._sparse(table_id).digest()

    def table_stats(self, table_id):
        stats = getattr(self._sparse(table_id), "stats", None)
        return dict(stats()) if callable(stats) else {}
