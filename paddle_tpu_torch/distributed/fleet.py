"""Fleet: the distributed-training facade of a parameter-server job.

The port's own copy of ``paddle_tpu.distributed.fleet`` (the reference's
``fleet/base/fleet_base.py``: init:206, init_server:642, run_server:693,
init_worker, save_persistables:824, and the runtime selection of
``TheOnePSRuntime``, distributed/ps/the_one_ps.py:819): from the role
maker and the strategy it stands up the tables, the PS client and the
communicator.

- Transport. ``"local"``: the tables live in this process
  (``PsServerHandle`` + ``LocalPsClient``); ``"rpc"``: a server process
  hosts a ``NativePsServer`` at its endpoint and a worker connects an
  ``RpcPsClient`` to every pserver endpoint. ``"auto"`` (the default)
  takes ``"rpc"`` when the role maker names a cluster
  (``RoleMakerBase.is_cluster``: the env's ``TRAINING_ROLE`` with pserver
  endpoints, or a ``UserDefinedRoleMaker`` given server endpoints), else
  ``"local"``. Divergences from the JAX package: there, ``Fleet`` reads
  ``TRAINING_ROLE`` from the env whatever role maker it was given, and
  ``"auto"`` quietly takes ``"local"`` when the RPC library is missing,
  which leaves every process of a cluster training alone; here a cluster
  role builds the PS service's library at ``init`` and raises when it
  cannot.
- ``init_server`` listens on the endpoint's own host (the JAX server
  listens on every interface; the port's ``NativePsServer`` on loopback
  unless it is given ``host=``).
- ``fleet.util`` (:class:`_FleetUtil`): all-reduce, all-to-all of bytes
  (the transport of ``InMemoryDataset.global_shuffle``), barrier and the
  static file split, over a ``TCPStore`` that worker 0 hosts at
  ``PADDLE_UTIL_STORE_PORT``.
- ``distributed_optimizer`` returns ``meta_optimizers.apply_strategy``'s
  chain for the strategy's dense flags (the optimizer as it is without
  one), as the JAX package does; given a ``reducer``
  (``comm_fusion.DpGradReducer``) the chain takes pre-reduction
  gradients and owns the fused dp collectives. ``save_inference_model``
  exports through ``io.inference`` (``torch.export``).
"""

from __future__ import annotations

import base64
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..core.enforce import PreconditionNotMetError, enforce
from ..ps.client import LocalPsClient, PsServerHandle
from ..ps.communicator import (AsyncCommunicator, GeoCommunicator, HalfAsyncCommunicator,
                               SyncCommunicator)
from ..ps.table import BarrierTable, TableConfig
from .collective import TCPStore
from .role_maker import PaddleCloudRoleMaker, RoleMakerBase
from .strategy import DistributedStrategy

__all__ = ["Fleet", "fleet"]

class _FleetUtil:
    """``fleet.util`` (base/util_factory.py): host-side small collectives
    for the workers, the GlooWrapper role (gloo_wrapper.h:134).

    One worker, or no store bound: identity. Several workers: a
    ``TCPStore`` (worker 0 hosts the daemon) carries each round's values
    as base64 text keyed per round; the last reader of a round deletes
    its keys."""

    _REDUCERS = {
        "sum": lambda xs: np.sum(xs, axis=0),
        "avg": lambda xs: np.mean(xs, axis=0),
        "mean": lambda xs: np.mean(xs, axis=0),
        "max": lambda xs: np.max(xs, axis=0),
        "min": lambda xs: np.min(xs, axis=0),
    }

    def __init__(self) -> None:
        self._store: Optional[TCPStore] = None
        self._rank = 0
        self._world = 1
        self._round = 0
        self._role_maker: Optional[RoleMakerBase] = None

    def _bind(self, store: TCPStore, rank: int, world: int) -> None:
        """Attach the coordination store (``Fleet.init_worker``)."""
        self._store = store
        self._rank = rank
        self._world = world

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def world_size(self) -> int:
        return self._world

    def _store_round(self, tag: str, outgoing: Dict[str, str], want: List[str],
                     all_keys: List[str]) -> List[str]:
        """One exchange round: set my ``outgoing`` values, wait for and read
        the ``want`` keys, then the last rank to finish reading deletes
        ``all_keys`` (the round's whole key set, the same on every rank)."""
        rnd = self._round
        self._round += 1
        ns = f"__fleet_util/{tag}/{rnd}"
        for k, v in outgoing.items():
            self._store.set(f"{ns}/{k}", v)
        want_full = [f"{ns}/{k}" for k in want]
        self._store.wait(want_full)
        out = [self._store.get(k) for k in want_full]
        if self._store.add(f"{ns}/ack", 1) == self._world:
            for k in all_keys:
                self._store.delete(f"{ns}/{k}")
            self._store.delete(f"{ns}/ack")
        return out

    def all_reduce(self, value, mode: str = "sum"):
        enforce(mode in self._REDUCERS, f"unknown reduce mode {mode!r}")
        if self._store is None or self._world <= 1:
            return value
        arr = np.asarray(value)
        payload = base64.b64encode(arr.tobytes()).decode()
        ranks = [str(r) for r in range(self._world)]
        got = self._store_round(
            "ar", {str(self._rank): f"{arr.dtype.str}|{','.join(map(str, arr.shape))}|{payload}"},
            ranks, ranks)
        parts = []
        for item in got:
            dt, shp, data = item.split("|", 2)
            shape = tuple(int(s) for s in shp.split(",")) if shp else ()
            parts.append(np.frombuffer(base64.b64decode(data), dtype=np.dtype(dt)).reshape(shape))
        return self._REDUCERS[mode](np.stack(parts)).astype(arr.dtype, copy=False)

    def all_to_all_bytes(self, blobs) -> list:
        """Personalized all-to-all of byte blobs (``blobs[dst]`` goes to
        rank dst; returns one blob per source rank): the transport of the
        dataset's global shuffle, through the store."""
        enforce(len(blobs) == max(self._world, 1),
                f"need one blob per rank ({self._world}), got {len(blobs)}")
        if self._store is None or self._world <= 1:
            return [blobs[0]]
        got = self._store_round(
            "a2a",
            {f"{self._rank}->{dst}": base64.b64encode(blob).decode()
             for dst, blob in enumerate(blobs)},
            [f"{src}->{self._rank}" for src in range(self._world)],
            [f"{src}->{dst}" for src in range(self._world) for dst in range(self._world)])
        return [base64.b64decode(v) for v in got]

    def barrier(self) -> None:
        if self._store is None or self._world <= 1:
            return
        self._store.barrier("__fleet_util", self._world)

    def shutdown(self) -> None:
        """Check out of the store. Worker 0 hosts the daemon, so it waits
        (up to 60 s) until every worker has checked out before it closes."""
        if self._store is None or self._world <= 1:
            return
        self._store.add("__fleet_util/leave", 1)
        if self._rank == 0:
            deadline = time.perf_counter() + 60.0
            while time.perf_counter() < deadline:
                if int(self._store.get("__fleet_util/leave") or 0) >= self._world:
                    break
                time.sleep(0.05)
        self._store.close()
        self._store = None

    def get_file_shard(self, files: List[str], worker_index: Optional[int] = None,
                       worker_num: Optional[int] = None) -> List[str]:
        """The static file split (util.get_file_shard): every
        ``worker_num``-th file from ``worker_index``. Without them, this
        worker's index and count from the role maker of ``fleet.init``."""
        if worker_index is None or worker_num is None:
            enforce(self._role_maker is not None,
                    "get_file_shard(files) needs fleet.init() (or pass worker_index and "
                    "worker_num)", PreconditionNotMetError)
            worker_index = self._role_maker.worker_index()
            worker_num = self._role_maker.worker_num()
        return files[worker_index::worker_num]


class Fleet:
    """The facade (see the module docstring). ``fleet`` is the module's
    instance; a test or a second job in one process makes its own."""

    def __init__(self) -> None:
        self._role_maker: Optional[RoleMakerBase] = None
        self._strategy: Optional[DistributedStrategy] = None
        self._server: Optional[PsServerHandle] = None
        self._client = None
        self._rpc_server = None
        self._communicator = None
        self._inited = False
        self.util = _FleetUtil()
        self._table_configs: Dict[int, TableConfig] = {}
        self._server_running = threading.Event()

    # -- lifecycle (fleet_base.py API names) ------------------------------

    def init(self, role_maker: Optional[RoleMakerBase] = None, is_collective: bool = False,
             strategy: Optional[DistributedStrategy] = None) -> "Fleet":
        self._role_maker = role_maker or PaddleCloudRoleMaker(is_collective=is_collective)
        self._strategy = strategy or DistributedStrategy()
        self._transport = self._pick_transport()
        if self._transport == "local":
            self._server = PsServerHandle()
            self._client = LocalPsClient(self._server)
        else:
            self._server = None
            self._client = None  # a worker connects in init_worker
        self._rpc_server = None
        self._table_configs = {}
        self.util._role_maker = self._role_maker
        self._inited = True
        return self

    def _pick_transport(self) -> str:
        mode = getattr(self._strategy, "ps_transport", "auto")
        if mode not in ("local", "rpc"):
            mode = "rpc" if self._role_maker.is_cluster() else "local"
        if mode == "rpc":
            from ..ps.native import load_ssd

            load_ssd()  # builds the PS service at first use; raises when it cannot
        return mode

    @property
    def transport(self) -> str:
        self._check_init()
        return self._transport

    def _check_init(self) -> None:
        enforce(self._inited, "call fleet.init() first", PreconditionNotMetError)

    # -- role queries ------------------------------------------------------

    def is_worker(self) -> bool:
        self._check_init()
        return self._role_maker.is_worker()

    def is_server(self) -> bool:
        self._check_init()
        return self._role_maker.is_server()

    def is_first_worker(self) -> bool:
        self._check_init()
        return self._role_maker.is_first_worker()

    def worker_index(self) -> int:
        self._check_init()
        return self._role_maker.worker_index()

    def worker_num(self) -> int:
        self._check_init()
        return self._role_maker.worker_num()

    def server_num(self) -> int:
        self._check_init()
        return self._role_maker.server_num()

    def worker_endpoints(self, to_string: bool = False):
        eps = self._role_maker.get_trainer_endpoints()
        return ",".join(eps) if to_string else eps

    def server_endpoints(self, to_string: bool = False):
        eps = self._role_maker.get_pserver_endpoints()
        return ",".join(eps) if to_string else eps

    # -- tables ------------------------------------------------------------

    def register_sparse_table(self, table_id: int, config: Optional[TableConfig] = None):
        """Declare a sparse table (models declare theirs explicitly). Over
        rpc every worker creates it on the servers (a table that exists
        stays) and None returns; locally the table returns."""
        self._check_init()
        cfg = config or TableConfig(table_id=table_id)
        self._table_configs[table_id] = cfg
        if self._transport == "rpc":
            self._require_client().create_sparse_table(table_id, cfg)
            return None
        return self._server.create_sparse_table(table_id, cfg)

    def register_dense_table(self, table_id: int, dim: int, optimizer: str = "adam",
                             lr: float = 0.001):
        self._check_init()
        if self._transport == "rpc":
            self._require_client().create_dense_table(table_id, dim, optimizer, lr)
            return None
        return self._server.create_dense_table(table_id, dim, optimizer, lr)

    def register_geo_table(self, table_id: int, dim: int):
        self._check_init()
        if self._transport == "rpc":
            self._require_client().create_geo_table(table_id, dim)
            return None
        return self._server.create_geo_table(table_id, dim)

    def _require_client(self):
        enforce(self._client is not None,
                "rpc transport: call fleet.init_worker() before table registration/use on a "
                "worker", PreconditionNotMetError)
        return self._client

    @property
    def client(self):
        self._check_init()
        return self._client

    @property
    def communicator(self):
        return self._communicator

    # -- server lifecycle --------------------------------------------------

    def init_server(self, *args, **kwargs) -> None:
        """rpc: bind the native service at this server's endpoint (its host
        and port). local: the in-process barrier for the workers."""
        self._check_init()
        if self._transport == "rpc":
            from ..ps.rpc import NativePsServer

            ep = self._role_maker.get_pserver_endpoints()[self._role_maker.server_index()]
            host, port = ep.rsplit(":", 1)
            self._rpc_server = NativePsServer(port=int(port), host=host,
                                              n_trainers=max(self.worker_num(), 1))
            return
        self._server.barrier_table = BarrierTable(max(self.worker_num(), 1))

    def run_server(self) -> None:
        """rpc: serve until a worker sends STOP (polls every 0.2 s). local:
        the tables serve through direct calls; this marks the server live."""
        self._check_init()
        self._server_running.set()
        if self._transport == "rpc" and self._rpc_server is not None:
            while self._server_running.is_set() and not self._rpc_server.stopped:
                time.sleep(0.2)

    def stop_server(self) -> None:
        self._server_running.clear()
        if self._rpc_server is not None:
            self._rpc_server.close()
            self._rpc_server = None

    # -- worker lifecycle --------------------------------------------------

    def init_worker(self) -> None:
        """Connect (rpc), bind ``fleet.util``'s store, and create and start
        the communicator the strategy names (TheOnePSRuntime._init_worker):
        Geo for geo mode, Async for ``a_sync`` with ``k_steps`` < 0,
        HalfAsync for ``k_steps`` >= 0, Sync otherwise."""
        self._check_init()
        if self._transport == "rpc" and self._client is None:
            self._client = self._connect_rpc()
        self._init_util_store()
        s = self._strategy
        if s.is_geo_mode:
            self._communicator = GeoCommunicator(
                self._client, geo_step=int(s.geo_configs.get("geo_step", 100)))
        elif s.a_sync:
            k = int(s.a_sync_configs.get("k_steps", -1))
            cls = AsyncCommunicator if k < 0 else HalfAsyncCommunicator
            self._communicator = cls(self._client)
        else:
            self._communicator = SyncCommunicator(self._client)
        self._communicator.start()

    def _init_util_store(self) -> None:
        """Worker 0 hosts a ``TCPStore`` daemon at ``PADDLE_UTIL_STORE_PORT``
        on the first trainer endpoint's host (127.0.0.1 without one); the
        others connect, retrying for up to 60 s while it comes up. No port
        in the env: ``fleet.util`` stays local."""
        world = self._role_maker.worker_num()
        port = os.environ.get("PADDLE_UTIL_STORE_PORT")
        if world <= 1 or not self._role_maker.is_worker() or port is None:
            return
        eps = self._role_maker.get_trainer_endpoints()
        host = eps[0].split(":")[0] if eps else "127.0.0.1"
        rank = self._role_maker.worker_index()
        if rank == 0:
            store = TCPStore(host=host, port=int(port), is_master=True)
        else:
            deadline = time.perf_counter() + 60.0
            wait = 0.05
            while True:
                try:
                    store = TCPStore(host=host, port=int(port))
                    break
                except OSError:
                    if time.perf_counter() > deadline:
                        raise
                    time.sleep(wait)
                    wait = min(wait * 2, 2.0)
        self.util._bind(store, rank, world)

    def stop_worker(self) -> None:
        """Check out of ``fleet.util``'s store, then stop the communicator
        (which pushes what it still queues)."""
        self.util.shutdown()
        if self._communicator is not None:
            self._communicator.stop()
            self._communicator = None

    def barrier_worker(self) -> None:
        if self._communicator is not None:
            self._communicator.barrier()

    def _connect_rpc(self, timeout: float = 60.0):
        """Connect to every pserver endpoint, retrying while the servers
        bind (as BrpcPsClient retries its connect)."""
        from ..ps.rpc import RpcPsClient

        eps = self._role_maker.get_pserver_endpoints()
        deadline = time.monotonic() + timeout
        wait = 0.05
        while True:
            try:
                return RpcPsClient(eps)
            except PreconditionNotMetError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(wait)
                wait = min(wait * 2, 2.0)

    # -- save/load ---------------------------------------------------------

    def save_persistables(self, dirname: str, mode: int = 0) -> Dict[int, int]:
        """Save every registered sparse table to ``dirname/table_<id>`` (the
        text shard files and ``meta.json`` that either package's tables
        load); returns the rows saved per table."""
        self._check_init()
        return {tid: self._client.save(tid, f"{dirname}/table_{tid}", mode)
                for tid in self._sparse_table_ids()}

    def save_inference_model(self, dirname: str, fn, params, example_inputs,
                             freeze: bool = False) -> None:
        """Export the serving function (fleet_base.py:787): a
        ``torch.export`` program and its params (``io.inference``)."""
        self._check_init()
        from ..io.inference import save_inference_model as _save

        _save(dirname, fn, params, example_inputs, freeze=freeze)

    def load_model(self, dirname: str) -> Dict[int, int]:
        self._check_init()
        return {tid: self._client.load(tid, f"{dirname}/table_{tid}")
                for tid in self._sparse_table_ids()}

    def shrink(self) -> Dict[int, int]:
        self._check_init()
        return {tid: self._client.shrink(tid) for tid in self._sparse_table_ids()}

    def _sparse_table_ids(self):
        if self._transport == "rpc":
            return sorted(self._table_configs)
        return list(self._server.sparse_tables)

    # -- optimizer ---------------------------------------------------------

    def distributed_optimizer(self, optimizer, strategy: Optional[DistributedStrategy] = None,
                              reducer=None):
        """The reference's ``fleet.distributed_optimizer``
        (fleet_base.py:1438): the meta-optimizer chain of the strategy's
        dense flags (``meta_optimizers.apply_strategy``; the optimizer as it
        is without one). Sparse gradients go through the communicator, not
        the optimizer. ``reducer`` (a ``comm_fusion.DpGradReducer``) builds
        the chain on the pre-reduction contract: the dense dp gradients are
        reduced by the chain's own fused, optionally bf16/int8 bucket
        collectives, inside ``run_ranks``. Trainers that know their mesh
        build it themselves (``parallel.spmd.SpmdTrainer(..., strategy=,
        comm=)``); pass one here when wiring a step by hand."""
        self._check_init()
        if strategy is not None:
            self._strategy = strategy
        from .meta_optimizers import apply_strategy

        return apply_strategy(optimizer, self._strategy, reducer=reducer)

fleet = Fleet()
