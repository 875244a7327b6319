"""TCP parameter-server transport: the_one_ps's servers and client.

The port's own copy of ``paddle_tpu.ps.rpc`` over its own copy of the
native service (``csrc/ps_service.cc``, built into the SSD tier's
library, loaded by ``ps.native.load_ssd``). The wire is the JAX package's: a
44-byte request header (the trace-context field always zero), the same
command ids, status codes, value encodings and replication frames, so a
client of either package talks to the servers of either, and a primary
of either replicates to a backup of either.

- :class:`NativePsServer` hosts the C++ service in this process (accept
  loop and handler threads live in C++); ``port=0`` binds an ephemeral
  port. Its high-availability controls (the oplog tap, the create
  catalog, epoch, applied seq, read-only mode, dense version, the
  server's own faults) are what ``ps.ha`` drives.
- :class:`RpcPsClient` is the :class:`~paddle_tpu_torch.ps.client.PSClient`
  over N servers: sparse keys route by ``key % num_servers``, one request
  per server per call, fanned out concurrently (``FLAGS_ps_rpc_parallel``)
  and joined; duplicate keys merge client-side before a push; dense
  tables split into contiguous slices per server; the barrier lives on
  server 0. Each connection has per-call deadlines
  (``FLAGS_pserver_timeout_ms``, longer for table-scale commands) and
  retries a dead connection ``FLAGS_pserver_max_retry`` times with
  doubling backoff, reconnecting each time; then it raises
  :class:`~paddle_tpu_torch.core.enforce.PsTransportError`. With a
  ``router`` (``ps.ha.HARouter``) every shard op runs through
  :meth:`RpcPsClient._shard_op`: a circuit breaker per endpoint, and on a
  transport death the op replays on the backup the failover coordinator
  promoted. Nothing falls back to a local table.
- Live reshard (``ps.reshard`` drives it): a server whose ownership fence
  (``kRetain``) no longer covers a key bounces the whole frame with
  :class:`~paddle_tpu_torch.core.enforce.WrongShardError`; a routed client
  then re-resolves the epoch-stamped routing table (another shard count
  rebuilds its connection set) and replays exactly the bounced keys, each
  applied once (:meth:`RpcPsClient._bounce_guard`).
- The wires (``TableConfig.pull_wire_dtype``/``push_wire_dtype``): fp16
  pulls; fp16 or block-int8 push gradients, quantized once per merged
  push on the host (numpy), with the int8 error-feedback residuals kept
  per (table, key) and drained over the fp32 wire at the communicator's
  quiesce. The per-table ``ps_client_wire_bytes``/``ps_client_wire_rows``
  counters (``obs.registry``) count the encoded payload.
- :class:`RemoteSparseTable` is the table-shaped view over one sparse
  table on the servers (the hot tier's cold store).

Not ported (each raises ``UnavailableError`` naming its place in ROADMAP
Queue A item 3): tenancy (``tenant=``; entry 4), the serve QoS class
(``qos="serve"``; entry 5), and the per-table density series
(``density_series``, which needs ``distributed/placement.py``, item 10).
``op_counts`` is a plain counter under a lock.
"""

from __future__ import annotations

import ctypes
import json
import os
# lock discipline (the JAX module's): every client and server mutex is a
# leaf. `_mu` is the per-connection wire mutex; `_conns_mu` only swaps
# connections (connects build outside it); `_pool_mu`/`_count_mu`/
# `_pause_mu` guard scalars; `_ef_mu` guards the error-feedback store
# (gather, quantize, scatter under it; the network send outside).
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core import sync as _sync
from ..core.enforce import (NotFoundError, PreconditionNotMetError, PsTransportError,
                            UnavailableError, WrongShardError, enforce)
from ..core.flags import define_flag, flag
from ..obs import flightrec as _flightrec
from ..obs import registry as _obs_registry
from .accessor import AccessorConfig, make_accessor
from .client import PSClient
from .faultpoints import faultpoint
from .native import load_ssd, table_native_params
from .table import TableConfig, converter_entry, merge_duplicate_keys

__all__ = ["NativePsServer", "RemoteSparseTable", "RpcPsClient", "make_conn",
           "send_replicate"]

define_flag("pserver_connect_timeout_ms", 10000,
            "PS client TCP connect deadline (0 = blocking)")
define_flag("pserver_timeout_ms", 30000,
            "PS client per-call IO deadline (0 = block forever)")
define_flag("pserver_max_retry", 3,
            "attempts per PS call across reconnects before failing")
define_flag("pserver_retry_backoff_ms", 100,
            "base backoff between PS call retries (doubles per attempt)")
define_flag("pserver_long_call_timeout_ms", 600000,
            "deadline for table-scale commands (save/load/export/shrink/compact/ssd-create)")
define_flag("pserver_barrier_timeout_ms", 1800000,
            "barrier wait bound: peers may be minutes behind, a dead server still surfaces")
define_flag("ps_rpc_parallel", True,
            "fan multi-server PS calls out concurrently (one in-flight call per "
            "connection); False runs the servers one after another")
define_flag("ps_push_ef_max_rows", 1 << 20,
            "per-table cap on client-side error-feedback residual rows "
            "(push_wire_dtype='int8'): past it the whole table's residuals drain "
            "over the fp32 wire and the store restarts empty")

# command ids (ps_service.cc Cmd)
_CREATE_SPARSE = 1
_CREATE_DENSE = 2
_PULL_SPARSE = 3
_PUSH_SPARSE = 4
_PULL_DENSE = 5
_PUSH_DENSE = 6
_SET_DENSE = 7
_SIZE = 8
_SHRINK = 9
_INSERT_FULL = 12
_EXPORT = 13
_BARRIER = 14
_STOP = 15
_GLOBAL_STEP = 17
_CREATE_GEO = 18
_PUSH_GEO = 19
_PULL_GEO = 20
_SAVE_ALL = 21
_SPILL = 22
_STATS = 23
_COMPACT = 24
_LOAD_COLD = 34
_SAVE_FILE = 35
_LOAD_FILE = 36
# high availability (ps/ha.py drives these)
_REPLICATE = 37
_EPOCH = 38
_REPL_STATE = 39
_DIGEST = 40
_DENSE_SNAP = 41
_DENSE_RESTORE = 42
# live reshard (ps/reshard.py drives it): n = modulus (0 = read), aux = residue
_RETAIN = 44

# push-value wire encodings (csrc PushWireFlag: kPushSparse aux bits)
_PUSH_WIRE_F16 = 1
_PUSH_WIRE_I8 = 2
_PUSH_WIRE_BLOCK_SHIFT = 8

_ERR_NO_TABLE = -2  # ps_service.cc kErrNoTable
_ERR_READ_ONLY = -7  # kErrReadOnly
_ERR_WRONG_SHARD = -8  # kErrWrongShard
_ERR_RESET, _ERR_DEADLINE = -1000, -1001  # PsConn transport failures

_DENSE_OPT_IDS = {"sgd": 0, "adam": 1, "sum": 2}
_SAVE_FORMATS = {None: (0, ""), "gzip": (1, ".gz"), "raw": (2, ".bin")}


def _long_ms() -> int:
    """Deadline of a command whose run time grows with the table."""
    return int(flag("pserver_long_call_timeout_ms"))


class NativePsServer:
    """In-process native PS server (the accept loop and one handler thread
    per connection live in C++). ``host`` is the IPv4 address it listens
    on: loopback by default, ``"0.0.0.0"`` for every interface (the
    service has no authentication, and its save and SSD-table commands
    write to paths the caller names). ``port=0`` binds an ephemeral port
    (read ``.port``); ``n_trainers`` is how many arrivals release the
    barrier."""

    def __init__(self, port: int = 0, n_trainers: int = 1, host: str = "127.0.0.1") -> None:
        self._lib = load_ssd()
        self._h = self._lib.pss_create(host.encode(), int(port), int(n_trainers))
        enforce(self._h is not None, f"failed to bind PS server {host}:{port}")
        self.port = int(self._lib.pss_port(self._h))
        self._pause_mu = _sync.Lock()
        self._pause_depth = 0

    def pause_mutations(self, paused: bool) -> None:
        """Quiesce writers (a mutating request blocks, within its IO
        deadline; reads go on) while a snapshot takes a consistent cut.
        ``pause_mutations(True)`` returns once no mutation is in flight.
        Pause/resume pairs NEST (depth-counted), so an inner pair's resume
        never releases an outer gate mid-capture; a resume without a
        matching pause raises before it changes anything."""
        with self._pause_mu:
            enforce(paused or self._pause_depth > 0,
                    "pause_mutations(False) without a matching pause")
            self._pause_depth += 1 if paused else -1
            self._lib.pss_pause_mutations(self._h, 1 if self._pause_depth > 0 else 0)

    def stop(self) -> None:
        """Stop serving (the handle stays until :meth:`close`)."""
        if self._h:
            self._lib.pss_stop(self._h)

    @property
    def stopped(self) -> bool:
        return self._h is None or bool(self._lib.pss_stopped(self._h))

    # -- high availability (ps/ha.py) ------------------------------------------

    def set_replication(self, enable: bool, cap_entries: int = 0) -> None:
        """Start/stop tapping mutating request frames into the oplog ring
        (bounded at ``cap_entries``; an overflow drops the oldest entry and
        the shipper sees the seq gap and resyncs by snapshot)."""
        self._lib.pss_set_replication(self._h, 1 if enable else 0, int(cap_entries))

    def oplog_next(self, timeout_ms: int = 100):
        """Pop the next oplog entry (one consumer: the shipper thread):
        ``(seq, frame_bytes)``, ``(-1, None)`` on timeout, ``(-2, None)``
        once the server is stopping and the ring is empty. A frame is
        ``[request header][payload]``."""
        seq = int(self._lib.pss_oplog_next(self._h, int(timeout_ms)))
        if seq < 0:
            return seq, None
        return seq, self._staged(int(self._lib.pss_staged_len(self._h)))

    def _staged(self, n: int) -> bytes:
        buf = ctypes.create_string_buffer(n)
        ctypes.memmove(buf, self._lib.pss_staged_ptr(self._h), n)
        return buf.raw

    def oplog_seq(self) -> int:
        return int(self._lib.pss_oplog_seq(self._h))

    def oplog_pending(self) -> int:
        return int(self._lib.pss_oplog_pending(self._h))

    def oplog_dropped(self) -> int:
        return int(self._lib.pss_oplog_dropped(self._h))

    def catalog(self) -> List[bytes]:
        """Every create-table frame seen so far (replayed to a rejoining
        backup before the data snapshot). Copied into buffers of its own,
        not the shipper's staging buffer: a migration's snapshot reads the
        catalog on its own thread while the shipper pops the oplog."""
        out = []
        for i in range(int(self._lib.pss_catalog_count(self._h))):
            n = int(self._lib.pss_catalog_copy(self._h, i, None, 0))
            if n >= 0:
                buf = ctypes.create_string_buffer(max(n, 1))
                self._lib.pss_catalog_copy(self._h, i, buf, n)
                out.append(buf.raw[:n])
        return out

    @property
    def epoch(self) -> int:
        return int(self._lib.pss_epoch(self._h))

    def set_epoch(self, epoch: int) -> None:
        self._lib.pss_set_epoch(self._h, int(epoch))

    @property
    def applied_seq(self) -> int:
        return int(self._lib.pss_applied_seq(self._h))

    def set_read_only(self, on: bool) -> None:
        """Read-only mode: training-plane mutations (push, geo, shrink,
        create-exports, bulk load) bounce with ``kErrReadOnly``;
        insert-on-miss pulls read missing rows as zeros. The replication
        plane (kReplicate, snapshot inserts, dense restore, creates) stays
        open."""
        self._lib.pss_set_read_only(self._h, 1 if on else 0)

    @property
    def read_only(self) -> bool:
        return bool(self._lib.pss_read_only(self._h))

    @property
    def dense_version(self) -> int:
        """Count of dense mutations applied (direct or replicated)."""
        return int(self._lib.pss_dense_version(self._h))

    def arm_fault(self, name: str, cmd: int = 0, after: int = 1, param: int = 0) -> None:
        """Arm a server-side fault (``kill-shard``, ``drop-frame``,
        ``close-socket``, ``delay-ms``): it fires once ``after`` matching
        requests (``cmd`` 0 = any) have been seen, before the request
        changes any state; ``delay-ms`` stays armed with ``param`` ms."""
        self._lib.pss_arm_fault(self._h, name.encode(), int(cmd), int(after), int(param))

    def close(self) -> None:
        """Stop and release the server (idempotent)."""
        if getattr(self, "_h", None):
            self._lib.pss_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _ServerConn:
    """One TCP connection (C++ ``PsConn``) with connect and per-call IO
    deadlines, bounded retry with doubling backoff, and reconnect after a
    transport failure (the framed stream is undefined then, so the socket
    is rebuilt, never reused). A retry replays the command: at-least-once,
    as brpc's channel retry; ``retries=0`` opts a call out (barrier,
    shrink, spill, server-side save/load). The fault site ``rpc.call``
    sits inside the retry loop, so an injected fault walks the recovery
    path a real one would."""

    def __init__(self, lib: ctypes.CDLL, host: str, port: int) -> None:
        self._lib = lib
        self._host, self._port = host, port
        self.endpoint = f"{host}:{port}"
        self._h = None
        # one caller owns connect/call/close at a time: a reconnect frees
        # the C++ PsConn another thread could be calling through
        self._mu = _sync.RLock()
        self._connect()

    def _connect(self) -> None:
        self._h = self._lib.psc_connect2(self._host.encode(), self._port,
                                         int(flag("pserver_connect_timeout_ms")),
                                         int(flag("pserver_timeout_ms")))
        if not self._h:
            raise PsTransportError(
                f"cannot connect to PS server {self.endpoint} "
                f"(connect timeout {flag('pserver_connect_timeout_ms')} ms)")

    def close(self) -> None:
        with self._mu:
            if self._h:
                self._lib.psc_close(self._h)
                self._h = None

    def __del__(self):
        self.close()

    def _call_once(self, cmd, table_id, n, aux, ptrs, lens, nparts, timeout_ms, view):
        status = int(self._lib.psc_callv(self._h, cmd, table_id, n, aux, nparts, ptrs, lens,
                                         -1 if timeout_ms is None else timeout_ms))
        if status <= _ERR_RESET:
            self.close()
            kind = "timed out" if status == _ERR_DEADLINE else "reset/refused"
            raise PsTransportError(f"PS transport to {self.endpoint} {kind} (cmd {cmd})")
        rlen = int(self._lib.psc_resp_len(self._h))
        if not rlen:
            return status, b""
        if view:
            # the calling thread's native response buffer, valid until its
            # next call: callers scatter it into their outputs at once
            ptr = self._lib.psc_resp_ptr(self._h)
            return status, np.ctypeslib.as_array(
                ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)), shape=(rlen,))
        resp = ctypes.create_string_buffer(rlen)
        self._lib.psc_resp_copy(self._h, resp)
        return status, resp.raw

    def call(self, cmd: int, table_id: int = 0, n: int = 0, aux: int = 0,
             payload: Union[bytes, np.ndarray, Sequence[np.ndarray], None] = None,
             retries: Optional[int] = None, timeout_ms: Optional[int] = None,
             view: bool = False):
        """(status, response). ``payload``: bytes, one array or a sequence
        of C-contiguous arrays, sent scatter-gather (the arrays themselves
        are the frame). ``retries``: attempts beyond the first (default
        ``FLAGS_pserver_max_retry - 1``). ``timeout_ms``: this call's
        deadline (None: the connection's, 0: none). ``view``: the response
        as a uint8 view of this thread's native buffer, valid until the
        thread's next call."""
        if payload is None:
            parts: Tuple = ()
        elif isinstance(payload, (bytes, bytearray, np.ndarray)):
            parts = (payload,)
        else:
            parts = tuple(payload)
        nparts = len(parts)
        ptrs = (ctypes.c_void_p * max(nparts, 1))()
        lens = (ctypes.c_uint64 * max(nparts, 1))()
        keep = []  # bytes parts stay alive through every attempt
        for i, part in enumerate(parts):
            if isinstance(part, np.ndarray):
                enforce(part.flags["C_CONTIGUOUS"],
                        "scatter-gather payload parts must be C-contiguous")
                ptrs[i] = part.ctypes.data
                lens[i] = part.nbytes
            else:
                b = bytes(part)
                keep.append(b)
                ptrs[i] = ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p)
                lens[i] = len(b)
        if retries is None:
            retries = max(0, int(flag("pserver_max_retry")) - 1)
        backoff = int(flag("pserver_retry_backoff_ms")) / 1000.0
        last: Optional[Exception] = None
        for attempt in range(retries + 1):
            try:
                faultpoint("rpc.call", cmd=cmd, close=self.close)
                with self._mu:
                    if self._h is None:
                        self._connect()
                    return self._call_once(cmd, table_id, n, aux, ptrs, lens, nparts,
                                           timeout_ms, view)
            except PsTransportError as e:
                last = e
                if attempt < retries:
                    time.sleep(backoff * (2 ** attempt))
        raise PsTransportError(f"PS server {self.endpoint} unreachable after "
                               f"{retries + 1} attempt(s): {last}")

    def check(self, cmd: int, table_id: int = 0, n: int = 0, aux: int = 0, payload=None,
              **kw):
        """:meth:`call`, raising on an error status."""
        status, resp = self.call(cmd, table_id, n, aux, payload, **kw)
        if status == _ERR_NO_TABLE:
            raise NotFoundError(f"table {table_id} not created on server {self.endpoint}")
        if status == _ERR_READ_ONLY:
            raise PreconditionNotMetError(
                f"PS server {self.endpoint} is read-only: training-plane command {cmd} "
                "refused")
        if status == _ERR_WRONG_SHARD:
            raise WrongShardError(
                f"PS server {self.endpoint} no longer owns a key in this request (cmd {cmd}, "
                f"table {table_id}): the shard topology moved (live reshard); re-resolve the "
                "routing table and replay")
        enforce(status >= 0, f"PS command {cmd} on {self.endpoint} failed with status {status}")
        return status, resp


def make_conn(endpoint: str) -> _ServerConn:
    """One connection to ``endpoint`` ("host:port"): the replication
    shipper's channel to a backup (``ps.ha``)."""
    host, port = endpoint.rsplit(":", 1)
    return _ServerConn(load_ssd(), host, int(port))


def send_replicate(conn: _ServerConn, frame: bytes, seq: int, epoch: int,
                   retries: Optional[int] = None) -> int:
    """Ship one oplog entry (``frame`` as ``NativePsServer.oplog_next``
    gives it) to a backup as a kReplicate command. Returns the server's
    status: the acked seq, or -5 (stale epoch: the sender is fenced) or -6
    (seq gap: the backup needs a snapshot). The fault site ``repl.ship``
    can corrupt the epoch stamp to exercise the fence."""
    spec = faultpoint("repl.ship", close=conn.close)
    if spec is not None and spec.action == "corrupt-epoch":
        epoch = spec.param
    status, _ = conn.call(_REPLICATE, 0, n=int(seq), aux=int(epoch), payload=frame,
                          retries=retries)
    return int(status)


def _sparse_config_payload(cfg: TableConfig) -> bytes:
    ip, fp = table_native_params(cfg.shard_num, cfg.accessor,
                                 cfg.accessor_config or AccessorConfig(), cfg.seed)
    return ip.tobytes() + fp.tobytes()


def _quant_push_int8(grad: np.ndarray, block: int) -> Tuple[np.ndarray, np.ndarray]:
    """Block-wise symmetric int8 over the gradient block: one fp32 absmax
    scale per block, blocks tiling a row (nblk = ceil(gd / block); the
    last block may be ragged, and its zero pad never raises the absmax).
    Returns (q int8 [n, gd], scales f32 [n, nblk])."""
    n, gd = grad.shape
    nblk = -(-gd // block)
    pad = nblk * block - gd
    g = np.pad(grad, ((0, 0), (0, pad))) if pad else grad
    gb = g.reshape(n, nblk, block)
    amax = np.max(np.abs(gb), axis=2)
    scales = (amax / np.float32(127.0)).astype(np.float32)
    inv = np.where(scales > 0, np.float32(1.0) / scales, np.float32(0.0)).astype(np.float32)
    q = np.clip(np.rint(gb * inv[:, :, None]), -127, 127).astype(np.int8)
    return np.ascontiguousarray(q.reshape(n, nblk * block)[:, :gd]), scales


def _dequant_push_int8(q: np.ndarray, scales: np.ndarray, block: int) -> np.ndarray:
    """Inverse of :func:`_quant_push_int8`: float32(q) * scale, the f32
    multiply the server's ``decode_push_rows`` applies, so the client's
    error-feedback residual is taken against exactly what the server (and
    every backup replaying the frame) adds to the rows."""
    n, gd = q.shape
    nblk = scales.shape[1]
    pad = nblk * block - gd
    qq = np.pad(q, ((0, 0), (0, pad))) if pad else q
    out = qq.reshape(n, nblk, block).astype(np.float32) * scales[:, :, None]
    return out.reshape(n, nblk * block)[:, :gd]


class RpcPsClient(PSClient):
    """:class:`~paddle_tpu_torch.ps.client.PSClient` over N TCP servers
    (see the module docstring). ``endpoints`` are ``"host:port"``;
    ``router`` is an ``ps.ha.HARouter`` (None: the static topology, no
    breaker, no failover)."""

    def __init__(self, endpoints: Sequence[str], router: Optional[object] = None,
                 qos: str = "train", tenant: Optional[Tuple[int, bytes]] = None) -> None:
        if qos != "train":
            raise UnavailableError(
                f"RpcPsClient(qos={qos!r}): the serve QoS class is not ported yet "
                "(ROADMAP Queue A item 3, entry 5, with serving)")
        if tenant is not None:
            raise UnavailableError("RpcPsClient(tenant=...): tenancy is not ported yet "
                                   "(ROADMAP Queue A item 3, entry 4)")
        self._lib = load_ssd()
        self.qos = qos
        self._sparse_dims: Dict[int, Tuple[int, int, int]] = {}  # pull, push, full
        self._sparse_cfgs: Dict[int, TableConfig] = {}
        self._dense_dims: Dict[int, int] = {}
        self._geo_dims: Dict[int, int] = {}
        self._wire_f16: Dict[int, bool] = {}  # table -> fp16 pull values
        # table -> (push wire dtype, int8 block, error feedback on)
        self._push_wire: Dict[int, Tuple[str, int, bool]] = {}
        # error-feedback residuals: table -> {key -> f32 gradient residual}
        self._push_ef: Dict[int, Dict[int, np.ndarray]] = {}
        self._ef_mu = _sync.Lock()
        # per-table wire counters, bound when the table is created
        self._tbl_obs: Dict[int, Dict[str, object]] = {}
        self._router = router
        self._conns_mu = _sync.Lock()  # failover connection swaps
        self._pool: Optional[ThreadPoolExecutor] = None
        self._retired_pools: List[ThreadPoolExecutor] = []  # outgrown by a reshard
        self._pool_mu = _sync.Lock()
        self._count_mu = _sync.Lock()
        self._ops: Counter = Counter()
        self._conns: List[_ServerConn] = []
        try:
            for ep in endpoints:
                host, port = ep.rsplit(":", 1)
                self._conns.append(_ServerConn(self._lib, host, int(port)))
        except BaseException:
            self.close()
            raise

    # -- op counts and wire counters -----------------------------------------

    def _op_count(self, op: str) -> None:
        with self._count_mu:
            self._ops[op] += 1

    @property
    def op_counts(self) -> Counter:
        """Client ops since the last :meth:`reset_op_counts`, one per call
        whatever its fan-out (zero entries left out)."""
        with self._count_mu:
            return Counter(self._ops)

    def reset_op_counts(self) -> Dict[str, int]:
        """The counts since the last reset, then zero."""
        with self._count_mu:
            out, self._ops = dict(self._ops), Counter()
        return out

    def _bind_table_obs(self, table_id: int) -> None:
        """Bind the table's wire counters (bytes and rows, a series per
        direction) on the create path; with ``FLAGS_obs_metrics`` off
        nothing is bound and the data path skips the accounting."""
        if not _obs_registry.metrics_enabled():
            self._tbl_obs.pop(table_id, None)
            return
        t, reg = str(table_id), _obs_registry.REGISTRY
        self._tbl_obs[table_id] = {
            f"{d}_{what}": reg.counter(f"ps_client_wire_{what}", table=t, dir=d)
            for d in ("pull", "push") for what in ("bytes", "rows")}

    def density_series(self, table_id: int, direction: str = "push"):
        """Not ported: the windowed density series needs
        ``distributed/placement.py`` (ROADMAP Queue A item 10)."""
        raise UnavailableError(
            "RpcPsClient.density_series needs distributed/placement.DensitySeries, which "
            "is not ported yet (ROADMAP Queue A item 10)")

    @property
    def num_servers(self) -> int:
        return len(self._conns)

    def close(self) -> None:
        """Shut the fan-out pool and every connection (close the client
        before its servers: a connection to a stopped server waits out its
        deadline)."""
        with self._pool_mu:
            pool, self._pool = self._pool, None
            retired, self._retired_pools = self._retired_pools, []
        for p in ([pool] if pool is not None else []) + retired:
            p.shutdown(wait=True)
        for c in self._conns:
            c.close()

    # -- failover (router-gated; plain calls without a router) ---------------

    def _swap_conn(self, s: int, endpoint: str) -> None:
        """Point shard ``s`` at ``endpoint`` (a promoted backup). Another
        thread may have swapped already: endpoint equality makes the swap
        idempotent and the loser's connection closes. The connect happens
        outside ``_conns_mu``, which every shard op takes."""
        with self._conns_mu:
            if s >= len(self._conns) or self._conns[s].endpoint == endpoint:
                return
        host, port = endpoint.rsplit(":", 1)
        fresh = _ServerConn(self._lib, host, int(port))
        with self._conns_mu:
            if s >= len(self._conns) or self._conns[s].endpoint == endpoint:
                stale = fresh  # raced: another swap (or a shrink) won
            else:
                stale, self._conns[s] = self._conns[s], fresh
        stale.close()

    def refresh_routing(self) -> bool:
        """Re-resolve every shard's endpoint and the shard count from the
        router's routing table; True if the connection set changed. A caller
        holding a failed future (the communicator's prefetched pull)
        refreshes and replays, and so does a ``WrongShardError`` bounce (a
        live reshard moved a key class): the client rebuilds its topology
        and the op replays the bounced keys. No-op without a router."""
        if self._router is None:
            return False
        _, eps = self._router.routing()
        if not eps:
            return False
        with self._conns_mu:
            if [c.endpoint for c in self._conns] == list(eps):
                return False
            have = {c.endpoint for c in self._conns}
        # connect outside _conns_mu (every shard op takes it); a partial
        # failure closes what it built
        built: Dict[str, _ServerConn] = {}
        try:
            for ep in eps:
                if ep not in have and ep not in built:
                    host, port = ep.rsplit(":", 1)
                    built[ep] = _ServerConn(self._lib, host, int(port))
        except BaseException:
            for c in built.values():
                c.close()
            raise
        with self._conns_mu:
            old, conns = self._conns, []
            for ep in eps:
                cur = next((c for c in old if c.endpoint == ep), None)
                if cur is None:
                    cur = built.pop(ep, None)
                if cur is None:
                    # an endpoint a concurrent refresh dropped between the
                    # two reads: the rare in-lock connect
                    host, port = ep.rsplit(":", 1)
                    cur = _ServerConn(self._lib, host, int(port))
                conns.append(cur)
            stale = [c for c in old if c not in conns]
            self._conns = conns
        for c in list(built.values()) + stale:
            c.close()
        # a grown topology outgrows the fan-out pool; the old one may carry
        # in-flight fan-outs, so it retires (close() shuts the retirees)
        with self._pool_mu:
            if self._pool is not None and len(conns) > self._pool._max_workers:
                self._retired_pools.append(self._pool)
                self._pool = None
        return True

    def _conn_at(self, s: int) -> _ServerConn:
        """Shard ``s``'s current connection; a shard index past the
        topology (a live reshard shrank it under this op) bounces as a
        misroute."""
        with self._conns_mu:
            if s >= len(self._conns):
                raise WrongShardError(f"shard {s} is beyond the current topology "
                                      f"({len(self._conns)} servers): stale routing")
            return self._conns[s]

    @staticmethod
    def _raise_if_shrunk(s: int, router) -> None:
        """A transport death on a shard index the routing no longer has is
        a shrink, not a dead primary: take the misroute path at once
        instead of waiting out a failover that cannot come."""
        _, eps = router.routing()
        if eps and s >= len(eps):
            raise WrongShardError(f"shard {s} left the topology ({len(eps)} shards "
                                  "published): stale routing")

    def _shard_op(self, s: int, fn):
        """Run ``fn(conn)`` against shard ``s``'s current server. With a
        router: gate the endpoint through its breaker (an open breaker
        fails fast instead of paying timeout × retries again), and on a
        transport death ask the router for the promoted replacement and
        replay ``fn`` there. A server's rejection (NotFoundError, a
        negative status) passes straight through and counts as a success
        for the breaker: the transport is alive, and a half-open probe
        must be released."""
        c = self._conn_at(s)
        r = self._router
        if r is None:
            return fn(c)
        ep = c.endpoint
        if not r.allow(ep):
            self._raise_if_shrunk(s, r)
            new_ep = r.failover(s, ep)
            if new_ep is None or new_ep == ep:
                raise PsTransportError(f"PS shard {s} endpoint {ep} circuit breaker open "
                                       "and no promoted replacement published")
            self._swap_conn(s, new_ep)
            c = self._conn_at(s)
            ep = c.endpoint
        try:
            out = fn(c)
        except PsTransportError as e:
            r.record(ep, ok=False)
            rec = _flightrec.installed()
            if rec is not None:
                rec.note("transport_error", shard=s, endpoint=ep,
                         error=f"{type(e).__name__}: {e}")
            self._raise_if_shrunk(s, r)
            new_ep = r.failover(s, ep)
            if new_ep is None or new_ep == ep:
                raise
            self._swap_conn(s, new_ep)
            out = fn(self._conn_at(s))
            r.record(new_ep, ok=True)
            return out
        except BaseException:
            r.record(ep, ok=True)
            raise
        r.record(ep, ok=True)
        return out

    def _direct(self, server: int, fn):
        """Server-targeted call: no breaker, no failover replay (an
        introspection answer must come from the addressed server)."""
        return fn(self._conn_at(server))

    def _task(self, s: int, fn):
        """A zero-arg fan-out task bound to the shard index, not to a
        connection (failover may swap it between submit and run)."""
        return lambda: self._shard_op(s, fn)

    # -- fan-out ------------------------------------------------------------

    def _fanout(self, tasks: List):
        """Run one zero-arg task per server; results in task order.
        Concurrent under ``FLAGS_ps_rpc_parallel`` (the serial loop keeps
        server order); every task ends before this returns or raises, and
        the first error propagates."""
        if len(tasks) <= 1 or not flag("ps_rpc_parallel"):
            return [t() for t in tasks]
        with self._pool_mu:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=len(self._conns),
                                                thread_name_prefix="ps-rpc")
            futs = [self._pool.submit(t) for t in tasks]
        results, first_err = [], None
        for f in futs:
            try:
                results.append(f.result())
            except BaseException as e:  # noqa: BLE001 — re-raised below
                first_err = first_err or e
                results.append(None)
        if first_err is not None:
            raise first_err
        return results

    def _each_server(self, fn):
        """``fn(conn)`` on every shard, fanned out; results by shard."""
        return self._fanout([self._task(s, fn) for s in range(self.num_servers)])

    def _shard_sel(self, keys: np.ndarray):
        """(server, sel) for the servers that own some of ``keys`` under
        one read of the shard count; sel is None when one server owns them
        all (no gather copy)."""
        n = self.num_servers
        sv = (keys % np.uint64(n)).astype(np.int64)
        out = []
        for s in range(n):
            sel = np.flatnonzero(sv == s)
            if len(sel) == len(sv):
                out.append((s, None))
            elif len(sel):
                out.append((s, sel))
        return out

    # -- the live-reshard misroute replay (ps/reshard.py) ------------------

    _REROUTE_HOPS = 8

    def _bounce_guard(self, s: int, fn, misrouted: List, sel, n_keys: int):
        """Fan-out task of a keyed op: a ``WrongShardError`` bounce (or a
        shard index past a shrunk topology) records which key positions
        bounced instead of failing the op. The server rejected the frame
        whole, so the op re-resolves and replays exactly those keys, each
        applied once. Without a router there is nothing to re-resolve and
        the error propagates. ``misrouted.append`` from the fan-out workers
        is atomic under the GIL."""
        def run():
            try:
                self._shard_op(s, fn)
            except WrongShardError:
                if self._router is None:
                    raise
                misrouted.append(np.arange(n_keys, dtype=np.int64) if sel is None else sel)
        return run

    def _keyed(self, keys: np.ndarray, one) -> Optional[np.ndarray]:
        """``one(conn, sel)`` for each shard owning some of ``keys``; the
        positions of the keys that bounced (None if none did)."""
        misrouted: List[np.ndarray] = []
        self._fanout([self._bounce_guard(s, lambda c, sel=sel: one(c, sel), misrouted, sel,
                                         len(keys))
                      for s, sel in self._shard_sel(keys)])
        return np.concatenate(misrouted) if misrouted else None

    def _reroute_backoff(self, hops: int) -> None:
        """Between misroute replays: re-resolve the routing table, and when
        it has not changed yet (a cutover installs the ownership fence a
        moment before it publishes the flipped routing) back off briefly.
        Raises once the hop budget is spent: a topology that stays stale
        means the reshard wedged mid-cutover."""
        enforce(hops < self._REROUTE_HOPS,
                f"misrouted PS op: topology still stale after {hops} re-resolves "
                "(a reshard wedged mid-cutover?)", WrongShardError)
        if not self.refresh_routing() and hops > 0:
            time.sleep(min(0.002 * (2 ** hops), 0.1))

    def _dims(self, table_id: int) -> Tuple[int, int, int]:
        try:
            return self._sparse_dims[table_id]
        except KeyError:
            raise NotFoundError(f"sparse table {table_id} not created via this client") \
                from None

    # -- table lifecycle ----------------------------------------------------

    def create_sparse_table(self, table_id: int, config: Optional[TableConfig] = None) -> None:
        """Create ``table_id`` on every server (RAM, or the SSD tier at
        ``config.ssd_path/table<id>/server<s>``); a table that exists
        already stays as it is."""
        cfg = config or TableConfig(table_id=table_id)
        enforce(cfg.pull_wire_dtype in ("fp32", "fp16"),
                f"TableConfig.pull_wire_dtype must be 'fp32' or 'fp16', got "
                f"{cfg.pull_wire_dtype!r}")
        enforce(cfg.push_wire_dtype in ("fp32", "fp16", "int8"),
                f"TableConfig.push_wire_dtype must be 'fp32', 'fp16' or 'int8', got "
                f"{cfg.push_wire_dtype!r}")
        block = int(cfg.push_wire_block)
        enforce(1 <= block <= 0xFFFF,
                f"TableConfig.push_wire_block must be in [1, 65535], got {block}")
        enforce(cfg.ssd_value_dtype in ("fp32", "fp16"),
                f"TableConfig.ssd_value_dtype must be 'fp32' or 'fp16', got "
                f"{cfg.ssd_value_dtype!r}")
        if cfg.storage == "ssd":
            enforce(cfg.ssd_path is not None, "TableConfig.storage='ssd' requires ssd_path")
        self._sparse_cfgs[table_id] = cfg
        self._wire_f16[table_id] = cfg.pull_wire_dtype == "fp16"
        self._push_wire[table_id] = (cfg.push_wire_dtype, block, bool(cfg.push_error_feedback))
        base = _sparse_config_payload(cfg)

        def mk(s, c):
            payload = base
            if cfg.storage == "ssd":
                # low byte 1 = ssd; bit 8 = fp16 value columns on disk
                storage = 1 | (0x100 if cfg.ssd_value_dtype == "fp16" else 0)
                path = f"{cfg.ssd_path}/table{table_id}/server{s}".encode()
                payload = (base + np.asarray([storage], np.int32).tobytes()
                           + np.asarray([len(path)], np.uint32).tobytes() + path)
            _, resp = c.check(_CREATE_SPARSE, table_id, payload=payload,
                              timeout_ms=_long_ms())
            d = np.frombuffer(resp, np.int32)
            return int(d[0]), int(d[1]), int(d[2])

        dims = self._fanout([self._task(s, lambda c, s=s: mk(s, c))
                             for s in range(self.num_servers)])
        enforce(len(set(dims)) == 1, f"servers disagree on table {table_id} dims: {dims}")
        self._sparse_dims[table_id] = dims[0]
        self._bind_table_obs(table_id)

    def sparse_config(self, table_id: int) -> TableConfig:
        """The config this client created ``table_id`` with."""
        cfg = self._sparse_cfgs.get(table_id)
        enforce(cfg is not None, f"sparse table {table_id} not created via this client")
        return cfg

    def create_dense_table(self, table_id: int, dim: int, optimizer: str = "adam",
                           lr: float = 0.001) -> None:
        enforce(optimizer in _DENSE_OPT_IDS, f"unknown dense optimizer {optimizer!r}")
        self._dense_dims[table_id] = dim
        self._bind_table_obs(table_id)
        for s in range(self.num_servers):
            payload = (np.asarray([len(self._dense_slice(dim, s)), _DENSE_OPT_IDS[optimizer]],
                                  np.int32).tobytes()
                       + np.asarray([lr], np.float32).tobytes())
            self._shard_op(s, lambda c, pl=payload: c.check(_CREATE_DENSE, table_id,
                                                            payload=pl))

    def create_geo_table(self, table_id: int, dim: int) -> None:
        self._geo_dims[table_id] = dim
        payload = np.asarray([dim], np.int32).tobytes()
        for s in range(self.num_servers):
            self._shard_op(s, lambda c: c.check(_CREATE_GEO, table_id, payload=payload))

    def _dense_slice(self, dim: int, server: int) -> range:
        per = (dim + self.num_servers - 1) // self.num_servers
        lo = min(per * server, dim)
        return range(lo, min(lo + per, dim))

    # -- sparse -------------------------------------------------------------

    def pull_sparse(self, table_id, keys, create=True, slots=None):
        """[n, pull_dim] values of ``keys`` (insert-on-miss with
        ``create``; ``slots`` tags created rows). Over the fp16 pull wire
        the values are exactly the fp32 rows rounded to half and widened."""
        self._op_count("pull_sparse")
        return self._pull_sparse(table_id, keys, create, slots)

    def _pull_sparse(self, table_id, keys, create, slots, _hops=0):
        keys = np.ascontiguousarray(keys, np.uint64)
        pull_dim = self._dims(table_id)[0]
        out = np.zeros((len(keys), pull_dim), np.float32)
        slots_arr = (np.ascontiguousarray(slots, np.int32) if slots is not None
                     else np.zeros(len(keys), np.int32))
        f16 = self._wire_f16.get(table_id, False)
        aux = (1 if create else 0) | (2 if f16 else 0)

        def one(c, sel):
            kp = keys if sel is None else keys[sel]
            sp = slots_arr if sel is None else slots_arr[sel]
            _, resp = c.check(_PULL_SPARSE, table_id, n=len(kp), aux=aux, payload=(kp, sp),
                              view=True)
            vals = resp.view(np.float16).astype(np.float32) if f16 else resp.view(np.float32)
            if sel is None:
                out[:] = vals.reshape(len(kp), pull_dim)
            else:
                out[sel] = vals.reshape(len(kp), pull_dim)

        idx = self._keyed(keys, one)
        if idx is not None:
            self._reroute_backoff(_hops)
            out[idx] = self._pull_sparse(table_id, keys[idx], create, slots_arr[idx], _hops + 1)
        m = self._tbl_obs.get(table_id) if _hops == 0 else None
        if m is not None:
            m["pull_rows"].inc(len(keys))
            m["pull_bytes"].inc(keys.nbytes + slots_arr.nbytes + out.size * (2 if f16 else 4))
        return out

    def push_sparse(self, table_id, keys, values):
        """Push [n, push_dim] rows (slot, show, click, gradients); duplicate
        keys merge client-side first, then the gradient block is encoded
        once for the table's push wire."""
        self._op_count("push_sparse")
        self._push_sparse(table_id, keys, values)

    def _push_sparse(self, table_id, keys, values, _wire=None):
        keys, values = merge_duplicate_keys(np.ascontiguousarray(keys, np.uint64),
                                            np.ascontiguousarray(values, np.float32))
        wire, block, ef_on = ((_wire, 0, False) if _wire is not None else
                              self._push_wire.get(table_id, ("fp32", 0, False)))
        gd = values.shape[1] - 3 if values.ndim == 2 else 0
        overflow = False
        if wire == "fp32" or gd <= 0:
            enc, aux = None, 0
            wire_bytes = keys.nbytes + values.nbytes
        else:
            # quantize once for the whole merged batch, before routing: a
            # failover replay re-sends the same encoded slices, so the
            # residual (already advanced for these rows) is never counted
            # twice and every replica applies exactly these bytes
            head = np.ascontiguousarray(values[:, :3])
            grad = values[:, 3:]
            if wire == "fp16":
                enc = (head, np.ascontiguousarray(grad.astype(np.float16)))
                aux = _PUSH_WIRE_F16
            else:
                blk = min(block, gd)
                if ef_on:
                    with self._ef_mu:
                        g = grad + self._ef_gather(table_id, keys, gd)
                        q, scales = _quant_push_int8(g, blk)
                        self._ef_scatter(table_id, keys, g - _dequant_push_int8(q, scales, blk))
                        overflow = (len(self._push_ef.get(table_id, ()))
                                    > int(flag("ps_push_ef_max_rows")))
                else:
                    q, scales = _quant_push_int8(grad, blk)
                enc = (head, scales, q)
                aux = _PUSH_WIRE_I8 | (blk << _PUSH_WIRE_BLOCK_SHIFT)
            wire_bytes = keys.nbytes + sum(a.nbytes for a in enc)
        self._push_encoded(table_id, keys, values if enc is None else None, enc, aux, 0)
        if overflow:
            # bounded client memory: past the cap the table's residuals drain
            # over the fp32 wire (outside _ef_mu: the drain is a push)
            self.drain_push_residuals(table_id)
        m = self._tbl_obs.get(table_id)
        if m is not None:
            m["push_rows"].inc(len(keys))
            m["push_bytes"].inc(wire_bytes)

    def _push_encoded(self, table_id, keys, values, enc, aux, _hops) -> None:
        """Route and fan out one encoded push batch: ``enc`` None ships
        ``values`` raw (fp32), else the tuple of encoded parts (head
        [, scales], gradient) whose row slices each shard gets. A bounced
        slice changed nothing on its server, so the replay re-sends those
        same encoded rows (no int8 residual is taken twice)."""

        def one(c, sel):
            kp = keys if sel is None else keys[sel]
            if enc is None:
                parts = (kp, values if sel is None else values[sel])
            else:
                parts = (kp,) + tuple(a if sel is None else np.ascontiguousarray(a[sel])
                                      for a in enc)
            c.check(_PUSH_SPARSE, table_id, n=len(kp), aux=aux, payload=parts)

        idx = self._keyed(keys, one)
        if idx is not None:
            self._reroute_backoff(_hops)
            self._push_encoded(table_id, keys[idx], None if values is None else values[idx],
                               None if enc is None else tuple(a[idx] for a in enc), aux,
                               _hops + 1)

    # -- error-feedback residuals (push_wire_dtype="int8") -----------------

    def _ef_gather(self, table_id: int, keys: np.ndarray, gd: int) -> np.ndarray:
        """Residual rows of ``keys`` (zeros for keys never quantized); the
        caller holds ``_ef_mu``."""
        store = self._push_ef.setdefault(table_id, {})
        out = np.zeros((len(keys), gd), np.float32)
        for i, k in enumerate(keys.tolist()):
            r = store.get(k)
            if r is not None:
                out[i] = r
        return out

    def _ef_scatter(self, table_id: int, keys: np.ndarray, resid: np.ndarray) -> None:
        """Store the fresh residuals (the caller holds ``_ef_mu``)."""
        store = self._push_ef.setdefault(table_id, {})
        for i, k in enumerate(keys.tolist()):
            store[k] = resid[i].copy()

    def push_residual_rows(self, table_id: Optional[int] = None) -> int:
        """Residual rows held client-side (0 after a drain)."""
        with self._ef_mu:
            if table_id is not None:
                return len(self._push_ef.get(table_id, ()))
            return sum(len(s) for s in self._push_ef.values())

    def drain_push_residuals(self, table_id: Optional[int] = None) -> int:
        """Push every held error-feedback residual over the fp32 wire and
        clear the store; returns the rows drained. ``Communicator.quiesce()``
        calls it, so after a quiesce no training signal lives client-side
        (the checkpoint cut). Drain rows carry show 1, click 0: the AdaGrad
        family divides the gradient by the pushed show, so a zero show would
        amplify the residual instead of applying it."""
        with self._ef_mu:
            if table_id is None:
                drained = {t: s for t, s in self._push_ef.items() if s}
                self._push_ef = {}
            else:
                drained = {table_id: self._push_ef.pop(table_id, {})}
        total = 0
        for tid, store in drained.items():
            if not store:
                continue
            keys = np.fromiter(store.keys(), np.uint64, len(store))
            vals = np.zeros((len(keys), self._dims(tid)[1]), np.float32)
            vals[:, 1] = 1.0  # show (see the docstring)
            resid = np.stack(list(store.values()))
            vals[:, 3:3 + resid.shape[1]] = resid
            self._op_count("push_sparse")
            self._push_sparse(tid, keys, vals, _wire="fp32")
            total += len(keys)
        return total

    def export_full(self, table_id, keys, create=False, slots=None, _hops=0):
        """(values [n, full_dim], found [n]): full rows, optimizer state
        included; with ``create`` missing rows are inserted in the same
        visit."""
        if _hops == 0:
            self._op_count("export_full")
        keys = np.ascontiguousarray(keys, np.uint64)
        full_dim = self._dims(table_id)[2]
        out = np.zeros((len(keys), full_dim), np.float32)
        found = np.zeros(len(keys), bool)
        slots_arr = (np.ascontiguousarray(slots, np.int32) if slots is not None
                     else np.zeros(len(keys), np.int32))

        def one(c, sel):
            kp = keys if sel is None else keys[sel]
            parts = (kp, slots_arr if sel is None else slots_arr[sel]) if create else (kp,)
            _, resp = c.check(_EXPORT, table_id, n=len(kp), aux=1 if create else 0,
                              payload=parts, timeout_ms=_long_ms(), view=True)
            nb = len(kp) * full_dim * 4
            vals = resp[:nb].view(np.float32).reshape(len(kp), full_dim)
            if sel is None:
                out[:], found[:] = vals, resp[nb:] != 0
            else:
                out[sel], found[sel] = vals, resp[nb:] != 0

        idx = self._keyed(keys, one)
        if idx is not None:
            self._reroute_backoff(_hops)
            out[idx], found[idx] = self.export_full(table_id, keys[idx], create,
                                                    slots_arr[idx], _hops + 1)
        m = self._tbl_obs.get(table_id) if _hops == 0 else None
        if m is not None:
            m["pull_rows"].inc(len(keys))
            m["pull_bytes"].inc(keys.nbytes + out.nbytes + found.nbytes)
        return out, found

    def import_full(self, table_id, keys, values, _hops=0):
        """Overwrite full rows (insert-on-miss)."""
        if _hops == 0:
            self._op_count("import_full")
        keys = np.ascontiguousarray(keys, np.uint64)
        values = np.ascontiguousarray(values, np.float32)

        def one(c, sel):
            kp = keys if sel is None else keys[sel]
            vp = values if sel is None else values[sel]
            c.check(_INSERT_FULL, table_id, n=len(kp), payload=(kp, vp), timeout_ms=_long_ms())

        idx = self._keyed(keys, one)
        if idx is not None:
            self._reroute_backoff(_hops)
            self.import_full(table_id, keys[idx], values[idx], _hops + 1)
        m = self._tbl_obs.get(table_id) if _hops == 0 else None
        if m is not None:
            m["push_rows"].inc(len(keys))
            m["push_bytes"].inc(keys.nbytes + values.nbytes)

    def load_cold(self, table_id, keys, values, chunk: int = 1 << 21, _hops=0) -> int:
        """Bulk-load full rows (SSD tables: into the disk tier; RAM tables
        insert). Each server's slice goes in chunks of ``chunk`` rows, the
        servers in parallel. A chunk that bounces (a reshard moved its
        class) replays with the rest of that server's slice after a
        re-resolve; the chunks before it landed and are not re-sent.
        Returns the rows loaded."""
        keys = np.ascontiguousarray(keys, np.uint64)
        values = np.ascontiguousarray(values, np.float32)
        full_dim = self._dims(table_id)[2]
        enforce(values.shape == (len(keys), full_dim),
                f"load_cold values shape {values.shape} != ({len(keys)}, {full_dim})")
        shards = self._shard_sel(keys)
        done = [0] * len(shards)
        misrouted: List[np.ndarray] = []

        def one(c, i, sel):
            for lo in range(0, len(sel), chunk):
                part = sel[lo:lo + chunk]
                try:
                    cnt, _ = c.check(_LOAD_COLD, table_id, n=len(part),
                                     payload=(keys[part], values[part]), timeout_ms=_long_ms())
                except WrongShardError:
                    if self._router is None:
                        raise
                    misrouted.append(sel[lo:])
                    return
                done[i] += int(cnt)

        def task(i, s, sel):
            sel = np.arange(len(keys), dtype=np.int64) if sel is None else sel

            def run():
                try:
                    self._shard_op(s, lambda c: one(c, i, sel))
                except WrongShardError:  # a shard index past a shrink: nothing sent
                    if self._router is None:
                        raise
                    misrouted.append(sel)
            return run

        self._fanout([task(i, s, sel) for i, (s, sel) in enumerate(shards)])
        total = sum(done)
        if misrouted:
            self._reroute_backoff(_hops)
            idx = np.concatenate(misrouted)
            total += self.load_cold(table_id, keys[idx], values[idx], chunk, _hops + 1)
        return total

    # -- dense and geo ------------------------------------------------------

    def pull_dense(self, table_id):
        self._op_count("pull_dense")
        try:
            dim = self._dense_dims[table_id]
        except KeyError:
            raise NotFoundError(f"dense table {table_id} not created via this client") \
                from None
        out = np.zeros(dim, np.float32)

        def one(c, sl):
            _, resp = c.check(_PULL_DENSE, table_id, view=True)
            out[sl.start:sl.stop] = resp.view(np.float32)

        self._fanout([self._task(s, lambda c, sl=self._dense_slice(dim, s): one(c, sl))
                      for s in range(self.num_servers) if len(self._dense_slice(dim, s))])
        m = self._tbl_obs.get(table_id)
        if m is not None:
            m["pull_bytes"].inc(out.nbytes)
        return out

    def _dense_send(self, cmd: int, table_id: int, values: np.ndarray) -> None:
        dim = self._dense_dims[table_id]
        self._fanout([self._task(s, lambda c, sl=self._dense_slice(dim, s):
                                 c.check(cmd, table_id, payload=values[sl.start:sl.stop]))
                      for s in range(self.num_servers) if len(self._dense_slice(dim, s))])

    def push_dense(self, table_id, grad):
        self._op_count("push_dense")
        grad = np.ascontiguousarray(grad, np.float32)
        m = self._tbl_obs.get(table_id)
        if m is not None:
            m["push_bytes"].inc(grad.nbytes)
        self._dense_send(_PUSH_DENSE, table_id, grad)

    def set_dense(self, table_id, values):
        self._dense_send(_SET_DENSE, table_id, np.ascontiguousarray(values, np.float32))

    def push_geo(self, table_id, keys, deltas, _hops=0):
        if _hops == 0:
            self._op_count("push_geo")
        keys = np.ascontiguousarray(keys, np.uint64)
        deltas = np.ascontiguousarray(deltas, np.float32)

        def one(c, sel):
            kp = keys if sel is None else keys[sel]
            dp = deltas if sel is None else deltas[sel]
            c.check(_PUSH_GEO, table_id, n=len(kp), payload=(kp, dp))

        idx = self._keyed(keys, one)
        if idx is not None:
            self._reroute_backoff(_hops)
            self.push_geo(table_id, keys[idx], deltas[idx], _hops + 1)

    def pull_geo(self, table_id):
        """(keys, mean deltas) drained from every server."""
        self._op_count("pull_geo")
        dim = self._geo_dims[table_id]

        def one(c):
            cnt, resp = c.check(_PULL_GEO, table_id, view=True)
            if not cnt:
                return None
            return (resp[:cnt * 8].view(np.uint64).copy(),
                    resp[cnt * 8:].view(np.float32).reshape(cnt, dim).copy())

        got = [g for g in self._each_server(one) if g]
        if not got:
            return np.zeros(0, np.uint64), np.zeros((0, dim), np.float32)
        return np.concatenate([k for k, _ in got]), np.concatenate([d for _, d in got])

    # -- coordination -------------------------------------------------------

    def barrier(self):
        """All-trainer barrier on server 0: a long but finite deadline, no
        retry (a replay could arrive twice). Through :meth:`_shard_op`: a
        barrier racing a promotion re-arrives on the promoted server (the
        dead one never counted the arrival)."""
        self._shard_op(0, lambda c: c.check(
            _BARRIER, retries=0, timeout_ms=int(flag("pserver_barrier_timeout_ms"))))

    def global_step(self, increment: int = 1) -> int:
        self._op_count("global_step")
        status, _ = self._shard_op(0, lambda c: c.check(_GLOBAL_STEP, n=increment))
        return status

    def stop_servers(self) -> None:
        """Ask every server to stop (a server already gone counts as
        stopped)."""
        for c in self._conns:
            try:
                c.call(_STOP, retries=0)
            except PsTransportError:
                pass

    # -- table-scale commands ----------------------------------------------

    def size(self, table_id) -> int:
        return sum(self._each_server(lambda c: c.check(_SIZE, table_id)[0]))

    def shrink(self, table_id) -> int:
        return sum(self._each_server(lambda c: c.check(_SHRINK, table_id,
                                                       timeout_ms=_long_ms(), retries=0)[0]))

    def spill(self, table_id: int, hot_budget: int) -> int:
        """Each server spills to at most ``hot_budget`` hot rows; returns
        the rows spilled."""
        return sum(self._each_server(lambda c: int(c.check(
            _SPILL, table_id, n=int(hot_budget), timeout_ms=_long_ms(), retries=0)[0])))

    def compact(self, table_id: int) -> int:
        return sum(self._each_server(lambda c: int(c.check(
            _COMPACT, table_id, timeout_ms=_long_ms())[0])))

    def table_stats(self, table_id: int) -> Dict[str, int]:
        def one(c):
            s3 = np.frombuffer(c.check(_STATS, table_id)[1], np.int64)
            return int(s3[0]), int(s3[1]), int(s3[2])

        stats = self._each_server(one)
        return {"hot_rows": sum(s[0] for s in stats), "cold_rows": sum(s[1] for s in stats),
                "disk_bytes": sum(s[2] for s in stats)}

    # -- high availability (ps/ha.py drives these) ---------------------------

    def digest(self, table_id: int) -> List[int]:
        """Per-server order-independent content digests (two replicas of a
        shard holding bit-identical rows digest equal)."""
        return self._each_server(lambda c: int(np.frombuffer(
            c.check(_DIGEST, table_id)[1], np.uint64)[0]))

    def digest_at(self, server: int, table_id: int, modulus: int = 0,
                  residue: int = 0) -> int:
        """One server's content digest, optionally over the keys with
        ``key % modulus == residue`` only. Server-targeted: no failover
        replay."""
        _, resp = self._direct(server, lambda c: c.check(
            _DIGEST, table_id, n=int(modulus), aux=int(residue), timeout_ms=_long_ms()))
        return int(np.frombuffer(resp, np.uint64)[0])

    def repl_state(self, server: int) -> Tuple[int, int, int, int]:
        """(applied_seq, epoch, oplog_seq, oplog_pending) of one server:
        enough for a cross-process replication drain (``ha.drain_remote``)."""
        _, resp = self._direct(server, lambda c: c.check(_REPL_STATE, n=-1))
        st = np.frombuffer(resp, np.int64)
        return int(st[0]), int(st[1]), int(st[2]), int(st[3])

    def dense_snapshot(self, table_id: int, server: int) -> bytes:
        """One server's dense-table state (values, optimizer moments, step):
        the rejoin snapshot's payload."""
        _, resp = self._direct(server, lambda c: c.check(_DENSE_SNAP, table_id,
                                                         timeout_ms=_long_ms()))
        return bytes(resp)

    def dense_restore(self, table_id: int, server: int, blob: bytes) -> None:
        self._direct(server, lambda c: c.check(_DENSE_RESTORE, table_id, payload=blob,
                                               timeout_ms=_long_ms()))

    # -- the live-reshard control surface (ps/reshard.py drives it) ----------

    def digest_routed(self, table_id: int) -> List[int]:
        """Per-server digests of each server's routed key class (``key %
        num_servers == s``), the companion of :meth:`snapshot_items`:
        mid-reshard a migrating class on two servers digests once. Equal to
        :meth:`digest` in steady state. An SSD table has no filtered digest
        (and cannot reshard), so it takes the plain one."""
        cfg = self._sparse_cfgs.get(table_id)
        if cfg is not None and cfg.storage == "ssd":
            return self.digest(table_id)
        n = self.num_servers
        return [self.digest_at(s, table_id, n, s) for s in range(n)]

    def retain(self, server: int, modulus: int, residue: int) -> int:
        """Install ``server``'s key-ownership predicate and, when ``0 <=
        residue < modulus``, drop every row outside it (kRetain; tapped, so
        the shard's backups converge). ``residue=-1`` fences the server out
        of the data plane (a retiring shard: every keyed op bounces until
        the stale client re-resolves). Returns the rows erased."""
        status, _ = self._direct(server, lambda c: c.check(
            _RETAIN, n=int(modulus), aux=int(residue), timeout_ms=_long_ms(), retries=0))
        return int(status)

    def ownership(self, server: int) -> Tuple[int, int]:
        """One server's (modulus, residue) ownership predicate; (0, 0) owns
        everything (the static topology)."""
        _, resp = self._direct(server, lambda c: c.check(_RETAIN, n=0))
        st = np.frombuffer(resp, np.int64)
        return int(st[0]), int(st[1])

    def server_epoch(self, server: int, set_to: Optional[int] = None) -> int:
        """Read (or set) one server's routing epoch (kEpoch): the failover
        coordinator and a grow's cutover fence a server this way before
        publishing the routing that names it."""
        status, _ = self._direct(server, lambda c: c.check(
            _EPOCH, n=-1 if set_to is None else int(set_to)))
        return int(status)

    # -- save/load ----------------------------------------------------------

    def _save_all_items(self, server: int, table_id: int, mode: int):
        full_dim = self._dims(table_id)[2]
        cnt, resp = self._shard_op(server, lambda c: c.check(
            _SAVE_ALL, table_id, aux=mode, timeout_ms=_long_ms(), retries=0))
        keys = np.frombuffer(resp[:cnt * 8], np.uint64)
        values = np.frombuffer(resp[cnt * 8:], np.float32).reshape(cnt, full_dim)
        return keys, values

    def snapshot_items(self, table_id, mode: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """(keys [n] u64, full rows [n, full_dim]) of every server's rows
        that pass the save filter of ``mode`` (after the accessor's
        update_stat_after_save), exported in one command a server. Each
        server's rows are filtered to the class the current routing gives
        it (``key % num_servers == s``): during a reshard's bootstrap a
        moving class lives on two servers, and the filter captures it once
        (in steady state it keeps every row)."""
        n = self.num_servers
        parts = self._fanout([lambda s=s: self._save_all_items(s, table_id, mode)
                              for s in range(n)])
        routed = []
        for s, (k, v) in enumerate(parts):
            own = (k % np.uint64(n)).astype(np.int64) == s
            routed.append((k, v) if own.all() else (k[own], v[own]))
        return (np.concatenate([k for k, _ in routed]),
                np.concatenate([v for _, v in routed]))

    def _meta(self, table_id: int, mode: int, converter=None) -> dict:
        cfg = self._sparse_cfgs[table_id]
        return {"shard_num": self.num_servers,
                "embedx_dim": (cfg.accessor_config or AccessorConfig()).embedx_dim,
                "accessor": cfg.accessor, "mode": mode, "converter": converter}

    def save(self, table_id, dirname, mode=0):
        """One text file per server in the accessor's format
        (``part-NNNNN.shard``) and ``meta.json``: the files of
        ``MemorySparseTable.save``, so checkpoints cross between the local
        and the RPC tables (and the packages). Returns the rows written."""
        os.makedirs(dirname, exist_ok=True)
        cfg = self._sparse_cfgs[table_id]
        acc = make_accessor(cfg.accessor, cfg.accessor_config)
        total = 0
        for s in range(self.num_servers):
            keys, values = self._save_all_items(s, table_id, mode)
            with open(os.path.join(dirname, f"part-{s:05d}.shard"), "w") as f:
                for j in range(len(keys)):
                    f.write(acc.format_row(keys[j], values[j]) + "\n")
            total += len(keys)
        with open(os.path.join(dirname, "meta.json"), "w") as f:
            json.dump(self._meta(table_id, mode), f)
        return total

    def load(self, table_id, dirname):
        """Load a :meth:`save` (or ``MemorySparseTable.save``) directory,
        re-routing rows by this client's server count. Returns the rows."""
        with open(os.path.join(dirname, "meta.json")) as f:
            meta = json.load(f)
        cfg = self._sparse_cfgs[table_id]
        acc = make_accessor(cfg.accessor, cfg.accessor_config)
        full_dim = self._dims(table_id)[2]
        enforce(meta["embedx_dim"] == acc.config.embedx_dim,
                f"embedx_dim mismatch: file {meta['embedx_dim']} != table "
                f"{acc.config.embedx_dim}")
        suffix, _, open_r = converter_entry(meta.get("converter"))
        total = 0
        for s in range(meta["shard_num"]):
            path = os.path.join(dirname, f"part-{s:05d}.shard{suffix}")
            if not os.path.exists(path):
                continue
            keys, rows = [], []
            with open_r(path) as f:
                for line in f:
                    parts = line.split()
                    if parts:
                        k, row = acc.parse_row(parts, full_dim)
                        keys.append(k)
                        rows.append(row)
            if keys:
                self.import_full(table_id, np.asarray(keys, np.uint64), np.stack(rows))
                total += len(keys)
        return total

    def save_local(self, table_id, dirname, mode: int = 0,
                   converter: Optional[str] = None) -> int:
        """Server-side save: each server streams its rows straight to
        ``dirname/part-NNNNN.shard[.gz|.bin]`` (the servers must reach
        ``dirname``); nothing crosses the wire. Converters: None (text),
        "gzip", "raw" (fixed binary records). Returns the rows saved."""
        enforce(converter in _SAVE_FORMATS,
                f"server-side save supports converter None|'gzip'|'raw', got {converter!r}")
        fmt, suffix = _SAVE_FORMATS[converter]
        os.makedirs(dirname, exist_ok=True)
        total = sum(self._fanout([
            self._task(s, lambda c, path=os.path.join(dirname, f"part-{s:05d}.shard{suffix}"):
                       int(c.check(_SAVE_FILE, table_id, aux=int(mode) | (fmt << 8),
                                   payload=path.encode(), timeout_ms=0, retries=0)[0]))
            for s in range(self.num_servers)]))
        with open(os.path.join(dirname, "meta.json"), "w") as f:
            json.dump(self._meta(table_id, mode, converter), f)
        return total

    def load_local(self, table_id, dirname) -> int:
        """Server-side load of a :meth:`save_local` directory; needs the
        server count it was saved with (use :meth:`load` to re-route)."""
        with open(os.path.join(dirname, "meta.json")) as f:
            meta = json.load(f)
        enforce(meta["shard_num"] == self.num_servers,
                f"save_local checkpoint has {meta['shard_num']} shards but "
                f"{self.num_servers} servers are up; use load() to re-route client-side")
        conv = meta.get("converter")
        enforce(conv in _SAVE_FORMATS, f"unknown save_local converter {conv!r}")
        fmt, suffix = _SAVE_FORMATS[conv]
        tasks = []
        for s in range(self.num_servers):
            path = os.path.join(dirname, f"part-{s:05d}.shard{suffix}")
            if os.path.exists(path):
                tasks.append(self._task(s, lambda c, path=path: int(c.check(
                    _LOAD_FILE, table_id, aux=fmt << 8, payload=path.encode(), timeout_ms=0,
                    retries=0)[0])))
        return sum(self._fanout(tasks))


class RemoteSparseTable:
    """Table-shaped view over sparse table ``table_id`` on the servers of
    ``client``: the accessor metadata and the pull/push/full-row surface
    the hot tier and the stream trainer consume. Build it after
    ``client.create_sparse_table(table_id, config)`` with the same
    config."""

    def __init__(self, client: RpcPsClient, table_id: int, config: TableConfig) -> None:
        self._client = client
        self._table_id = int(table_id)
        self.config = config
        self.accessor = make_accessor(config.accessor, config.accessor_config)

    def pull_sparse(self, keys, slots=None, create=True):
        return self._client.pull_sparse(self._table_id, keys, create=create, slots=slots)

    def push_sparse(self, keys, push_values):
        self._client.push_sparse(self._table_id, keys, push_values)

    def export_full(self, keys, create=False, slots=None):
        return self._client.export_full(self._table_id, keys, create=create, slots=slots)

    def import_full(self, keys, values):
        self._client.import_full(self._table_id, keys, values)

    def size(self) -> int:
        return self._client.size(self._table_id)

    def shrink(self) -> int:
        return self._client.shrink(self._table_id)

    def save(self, dirname: str, mode: int = 0) -> int:
        return self._client.save(self._table_id, dirname, mode=mode)

    def load(self, dirname: str) -> int:
        return self._client.load(self._table_id, dirname)

    def load_cold(self, keys, values) -> int:
        return self._client.load_cold(self._table_id, keys, values)

    def save_local(self, dirname: str, mode: int = 0, converter: Optional[str] = None) -> int:
        return self._client.save_local(self._table_id, dirname, mode=mode, converter=converter)

    def load_local(self, dirname: str) -> int:
        return self._client.load_local(self._table_id, dirname)

    def snapshot_items(self, mode: int = 0):
        return self._client.snapshot_items(self._table_id, mode=mode)

    def refresh_routing(self) -> bool:
        """Re-resolve the client's shard topology. A capture only reads
        (kSaveAll and kDigest are not fenced), so without this a capture
        after a grow would read the old server set and miss every moved
        row; the job-checkpoint manager calls it under its gate."""
        return self._client.refresh_routing()

    def spill(self, hot_budget: int) -> int:
        return self._client.spill(self._table_id, hot_budget)

    def stats(self) -> Dict[str, int]:
        return self._client.table_stats(self._table_id)

    def digest(self) -> List[int]:
        """The routed per-server digests (:meth:`RpcPsClient.digest_routed`):
        the same row set :meth:`snapshot_items` exports, once per key class
        even mid-reshard; the plain digests in steady state."""
        return self._client.digest_routed(self._table_id)

    @property
    def full_dim(self) -> int:
        return self._client._dims(self._table_id)[2]
