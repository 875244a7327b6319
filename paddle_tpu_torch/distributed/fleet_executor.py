"""Fleet executor: the actor-model pipeline runtime
(reference ``paddle/fluid/distributed/fleet_executor/``).

The port's own copy of ``paddle_tpu.distributed.fleet_executor``.
``FleetExecutor`` (fleet_executor.h:35) builds a ``Carrier``
(carrier.h:49) holding ``Interceptor`` actors: Source, Compute
(compute_interceptor.h:24), Amplifier and Sink, which exchange
credit-based control messages (``interceptor_message.proto``:
DATA_IS_READY / DATA_IS_USELESS / START / STOP) over an in-process queue
or, across processes, a :class:`RemoteMessageBus`.

It runs host-side staged execution: CPU stages that prepare batches
feeding a step on the card, heter pipelines, and bounded buffers between
asynchronous stages. A ``ComputeInterceptor``'s ``fn`` is any callable,
usually a torch step on the card; the credits bound the micro-batches in
flight on each edge as the reference's up/down buffer accounting does
(compute_interceptor.cc). Each credited interceptor records
``peak_in_flight``, the most micro-batches it had outstanding on each
downstream edge, so a run can show the bound held.

Cross-process: :class:`RemoteMessageBus` carries the same message schema
over framed TCP (the brpc ``MessageBus``, message_bus.cc); interceptors
are placed on ranks with ``Carrier(local_ids=...)``, and the credit
returns travel the reverse path. A payload is pickled as it stands, so a
tensor lands on the receiving side on the device it was pickled from:
send CPU tensors across and let the receiving interceptor's ``fn`` move
them to its device.

Security: frames are pickled Python objects. Listener ports must be
internal to the job. Pass ``secret=`` to :class:`RemoteMessageBus` to
require an HMAC-SHA256 tag on every frame; a frame with a missing or
wrong tag is dropped before unpickling and its connection closed.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import hmac
import logging
import pickle
import queue
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core.enforce import InvalidArgumentError, PreconditionNotMetError, enforce

logger = logging.getLogger(__name__)

__all__ = [
    "MessageType",
    "InterceptorMessage",
    "MessageBus",
    "RemoteMessageBus",
    "TaskNode",
    "Interceptor",
    "ComputeInterceptor",
    "SourceInterceptor",
    "SinkInterceptor",
    "AmplifierInterceptor",
    "Carrier",
    "FleetExecutor",
]


class MessageType(enum.Enum):
    # interceptor_message.proto values
    STOP = 0
    DATA_IS_READY = 1
    DATA_IS_USELESS = 2
    START = 3


@dataclasses.dataclass
class InterceptorMessage:
    src_id: int
    dst_id: int
    type: MessageType
    payload: Any = None  # data rides the edge queues in the reference
    # (scopes are shared); here the message carries the microbatch


class MessageBus:
    """In-process message routing (message_bus.cc without brpc): one
    inbox per interceptor id."""

    def __init__(self) -> None:
        self._inboxes: Dict[int, "queue.Queue[InterceptorMessage]"] = {}

    def register(self, interceptor_id: int) -> "queue.Queue[InterceptorMessage]":
        enforce(interceptor_id not in self._inboxes,
                f"interceptor {interceptor_id} already registered")
        q: "queue.Queue[InterceptorMessage]" = queue.Queue()
        self._inboxes[interceptor_id] = q
        return q

    def send(self, msg: InterceptorMessage) -> None:
        inbox = self._inboxes.get(msg.dst_id)
        if inbox is None:
            raise InvalidArgumentError(f"unknown interceptor id {msg.dst_id}")
        inbox.put(msg)

    def send_best_effort(self, msg: InterceptorMessage) -> None:
        """Fire-and-forget delivery for control broadcasts (STOP): never
        raises, never waits on a down peer (RemoteMessageBus overrides
        with a short one-shot connect instead of the retry loop)."""
        try:
            self.send(msg)
        except (InvalidArgumentError, OSError):
            pass


class RemoteMessageBus(MessageBus):
    """Cross-rank interceptor message bus — the brpc ``MessageBus``
    (message_bus.cc) role on a framed-TCP channel (4-byte length prefix
    + pickled InterceptorMessage; the sibling of ps/rpc.py's framing).

    ``rank_addrs``: {rank: (host, port)} — this rank LISTENS on its own
    entry; ``interceptor_ranks``: {task_id: rank} placement map. A send
    whose destination lives on another rank rides a persistent client
    socket to that rank's listener, which injects it into the local
    inbox — interceptor code is identical either way, and the
    DATA_IS_USELESS credit returns travel the reverse path, so the
    buffer_size windows throttle ACROSS processes exactly as they do
    in-process.

    ``secret`` (recommended): a job-shared key. Each frame then carries
    an HMAC-SHA256 tag over the body, verified with a constant-time
    compare BEFORE ``pickle.loads`` — an unauthenticated connection
    (pickle is code execution) gets its frames dropped and the
    connection closed. Without a secret the bus trusts the network;
    deploy only on cluster-internal/firewalled ports (see module
    docstring)."""

    _FRAME = struct.Struct("<I")
    _MAX_FRAME = 1 << 30
    _TAG_LEN = hashlib.sha256().digest_size

    def __init__(self, rank: int, rank_addrs: Dict[int, Tuple[str, int]],
                 interceptor_ranks: Dict[int, int],
                 connect_timeout: float = 30.0,
                 secret: Optional[bytes] = None,
                 register_grace: float = 10.0) -> None:
        super().__init__()
        self.rank = int(rank)
        self._addrs = dict(rank_addrs)
        self._placement = dict(interceptor_ranks)
        self._connect_timeout = float(connect_timeout)
        self._secret = bytes(secret) if secret is not None else None
        self._register_grace = float(register_grace)
        self.last_error: Optional[str] = None
        self._peers: Dict[int, socket.socket] = {}
        self._send_locks: Dict[int, threading.Lock] = {}
        self._peer_lock = threading.Lock()  # guards the two maps only
        self._closing = False
        host, port = self._addrs[self.rank]
        self._listener = socket.create_server((host, port), backlog=8,
                                              reuse_port=False)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"msgbus-accept-{rank}")
        self._accept_thread.start()

    # -- wire helpers -----------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True,
                             name=f"msgbus-conn-{self.rank}").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            with conn:
                while True:
                    hdr = self._recv_exact(conn, self._FRAME.size)
                    if hdr is None:
                        return
                    (n,) = self._FRAME.unpack(hdr)
                    enforce(n <= self._MAX_FRAME,
                            f"message frame too large: {n}")
                    body = self._recv_exact(conn, n)
                    if body is None:
                        return
                    if self._secret is not None:
                        if len(body) < self._TAG_LEN:
                            logger.error("msgbus rank %d: short frame from "
                                         "%s, closing", self.rank,
                                         conn.getpeername())
                            return
                        tag, body = body[:self._TAG_LEN], body[self._TAG_LEN:]
                        want = hmac.new(self._secret, body,
                                        hashlib.sha256).digest()
                        if not hmac.compare_digest(tag, want):
                            logger.error("msgbus rank %d: bad HMAC from %s, "
                                         "closing connection (frame dropped "
                                         "before deserialization)",
                                         self.rank, conn.getpeername())
                            return
                    if not self._deliver(pickle.loads(body)):
                        return  # routing failure already logged; close so
                        # the sender sees a reset instead of a black hole
        except (OSError, pickle.UnpicklingError):
            if not self._closing:
                raise

    def _deliver(self, msg: InterceptorMessage,
                 register_timeout: Optional[float] = None) -> bool:
        """Local delivery with a registration grace window: a peer's
        first DATA_IS_READY can arrive between this rank's bus
        construction (listener up) and its Carrier registering inboxes
        — a startup race, not an error. Bounded retry; on expiry the
        drop is LOGGED and recorded on the bus (``last_error``) and
        False is returned so the caller closes the connection — a
        raise here would die unseen in the daemon receive thread and
        surface only as a remote-side timeout."""
        if register_timeout is None:
            register_timeout = self._register_grace
        deadline = time.monotonic() + register_timeout
        wait = 0.002
        while True:
            try:
                MessageBus.send(self, msg)
                return True
            except InvalidArgumentError:
                if self._closing:
                    return True  # late message during shutdown: drop
                if time.monotonic() > deadline:
                    err = (f"msgbus rank {self.rank}: no interceptor "
                           f"{msg.dst_id} registered after "
                           f"{register_timeout}s grace — dropping "
                           f"{msg.type.name} from {msg.src_id} and closing "
                           f"the connection")
                    logger.error(err)
                    self.last_error = err
                    return False
                time.sleep(wait)
                wait = min(wait * 2, 0.05)  # registration races resolve fast

    @staticmethod
    def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def _peer(self, rank: int) -> socket.socket:
        # connect OUTSIDE the map lock: a slow/absent peer must not
        # stall sends to healthy peers or close() for connect_timeout.
        # A racing duplicate connect publishes one socket, closes the
        # loser.
        with self._peer_lock:
            sock = self._peers.get(rank)
        if sock is not None:
            return sock
        host, port = self._addrs[rank]
        deadline = time.monotonic() + self._connect_timeout
        wait = 0.02
        while True:  # the peer's listener may not be up yet
            try:
                sock = socket.create_connection((host, port), timeout=5.0)
                break
            except OSError:
                if self._closing or time.monotonic() > deadline:
                    raise
                time.sleep(wait)
                wait = min(wait * 2, 1.0)  # all ranks dial rank 0 at once
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._peer_lock:
            existing = self._peers.get(rank)
            if existing is not None:
                sock.close()
                return existing
            self._peers[rank] = sock
            self._send_locks[rank] = threading.Lock()
            return sock

    # -- MessageBus surface ----------------------------------------------

    def _frame_bytes(self, msg: InterceptorMessage) -> bytes:
        """Serialize + (optionally) sign + length-prefix one message —
        the single definition of the wire format for BOTH send paths."""
        body = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        if self._secret is not None:
            body = hmac.new(self._secret, body, hashlib.sha256).digest() + body
        return self._FRAME.pack(len(body)) + body

    def send(self, msg: InterceptorMessage) -> None:
        dst_rank = self._placement.get(msg.dst_id, self.rank)
        if dst_rank == self.rank:
            MessageBus.send(self, msg)
            return
        frame = self._frame_bytes(msg)
        try:
            sock = self._peer(dst_rank)
            with self._send_locks[dst_rank]:  # frame-interleave guard
                sock.sendall(frame)
        except OSError:
            if not self._closing:
                raise

    def send_best_effort(self, msg: InterceptorMessage) -> None:
        """STOP-broadcast path: cached socket, else up to 3 bounded
        one-shot 2s connects — no connect_timeout retry loop, so
        Carrier.stop over N down peers costs seconds, not minutes,
        while STOP (completion-critical for sinkless ranks) still
        survives a transient connect failure."""
        dst_rank = self._placement.get(msg.dst_id, self.rank)
        if dst_rank == self.rank:
            MessageBus.send_best_effort(self, msg)
            return
        frame = self._frame_bytes(msg)
        try:
            with self._peer_lock:
                sock = self._peers.get(dst_rank)
            if sock is not None:
                with self._send_locks[dst_rank]:
                    sock.sendall(frame)
                return
            host, port = self._addrs[dst_rank]
            for attempt in range(3):
                try:
                    with socket.create_connection((host, port),
                                                  timeout=2.0) as s:
                        s.sendall(frame)
                    return
                except OSError:
                    if attempt == 2:
                        raise
                    time.sleep(0.1 * 2 ** attempt)
        except OSError:
            pass  # peer down: best-effort by contract

    def close(self) -> None:
        self._closing = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._peer_lock:
            for sock in self._peers.values():
                try:
                    sock.close()
                except OSError:
                    pass
            self._peers.clear()


@dataclasses.dataclass
class TaskNode:
    """Reference ``TaskNode`` (task_node.h): one pipeline stage.
    ``buffer_size`` per downstream edge = the credit window (max
    microbatches in flight on that edge)."""

    task_id: int
    fn: Optional[Callable[[Any], Any]] = None
    role: str = "compute"            # source | compute | sink | amplifier
    max_run_times: int = 1           # microbatch count
    upstreams: List[int] = dataclasses.field(default_factory=list)
    downstreams: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    # (dst_task_id, buffer_size)
    period: int = 1                  # amplifier window (run_per_steps)


class Interceptor(threading.Thread):
    """Actor base: drains its inbox, dispatching on message type
    (interceptor.h Handle). Runs as a daemon thread until STOP."""

    def __init__(self, node: TaskNode, bus: MessageBus) -> None:
        super().__init__(daemon=True, name=f"interceptor-{node.task_id}")
        self.node = node
        self.bus = bus
        self.inbox = bus.register(node.task_id)
        self.error: Optional[BaseException] = None

    def send(self, dst: int, mtype: MessageType, payload: Any = None) -> None:
        self.bus.send(InterceptorMessage(self.node.task_id, dst, mtype, payload))

    def run(self) -> None:
        try:
            while True:
                msg = self.inbox.get()
                if msg.type is MessageType.STOP:
                    break
                self.handle(msg)
        except BaseException as e:  # surfaced by Carrier.wait
            self.error = e

    def handle(self, msg: InterceptorMessage) -> None:
        raise NotImplementedError

    def _take_credit(self, dst: int) -> None:
        """Spend one credit on the edge to ``dst`` and record the edge's
        in-flight count (its buffer size less the credits left)."""
        self._credits[dst] -= 1
        window = dict(self.node.downstreams)[dst]
        self.peak_in_flight[dst] = max(self.peak_in_flight[dst],
                                       window - self._credits[dst])


class ComputeInterceptor(Interceptor):
    """compute_interceptor.cc semantics: run when every upstream has a
    ready microbatch AND every downstream has credit; after running,
    return DATA_IS_USELESS upstream (freeing their credit) and send
    DATA_IS_READY + the result downstream."""

    def __init__(self, node: TaskNode, bus: MessageBus) -> None:
        super().__init__(node, bus)
        self._ready: Dict[int, "queue.Queue[Any]"] = {
            u: queue.Queue() for u in node.upstreams}
        self._credits: Dict[int, int] = {d: b for d, b in node.downstreams}
        self.peak_in_flight: Dict[int, int] = {d: 0 for d, _ in node.downstreams}
        self._run_times = 0

    def handle(self, msg: InterceptorMessage) -> None:
        if msg.type is MessageType.DATA_IS_READY:
            self._ready[msg.src_id].put(msg.payload)
        elif msg.type is MessageType.DATA_IS_USELESS:
            self._credits[msg.src_id] += 1
        self._try_run()

    def _can_run(self) -> bool:
        if self._run_times >= self.node.max_run_times:
            return False
        if any(q.empty() for q in self._ready.values()):
            return False
        return all(c > 0 for c in self._credits.values())

    def _try_run(self) -> None:
        while self._can_run():
            args = [self._ready[u].get() for u in self.node.upstreams]
            out = self.node.fn(*args) if self.node.fn else (
                args[0] if len(args) == 1 else tuple(args))
            for u in self.node.upstreams:
                self.send(u, MessageType.DATA_IS_USELESS)
            for d, _ in self.node.downstreams:
                self._take_credit(d)
                self.send(d, MessageType.DATA_IS_READY, out)
            self._run_times += 1


class SourceInterceptor(Interceptor):
    """source_interceptor.cc: feeds ``max_run_times`` microbatches
    downstream, respecting credit."""

    def __init__(self, node: TaskNode, bus: MessageBus,
                 feed: Optional[Sequence[Any]] = None) -> None:
        super().__init__(node, bus)
        self._credits: Dict[int, int] = {d: b for d, b in node.downstreams}
        self.peak_in_flight: Dict[int, int] = {d: 0 for d, _ in node.downstreams}
        self._feed = list(feed) if feed is not None else None
        self._sent = 0

    def handle(self, msg: InterceptorMessage) -> None:
        if msg.type is MessageType.DATA_IS_USELESS:
            self._credits[msg.src_id] += 1
        elif msg.type is MessageType.START:
            pass
        self._try_send()

    def _try_send(self) -> None:
        while (self._sent < self.node.max_run_times
               and all(c > 0 for c in self._credits.values())):
            item = (self._feed[self._sent]
                    if self._feed is not None else self._sent)
            if self.node.fn is not None:
                item = self.node.fn(item)
            for d, _ in self.node.downstreams:
                self._take_credit(d)
                self.send(d, MessageType.DATA_IS_READY, item)
            self._sent += 1


class SinkInterceptor(Interceptor):
    """sink_interceptor.cc: consumes microbatches; signals completion
    when ``max_run_times`` have arrived."""

    def __init__(self, node: TaskNode, bus: MessageBus) -> None:
        super().__init__(node, bus)
        self.outputs: List[Any] = []
        self.done = threading.Event()

    def handle(self, msg: InterceptorMessage) -> None:
        if msg.type is MessageType.DATA_IS_READY:
            out = msg.payload
            if self.node.fn is not None:
                out = self.node.fn(out)
            self.outputs.append(out)
            self.send(msg.src_id, MessageType.DATA_IS_USELESS)
            if len(self.outputs) >= self.node.max_run_times:
                self.done.set()


class AmplifierInterceptor(ComputeInterceptor):
    """amplifier_interceptor.cc: run-at-offset / period semantics used
    for gradient-accumulation boundaries — consumes ``period`` inputs
    per downstream emission (fn receives the list)."""

    def __init__(self, node: TaskNode, bus: MessageBus, period: int = 1) -> None:
        super().__init__(node, bus)
        self.period = int(period)
        enforce(self.period >= 1, f"amplifier period must be >= 1, got {period}")
        enforce(node.max_run_times % self.period == 0,
                f"amplifier max_run_times ({node.max_run_times}) must be a "
                f"multiple of period ({period}) — a partial window would "
                f"never flush")
        self._window: List[Any] = []

    def _try_run(self) -> None:
        while True:
            if len(self._window) >= self.period:
                # a full window flushes only when every downstream has
                # credit; otherwise resume on the next DATA_IS_USELESS
                if not all(c > 0 for c in self._credits.values()):
                    return
                out = (self.node.fn(list(self._window))
                       if self.node.fn else list(self._window))
                self._window.clear()
                for d, _ in self.node.downstreams:
                    self._take_credit(d)
                    self.send(d, MessageType.DATA_IS_READY, out)
                continue
            if (self._run_times >= self.node.max_run_times
                    or any(q.empty() for q in self._ready.values())):
                return
            args = [self._ready[u].get() for u in self.node.upstreams]
            for u in self.node.upstreams:
                self.send(u, MessageType.DATA_IS_USELESS)
            self._window.append(args[0] if len(args) == 1 else tuple(args))
            self._run_times += 1


class Carrier:
    """carrier.h:49: owns the interceptors of one rank, starts them,
    releases the sources, and joins on the sinks.

    Multi-rank (the reference's Carrier + brpc MessageBus split): pass a
    :class:`RemoteMessageBus` and ``local_ids`` — only the local nodes'
    interceptors are constructed, but the FULL topology is known so the
    completion STOP broadcast reaches every rank. A rank with no local
    sink (e.g. the source rank) completes when the sink rank's broadcast
    STOP drains its interceptors."""

    def __init__(self, nodes: Sequence[TaskNode],
                 feeds: Optional[Dict[int, Sequence[Any]]] = None,
                 bus: Optional[MessageBus] = None,
                 local_ids: Optional[Sequence[int]] = None) -> None:
        self.bus = bus if bus is not None else MessageBus()
        self.all_ids = [n.task_id for n in nodes]
        self.interceptors: Dict[int, Interceptor] = {}
        self.sinks: List[SinkInterceptor] = []
        self.sources: List[SourceInterceptor] = []
        feeds = feeds or {}
        local = set(local_ids) if local_ids is not None else None
        for node in nodes:
            if local is not None and node.task_id not in local:
                continue
            if node.role == "source":
                it: Interceptor = SourceInterceptor(node, self.bus,
                                                    feeds.get(node.task_id))
                self.sources.append(it)  # type: ignore[arg-type]
            elif node.role == "sink":
                it = SinkInterceptor(node, self.bus)
                self.sinks.append(it)  # type: ignore[arg-type]
            elif node.role == "amplifier":
                it = AmplifierInterceptor(node, self.bus, period=node.period)
            else:
                it = ComputeInterceptor(node, self.bus)
            self.interceptors[node.task_id] = it

    def start(self) -> None:
        for it in self.interceptors.values():
            it.start()
        for src in self.sources:
            self.bus.send(InterceptorMessage(-1, src.node.task_id,
                                             MessageType.START))

    def wait(self, timeout: float = 60.0) -> None:
        deadline = time.monotonic() + timeout

        def check_errors():
            for it in self.interceptors.values():
                if it.error is not None:
                    self.stop()
                    raise it.error

        # poll so a stage exception surfaces promptly instead of
        # masquerading as a timeout after the full wait
        for sink in self.sinks:
            while not sink.done.wait(0.05):
                check_errors()
                if time.monotonic() > deadline:
                    self.stop()
                    raise PreconditionNotMetError(
                        f"fleet executor timed out waiting for sink "
                        f"{sink.node.task_id}")
        if not self.sinks:
            # sink lives on another rank: done when its Carrier's STOP
            # broadcast (routed by the RemoteMessageBus) drains us
            for it in self.interceptors.values():
                while it.is_alive():
                    it.join(timeout=0.05)
                    check_errors()
                    if time.monotonic() > deadline:
                        self.stop()
                        raise PreconditionNotMetError(
                            "fleet executor timed out waiting for remote "
                            f"completion of interceptor {it.node.task_id}")
            # a thread that ERRORED and exited also fails is_alive() —
            # the final check keeps a dead pipeline from reporting clean
            check_errors()
            return
        self.stop()
        for it in self.interceptors.values():
            if it.error is not None:
                raise it.error

    def stop(self) -> None:
        # broadcast STOP over the FULL topology — cross-rank ids ride
        # the remote bus; best-effort with a one-shot connect so N down
        # peers cost at most ~2s each, not connect_timeout each
        for task_id in self.all_ids:
            self.bus.send_best_effort(InterceptorMessage(-1, task_id,
                                                         MessageType.STOP))
        for it in self.interceptors.values():
            if it.ident is None:
                continue  # never started (stop before start is legal)
            it.join(timeout=5.0)


class FleetExecutor:
    """fleet_executor.h:35 surface: init with task nodes, ``run`` feeds
    microbatches through and returns the sink outputs in order."""

    def __init__(self, nodes: Sequence[TaskNode]) -> None:
        self.nodes = list(nodes)
        ids = [n.task_id for n in self.nodes]
        enforce(len(ids) == len(set(ids)), "duplicate task ids")

    def run(self, feeds: Optional[Dict[int, Sequence[Any]]] = None,
            timeout: float = 60.0) -> Dict[int, List[Any]]:
        carrier = Carrier(self.nodes, feeds)
        carrier.start()
        carrier.wait(timeout)
        return {s.node.task_id: s.outputs for s in carrier.sinks}
