"""Cross-process stage channels for the heterogeneous pipeline.

Port of ``paddle_tpu.parallel.heter_channel``: the Python face of
``csrc/tensor_channel.cc`` (the port's own copy, built into the host
library, ``ps.native``), the SendAndRecv transport between a CPU-stage
process and a device-stage process (the reference's heter_client.h:83,
heter_server.h, sendrecv.proto:133-137). Items are dicts of arrays
(micro-batch variables); the frame is the JAX package's self-describing
tensor framing, byte for byte (``_encode``/``_decode``: no pickle), so a
frame from either package's client decodes in the other's server.
Backpressure is the server's bounded frame queue plus TCP flow control.

Tensors cross as numpy: ``send`` takes numpy arrays or torch tensors
(copied to the host), and ``recv``/``channel_source`` give numpy arrays
(views into one arena-backed frame buffer), or torch tensors on the
``device`` the caller names.

Usage (two processes)::

    # device-stage process
    srv = ChannelServer(port=7010, capacity=8)
    for item in channel_source(srv, device="cuda"):   # blocks, yields dicts
        ...train...

    # cpu-stage process
    cli = ChannelClient("127.0.0.1", 7010)
    cli.send({"ids": ids, "label": y})
    cli.send_stop()                                   # one per consumer loop
"""

from __future__ import annotations

import ctypes
import struct
import time
from typing import Any, Dict, Iterator, Optional, Union

import numpy as np
import torch

from ..core.enforce import PreconditionNotMetError, enforce
from ..ps.native import load_native

__all__ = ["ChannelServer", "ChannelClient", "channel_source", "STOP"]

STOP = "__heter_channel_stop__"
_MAGIC = b"PTCH"


def _configure(lib: ctypes.CDLL) -> None:
    lib.tch_listen.restype = ctypes.c_void_p
    lib.tch_listen.argtypes = [ctypes.c_int, ctypes.c_int64]
    lib.tch_port.restype = ctypes.c_int
    lib.tch_port.argtypes = [ctypes.c_void_p]
    lib.tch_recv.restype = ctypes.c_int
    lib.tch_recv.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tch_frame_len.restype = ctypes.c_int64
    lib.tch_frame_len.argtypes = [ctypes.c_void_p]
    lib.tch_frame_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.tch_server_close.argtypes = [ctypes.c_void_p]
    lib.tch_server_destroy.argtypes = [ctypes.c_void_p]
    lib.tch_connect.restype = ctypes.c_void_p
    lib.tch_connect.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.tch_send.restype = ctypes.c_int
    lib.tch_send.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.tch_conn_close.argtypes = [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = load_native()   # raises when the host library does not build
    if not getattr(lib, "_tch_configured", False):
        _configure(lib)
        lib._tch_configured = True
    return lib


def _encode(item: Dict[str, Any]) -> bytes:
    """Frame: magic, count, then per entry: name, dtype, shape, raw data.
    A STOP sentinel is the frame b'PTCHSTOP'."""
    if item is STOP:
        return _MAGIC + b"STOP"
    enforce(isinstance(item, dict), "channel items are dicts of arrays")
    parts = [_MAGIC, struct.pack("<I", len(item))]
    for name, val in item.items():
        if isinstance(val, torch.Tensor):
            val = val.detach().cpu().numpy()
        arr = np.asarray(val)  # tobytes() below emits C-order bytes for
        # any layout (and ascontiguousarray would promote 0-d to 1-d)
        nb = name.encode()
        db = arr.dtype.str.encode()
        parts.append(struct.pack("<HH B", len(nb), len(db), arr.ndim))
        parts.append(nb)
        parts.append(db)
        parts.append(struct.pack(f"<{arr.ndim}q", *arr.shape))
        parts.append(arr.tobytes())
    return b"".join(parts)


def _decode(frame):
    """frame: bytes-like (np.uint8 array on the recv hot path — arrays are
    aligned VIEWS into it, zero-copy; the backing buffer keeps them alive)."""
    buf = frame if isinstance(frame, (bytes, bytearray, memoryview)) \
        else memoryview(frame)
    enforce(bytes(buf[:4]) == _MAGIC, "bad channel frame")
    if len(buf) == 8 and bytes(buf[4:8]) == b"STOP":
        return STOP
    (count,) = struct.unpack_from("<I", buf, 4)
    off = 8
    out: Dict[str, np.ndarray] = {}
    for _ in range(count):
        nlen, dlen, ndim = struct.unpack_from("<HH B", buf, off)
        off += struct.calcsize("<HH B")
        name = bytes(buf[off:off + nlen]).decode(); off += nlen
        dtype = np.dtype(bytes(buf[off:off + dlen]).decode()); off += dlen
        shape = struct.unpack_from(f"<{ndim}q", buf, off)
        off += 8 * ndim
        n_elem = int(np.prod(shape)) if ndim else 1
        arr = np.frombuffer(buf, dtype=np.uint8, count=n_elem * dtype.itemsize,
                            offset=off).view(dtype).reshape(shape)
        out[name] = arr
        off += n_elem * dtype.itemsize
    return out


class ChannelServer:
    """Receiving end of a stage boundary (heter_server.h role)."""

    def __init__(self, port: int = 0, capacity: int = 8) -> None:
        self._lib = _lib()
        self._h = self._lib.tch_listen(port, capacity)
        enforce(self._h, f"failed to listen on port {port}")
        self.port = int(self._lib.tch_port(self._h))

    def recv(self, timeout: Optional[float] = None,
             device: Optional[Union[str, torch.device]] = None):
        """Next item or STOP; raises TimeoutError. The item is a dict of
        numpy arrays, or of torch tensors on ``device`` when one is named."""
        ms = -1 if timeout is None else int(timeout * 1000)
        rc = int(self._lib.tch_recv(self._h, ms))
        if rc == -1:
            raise TimeoutError("channel recv timeout")
        if rc == -2:
            return STOP
        from ..core.allocator import arena_ndarray

        n = int(self._lib.tch_frame_len(self._h))
        # arena-backed frame buffer (allocator facade): recycled when the
        # consumer drops the decoded batch; single copy out of the queue
        buf = arena_ndarray((n,), np.uint8)
        self._lib.tch_frame_copy(self._h, buf.ctypes.data_as(ctypes.c_void_p))
        item = _decode(buf)  # decoded arrays are views into buf
        if device is None or item is STOP:
            return item
        return {k: torch.from_numpy(np.array(v)).to(device) for k, v in item.items()}

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.tch_server_close(self._h)
            self._lib.tch_server_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class ChannelClient:
    """Sending end (heter_client.h SendAndRecv's send leg). Retries the
    connect while the peer stage is still starting."""

    def __init__(self, host: str, port: int, connect_timeout: float = 60.0) -> None:
        self._lib = _lib()
        deadline = time.perf_counter() + connect_timeout
        self._h = None
        while True:
            self._h = self._lib.tch_connect(host.encode(), port)
            if self._h:
                break
            if time.perf_counter() > deadline:
                raise PreconditionNotMetError(
                    f"cannot connect channel to {host}:{port}")
            time.sleep(0.2)

    def send(self, item) -> None:
        frame = _encode(item)
        rc = int(self._lib.tch_send(self._h, frame, len(frame)))
        enforce(rc == 0, "channel send failed (peer closed?)")

    def send_stop(self) -> None:
        self.send(STOP)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.tch_conn_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def channel_source(server: ChannelServer, timeout: Optional[float] = None,
                   device: Optional[Union[str, torch.device]] = None) -> Iterator[Dict[str, Any]]:
    """Iterate a server's stream until a STOP sentinel (feed this to
    HeterPipelineTrainer.run as the downstream process's source); items as
    :meth:`ChannelServer.recv` gives them."""
    while True:
        item = server.recv(timeout, device)
        if item is STOP:
            return
        yield item
