"""Device-resident graph table: neighbour sampling and random walks on
the card.

Port of ``paddle_tpu.ops.device_graph`` (the reference's GPU graph
mirror, ``fleet/heter_ps/graph_gpu_ps_table.h``, feeding
``GraphDataGenerator``'s deepwalk walks). The adjacency lives on the
device as a degree-capped padded neighbour matrix with a per-row weight
prefix-CDF and the kept degree; node ids map to rows through the same
per-pass cuckoo map the embedding cache uses (``ps.device_hash``). The
cap is explicit and counted (``capped_rows``), never silent.

- ``sample_neighbors(state, generator, hi, lo, k)``: k weighted draws
  with replacement over each node's kept neighbours, padded and masked;
- ``random_walk(state, generator, hi, lo, length)``: a loop of
  ``length`` single-draw steps; a walk that reaches a degree-0 or
  unknown node stays there (``live`` marks the live prefix).

Keys are uint64 split into 32-bit halves. The neighbour halves are kept
as int32 bit patterns (4 bytes a slot, the hot tier map's layout) and
widened with ``ps.device_hash._u32``; the halves a caller passes and gets
back are int64 tensors holding uint32 values, the form
``device_hash_lookup`` takes.

A draw inverts the row's CDF with the JAX package's formula: the slot is
the count of CDF entries below ``u · total``, clamped to ``max_deg − 1``
(:meth:`DeviceGraph._slot_of`), not ``torch.searchsorted``, whose ties
differ. Given the same uniforms the slots are the JAX package's. The
uniforms themselves come from the ``torch.Generator`` the caller passes
(one ``torch.rand`` a draw, a step of a walk at a time), so the streams
are not JAX's ``jax.random`` streams: a divergence in the values drawn,
not in the distribution.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.enforce import enforce
from ..ps.device_hash import DeviceKeyMap, _u32, device_hash_lookup, split_keys

__all__ = ["DeviceGraph"]

Device = Optional[Union[str, torch.device]]


def _bits32(a: np.ndarray) -> torch.Tensor:
    """uint32 host array → int32 tensor of the same bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


class DeviceGraph:
    """Padded-CSR device mirror of a host ``GraphTable``.

    ``state`` (tensors on the graph's device):
      nbr_hi/nbr_lo [N, max_deg] int32   neighbour key halves' bit patterns (padded 0)
      cdf           [N, max_deg] f32     per-row weight prefix-CDF (0 pad)
      deg           [N]          int32   KEPT degree (min(true, max_deg))
      map                                cuckoo node-key→row map (``DeviceKeyMap``)
    """

    def __init__(self, state: Dict[str, torch.Tensor], max_deg: int, capped_rows: int) -> None:
        self.state = state
        self.max_deg = int(max_deg)
        #: rows whose true degree exceeded max_deg (their kept neighbours
        #: are the first max_deg by insertion order), surfaced, never silent
        self.capped_rows = int(capped_rows)

    # -- build (host → device; the build_graph_from_cpu role) ------------

    @staticmethod
    def from_graph_table(graph, max_deg: int = 32, device: Device = None) -> "DeviceGraph":
        """Upload a host ``ps.graph_table.GraphTable`` (or anything with
        ``all_nodes`` and per-node neighbours/weights via ``_shard``)."""
        nodes = graph.all_nodes()
        nbrs = np.zeros((len(nodes), max_deg), np.uint64)
        w = np.zeros((len(nodes), max_deg), np.float32)
        deg = np.zeros(len(nodes), np.int32)
        for i, nid in enumerate(nodes):
            shard, lock = graph._shard(int(nid))
            with lock:
                cand = shard.neighbors.get(int(nid), [])
                ww = shard.weights.get(int(nid), [])
            deg[i] = len(cand)
            k = min(len(cand), max_deg)
            nbrs[i, :k] = np.asarray(cand[:k], np.uint64)
            w[i, :k] = np.asarray(ww[:k], np.float32)
        return DeviceGraph.from_arrays(np.asarray(nodes, np.uint64), nbrs, deg, w, device=device)

    @staticmethod
    def from_arrays(nodes: np.ndarray, nbrs: np.ndarray, deg: np.ndarray,
                    weights: Optional[np.ndarray] = None, device: Device = None) -> "DeviceGraph":
        """From host arrays: ``nodes`` [N] uint64, ``nbrs`` [N, max_deg]
        uint64 (padded), ``deg`` [N] true degrees, ``weights`` [N, max_deg]
        (None: 1 for each kept neighbour). ``device`` None means the card."""
        dev = resolve_device(device)
        n, max_deg = nbrs.shape
        enforce(len(nodes) == n and len(deg) == n, "shape mismatch")
        capped_rows = int((np.asarray(deg) > max_deg).sum())
        kept = np.minimum(deg, max_deg)
        if weights is None:
            weights = (np.arange(max_deg)[None, :] < kept[:, None]).astype(np.float32)
        w = np.where(np.arange(max_deg)[None, :] < kept[:, None], np.maximum(weights, 0.0), 0.0)
        cdf = np.cumsum(w, axis=1, dtype=np.float32)
        hi, lo = split_keys(nbrs.reshape(-1))
        key_map = DeviceKeyMap(DeviceKeyMap.build_host(np.asarray(nodes, np.uint64),
                                                       np.arange(n, dtype=np.int32)), dev)
        state = {
            "nbr_hi": _bits32(hi.reshape(n, max_deg)).to(dev),
            "nbr_lo": _bits32(lo.reshape(n, max_deg)).to(dev),
            "cdf": torch.from_numpy(np.ascontiguousarray(cdf, np.float32)).to(dev),
            "deg": torch.from_numpy(kept.astype(np.int32)).to(dev),
            "map": key_map.state,
        }
        return DeviceGraph(state, max_deg, capped_rows)

    # -- ops on the device -------------------------------------------------

    @staticmethod
    def lookup_rows(state, hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
        """[n] int64 rows, −1 for unknown nodes."""
        return device_hash_lookup(state["map"], hi, lo)

    @staticmethod
    def _samplable(state, rows: torch.Tensor) -> torch.Tensor:
        """Valid row AND kept degree > 0 AND positive weight mass: a known
        node whose kept weights all clamp to 0 masks out rather than
        surface the padding key as a neighbour."""
        r = rows.clamp(0, state["deg"].shape[0] - 1)
        return (rows >= 0) & (state["deg"][r] > 0) & (state["cdf"][r, -1] > 0)

    @staticmethod
    def _slot_of(state, rows: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """The neighbour slot of each draw: ``rows`` broadcast against the
        uniforms ``u`` in [0, 1); the count of CDF entries below
        ``u · max(total, 1e-30)``, clamped to ``max_deg − 1`` (rows −1 or of
        degree 0 give slot 0; callers mask)."""
        r = rows.clamp(0, state["cdf"].shape[0] - 1)
        cdf = state["cdf"][r]                      # [..., max_deg]
        total = cdf[..., -1]
        x = u * torch.clamp_min(total, 1e-30)
        slot = (cdf < x[..., None]).sum(dim=-1)
        return slot.clamp(max=state["cdf"].shape[1] - 1)

    @staticmethod
    def _draw(state, generator: torch.Generator, rows: torch.Tensor, shape) -> torch.Tensor:
        """One weighted draw a (row, draw): uniforms from ``generator``
        through :meth:`_slot_of`."""
        u = torch.rand(shape, generator=generator, device=rows.device)
        return DeviceGraph._slot_of(state, rows, u)

    @staticmethod
    def _gather_keys(state, rows: torch.Tensor, slot: torch.Tensor):
        """(hi, lo) int64 of the neighbours at ``slot`` [n, k] of ``rows`` [n]."""
        r = rows.clamp(0, state["deg"].shape[0] - 1)
        nh = torch.gather(state["nbr_hi"][r], 1, slot)
        nl = torch.gather(state["nbr_lo"][r], 1, slot)
        return _u32(nh), _u32(nl)

    @staticmethod
    def sample_neighbors(state, generator: torch.Generator, hi: torch.Tensor, lo: torch.Tensor,
                         k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """[n] node key halves → (nbr_hi [n, k], nbr_lo [n, k], mask [n, k]):
        k weighted draws WITH replacement per node (the GPU sample
        kernel's contract; without replacement stays on the host or the
        server)."""
        rows = DeviceGraph.lookup_rows(state, hi, lo)
        ok = DeviceGraph._samplable(state, rows)
        slot = DeviceGraph._draw(state, generator, rows[:, None], (hi.shape[0], k))
        nh, nl = DeviceGraph._gather_keys(state, rows, slot)
        mask = ok[:, None].expand(nh.shape)
        zero = torch.zeros((), dtype=nh.dtype, device=nh.device)
        return torch.where(mask, nh, zero), torch.where(mask, nl, zero), mask

    @staticmethod
    def random_walk(state, generator: torch.Generator, hi: torch.Tensor, lo: torch.Tensor,
                    length: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Deepwalk generator: [n] start keys → (walk_hi, walk_lo
        [n, length+1] int64, live [n, length+1] bool). ``length`` steps of
        one draw each; a dead end freezes the walk (``live`` turns False
        from that step on)."""
        n = hi.shape[0]
        chi, clo = _u32(hi), _u32(lo)
        alive = torch.ones(n, dtype=torch.bool, device=hi.device)
        wh, wl, lv = [chi], [clo], [alive]
        for _ in range(length):
            rows = DeviceGraph.lookup_rows(state, chi, clo)
            ok = alive & DeviceGraph._samplable(state, rows)
            slot = DeviceGraph._draw(state, generator, rows, (n,))
            nh, nl = DeviceGraph._gather_keys(state, rows, slot[:, None])
            chi = torch.where(ok, nh[:, 0], chi)
            clo = torch.where(ok, nl[:, 0], clo)
            alive = ok
            wh.append(chi)
            wl.append(clo)
            lv.append(ok)
        return torch.stack(wh, dim=1), torch.stack(wl, dim=1), torch.stack(lv, dim=1)
