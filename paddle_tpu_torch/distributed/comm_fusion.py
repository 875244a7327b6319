"""Fused-bucket, block-quantized gradient collectives for the dense DP path.

Port of ``paddle_tpu.distributed.comm_fusion`` (the reference's bucketed
``Reducer``, ``fuse_all_reduce_ops`` + ``fuse_grad_size_in_MB``, and the
EQuARX-style quantized wire). The gradient dict is packed into at most
``max_buckets`` per-dtype flat buckets, with a layout cached per (leaf
shapes and dtypes, world size, config), and each bucket is reduced by an
explicit collective of ``ops.collectives``' axis form, called from the
rank's own thread inside ``run_ranks``:

- fp32 (``quant="none"``): ONE ``psum`` a bucket, bit for bit the
  per-tensor ``psum`` (both sum the ranks' values element by element in
  rank order), so fusion alone never changes a number;
- ``quant="bf16"`` (or an outer ``FP16AllReduceOptimizer``'s wire
  dtype): two stages at wire width, ``all_to_all`` (the scatter half of a
  reduce-scatter), the chunks summed AT the wire dtype in rank order and
  divided by K, then ``all_gather``;
- ``quant="int8"``: the same two stages over block-wise int8 codes with
  per-block fp32 absmax scales (requantized between the stages), plus an
  fp32 error-feedback residual a bucket, carried in the optimizer state,
  so the quantization error comes back next step instead of being lost.

Buckets are ``(K, seg_total)``: row r holds rank r's flat slice of every
leaf, so the first stage's output IS a rank's shard of every tensor and
ZeRO stages 1/2 consume it directly (reduce-scatter, sharded update, one
``all_gather`` a bucket for the params).

The layouts, the codes and the scales equal the JAX package's for the
same leaves (dtype names as JAX names them: ``"float32"``,
``"bfloat16"``). What differs: every rank lives on one device, so the
collectives move no bytes across a link; a sum runs in rank order where
XLA associates its own (a reduced value can differ in the last bits, and
on the bf16 wire by up to one bf16 ulp where JAX's CPU backend sums the
chunks in f32). The chain hooks (:meth:`DpGradReducer.wire_dtype`,
:meth:`DpGradReducer.suspended`) are per thread: each rank's thread runs
its own chain.

No kernel is written here: the JAX module computes all of this in XLA
without Pallas, and so it is plain torch ops.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.enforce import InvalidArgumentError, enforce
from ..ops import collectives as coll

__all__ = ["BucketLayout", "CommFusionConfig", "DpGradReducer", "build_layout", "dtype_name"]

Tree = Dict[str, Any]

_QUANT_MODES = ("none", "bf16", "int8")
# dtypes whose buckets may ride the wire narrower than they are stored
_FLOAT_DTYPES = ("float32", "bfloat16", "float16")


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype as the JAX package names it (``torch.float32`` →
    ``"float32"``)."""
    return str(dtype).replace("torch.", "")


def _dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class CommFusionConfig:
    """Dense-DP comm fusion knobs (the reference's ``fuse_all_reduce_ops``
    / ``fuse_grad_size_in_MB``; the quant knobs are the EQuARX
    extension). ``fuse=False`` keeps the per-tensor ``psum`` baseline
    (the unfused rung)."""

    fuse: bool = True
    bucket_mb: float = 4.0        # flat-buffer size cap per bucket
    max_buckets: int = 8          # hard cap across all dtype groups
    quant: str = "none"           # none | bf16 | int8
    block_size: int = 256         # elements per int8 scale block
    error_feedback: bool = True   # fp32 residual in the optimizer state (int8 only)

    def __post_init__(self):
        enforce(self.quant in _QUANT_MODES,
                f"quant must be one of {_QUANT_MODES}, got {self.quant!r}", InvalidArgumentError)
        enforce(self.bucket_mb > 0, "bucket_mb must be positive", InvalidArgumentError)
        enforce(self.max_buckets >= 1, "max_buckets must be >= 1", InvalidArgumentError)
        enforce(self.block_size >= 1, "block_size must be >= 1", InvalidArgumentError)

    @classmethod
    def from_configs(cls, cfg: Optional[Dict[str, Any]]) -> "CommFusionConfig":
        """From a strategy's ``comm_fusion_configs`` dict (unknown keys
        ignored; the reference's ``fuse_grad_size_in_MB`` names the cap)."""
        cfg = dict(cfg or {})
        kw = {f.name: cfg[f.name] for f in dataclasses.fields(cls) if f.name in cfg}
        if "fuse_grad_size_in_MB" in cfg:
            kw.setdefault("bucket_mb", float(cfg["fuse_grad_size_in_MB"]))
        return cls(**kw)


class _Slot:
    """One leaf's place in a bucket: segment r of the bucket holds the
    leaf's flat elements [r·seg_len, (r+1)·seg_len)."""

    __slots__ = ("index", "shape", "dtype", "size", "seg_len", "offset")

    def __init__(self, index, shape, dtype, size, seg_len, offset):
        self.index = index
        self.shape = shape
        self.dtype = dtype
        self.size = size
        self.seg_len = seg_len
        self.offset = offset


class _Bucket:
    __slots__ = ("slots", "seg_total", "dtype", "quantizable")

    def __init__(self, slots, seg_total, dtype, quantizable):
        self.slots = slots
        self.seg_total = seg_total   # columns a rank, the int8 block tail included
        self.dtype = dtype
        self.quantizable = quantizable


class BucketLayout:
    """The bucket assignment of one (leaf metadata, K, config)."""

    __slots__ = ("buckets", "K", "n_leaves")

    def __init__(self, buckets, K, n_leaves):
        self.buckets = buckets
        self.K = K
        self.n_leaves = n_leaves


_LAYOUT_CACHE: Dict[Tuple, BucketLayout] = {}
_LAYOUT_LOCK = threading.Lock()


def build_layout(meta: Sequence[Tuple[Tuple[int, ...], str]], K: int,
                 config: CommFusionConfig) -> BucketLayout:
    """Assign leaves (``(shape, dtype_name)`` in the tree's order) to
    per-dtype, size-capped buckets: dtype groups in sorted name order,
    leaves in order within one, a new bucket when the next leaf would
    pass the cap. While the count exceeds ``max_buckets`` the cap doubles;
    one bucket a dtype is the floor. Deterministic and cached, so a
    trainer's steps and its error-feedback state keep one layout."""
    key = (tuple((tuple(s), d) for s, d in meta), K, config)
    with _LAYOUT_LOCK:
        hit = _LAYOUT_CACHE.get(key)
    if hit is not None:
        return hit

    by_dtype: Dict[str, List[int]] = {}
    for i, (_, d) in enumerate(meta):
        by_dtype.setdefault(d, []).append(i)

    cap_bytes = max(int(config.bucket_mb * (1 << 20)), 1)
    while True:
        groups: List[Tuple[str, List[List[int]]]] = []
        total = 0
        for d in sorted(by_dtype):
            itemsize = _dtype_of(d).itemsize
            cur: List[int] = []
            cur_bytes = 0
            dbuckets: List[List[int]] = []
            for i in by_dtype[d]:
                sz = int(math.prod(meta[i][0])) * itemsize
                if cur and cur_bytes + sz > cap_bytes:
                    dbuckets.append(cur)
                    cur, cur_bytes = [], 0
                cur.append(i)
                cur_bytes += sz
            if cur:
                dbuckets.append(cur)
            groups.append((d, dbuckets))
            total += len(dbuckets)
        if total <= config.max_buckets or total == len(by_dtype):
            break
        cap_bytes *= 2

    block = config.block_size
    buckets = []
    for d, dbuckets in groups:
        quantizable = d in _FLOAT_DTYPES
        for idxs in dbuckets:
            slots, off = [], 0
            for i in idxs:
                size = int(math.prod(meta[i][0]))
                seg_len = -(-size // K)   # a 0-element leaf gets 0: an empty slice
                slots.append(_Slot(i, tuple(meta[i][0]), d, size, seg_len, off))
                off += seg_len
            # int8 scale blocks must not straddle ranks: align the segment
            pad_block = quantizable and config.quant == "int8"
            seg_total = -(-off // block) * block if pad_block else off
            buckets.append(_Bucket(tuple(slots), seg_total, d, quantizable))

    layout = BucketLayout(tuple(buckets), K, len(meta))
    with _LAYOUT_LOCK:
        return _LAYOUT_CACHE.setdefault(key, layout)


def _pack_bucket(leaves: Sequence[torch.Tensor], bucket: _Bucket, K: int) -> torch.Tensor:
    """Leaves → the bucket's ``(K, seg_total)`` rank-aligned buffer."""
    parts = []
    for s in bucket.slots:
        x = leaves[s.index].reshape(-1)
        pad = s.seg_len * K - s.size
        if pad:
            x = torch.cat([x, x.new_zeros(pad)])
        parts.append(x.reshape(K, s.seg_len))
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    tail = bucket.seg_total - out.shape[1]
    if tail:
        out = torch.cat([out, out.new_zeros((K, tail))], dim=1)
    return out


def _unpack_bucket(buf: torch.Tensor, bucket: _Bucket, K: int) -> List[torch.Tensor]:
    """Inverse of :func:`_pack_bucket` (a list ordered like the slots)."""
    out = []
    for s in bucket.slots:
        x = buf[:, s.offset:s.offset + s.seg_len].reshape(-1)[:s.size]
        out.append(x.reshape(s.shape).to(_dtype_of(s.dtype)))
    return out


def _split_segment(seg: torch.Tensor, bucket: _Bucket) -> List[torch.Tensor]:
    """One rank's reduced ``(seg_total,)`` segment → the slots' flat
    ``(seg_len,)`` shards (padded; elementwise updates do not mind)."""
    return [seg[s.offset:s.offset + s.seg_len] for s in bucket.slots]


def _join_segment(parts: Sequence[torch.Tensor], bucket: _Bucket) -> torch.Tensor:
    seg = torch.cat([p.reshape(-1) for p in parts])
    tail = bucket.seg_total - seg.shape[0]
    if tail:
        seg = torch.cat([seg, seg.new_zeros(tail)])
    return seg


def _quant_int8(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-wise symmetric int8 over the last dim: per-block fp32 absmax
    scales, codes ``round(x / scale)`` half to even (``jnp.round``'s
    rule), clipped to ±127. Codes and scales equal JAX's bit for bit."""
    shp = x.shape
    xb = x.reshape(shp[:-1] + (shp[-1] // block, block))
    amax = xb.abs().amax(dim=-1, keepdim=True)
    scale = torch.div(amax, torch.full((), 127.0, dtype=amax.dtype, device=amax.device))
    inv = torch.where(scale > 0, torch.div(torch.ones_like(scale), scale),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(xb * inv), -127, 127).to(torch.int8)
    return q.reshape(shp), scale[..., 0]


def _dequant_int8(q: torch.Tensor, scale: torch.Tensor, block: int) -> torch.Tensor:
    shp = q.shape
    qb = q.reshape(shp[:-1] + (shp[-1] // block, block)).to(torch.float32)
    return (qb * scale[..., None]).reshape(shp)


def _rank_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over dim 0 folded in rank order, at ``x``'s own dtype
    (each add rounds to it, as the wire's arithmetic does)."""
    total = x[0]
    for r in range(1, x.shape[0]):
        total = total + x[r]
    return total


class DpGradReducer:
    """The explicit dense-DP gradient reducer a trainer's whole
    meta-optimizer chain shares.

    Static: the reduction axes (``axes``, reduced jointly) and the
    :class:`CommFusionConfig`. Per thread (each rank's chain sets them
    while it runs its own update): :meth:`wire_dtype`, the cast an
    ``FP16AllReduceOptimizer`` routes onto the wire, and
    :meth:`suspended`, a ``LocalSGDOptimizer``'s local steps.

    ``shard=True`` (ZeRO stage 1/2): :meth:`reduce_to_shards` stops after
    the first stage (each rank keeps its reduce-scattered flat shard of
    every leaf) and :meth:`gather_params_from_shards` all-gathers the
    updated params, one collective a bucket.

    Gradients are a dict of tensors (one rank's, before the reduction);
    the methods that communicate run inside ``ops.collectives.run_ranks``
    over a mesh that has ``axes``.
    """

    def __init__(self, axes: Sequence[str], axis_sizes: Sequence[int],
                 config: Optional[CommFusionConfig] = None, shard: bool = False) -> None:
        self.axes = tuple(axes)
        self.sizes = tuple(int(s) for s in axis_sizes)
        enforce(len(self.axes) == len(self.sizes), "axes and axis_sizes must align",
                InvalidArgumentError)
        self.K = int(math.prod(self.sizes)) if self.sizes else 1
        self.config = config or CommFusionConfig()
        self.shard = bool(shard)
        self.installed = False    # set by apply_strategy / the trainer
        self._hooks = threading.local()

    # -- the chain's hooks (per thread) ---------------------------------------

    def _wire_stack(self) -> List[torch.dtype]:
        st = getattr(self._hooks, "wire", None)
        if st is None:
            st = self._hooks.wire = []
        return st

    @contextlib.contextmanager
    def wire_dtype(self, dtype: torch.dtype):
        """The wire dtype of the collectives run inside (what
        ``FP16AllReduceOptimizer`` asks for). Ignored under ``quant="int8"``,
        which is narrower already."""
        st = self._wire_stack()
        st.append(dtype)
        try:
            yield
        finally:
            st.pop()

    @contextlib.contextmanager
    def suspended(self):
        """No gradient collective while active (LocalSGD's local steps)."""
        self._hooks.suspend = getattr(self._hooks, "suspend", 0) + 1
        try:
            yield
        finally:
            self._hooks.suspend -= 1

    @property
    def active(self) -> bool:
        return self.K > 1 and getattr(self._hooks, "suspend", 0) == 0

    def uses_error_feedback(self) -> bool:
        return (self.K > 1 and self.config.fuse and self.config.quant == "int8"
                and self.config.error_feedback)

    def _wire_mode(self, bucket: _Bucket) -> Tuple[str, Optional[torch.dtype]]:
        """("psum" | "cast" | "int8", the wire dtype) of one bucket."""
        if not bucket.quantizable:
            return "psum", None
        if self.config.quant == "int8":
            return "int8", None
        if self.config.quant == "bf16":
            return "cast", torch.bfloat16
        st = self._wire_stack()
        if st:
            return "cast", st[-1]
        return "psum", None

    # -- layout ---------------------------------------------------------------

    def layout_for(self, tree: Tree) -> BucketLayout:
        """The layout of a dict of tensors (in its key order)."""
        meta = tuple((tuple(x.shape), dtype_name(x.dtype)) for x in tree.values())
        return build_layout(meta, self.K, self.config)

    def _my_index(self) -> int:
        idx = 0
        for a in self.axes:
            idx = idx * coll.axis_size(a) + coll.axis_index(a)
        return idx

    # -- error feedback ---------------------------------------------------------

    def init_ef(self, params: Tree) -> Dict[str, torch.Tensor]:
        """Zero residuals, one flat fp32 ``(K·seg_total,)`` buffer a
        quantized bucket: a rank's OWN state (its quantization error),
        which the trainer keeps per rank (``local_state_keys``)."""
        if not self.uses_error_feedback():
            return {}
        layout = self.layout_for(params)
        dev = next(iter(params.values())).device
        return {f"b{i}": torch.zeros((b.seg_total * self.K,), dtype=torch.float32, device=dev)
                for i, b in enumerate(layout.buckets) if b.quantizable}

    # -- one bucket's collective ---------------------------------------------------

    def _two_stage_cast(self, b2d, dtype, out_dtype, gather):
        """Reduce-scatter at wire width: ``all_to_all`` moves each rank's
        cast chunks, the chunks are summed at the wire dtype in rank order
        and divided by K, then the segment is all-gathered."""
        wire = b2d.to(dtype)
        recv = coll.all_to_all(wire, self.axes, 0, 0)
        seg = _rank_sum(recv) / torch.full((), self.K, dtype=dtype, device=recv.device)
        if not gather:
            return seg.to(torch.float32)
        gat = coll.all_gather(seg[None], self.axes, 0)
        return gat.to(out_dtype)

    def _two_stage_int8(self, b2d, ef, gather):
        block = self.config.block_size
        x = b2d.to(torch.float32)
        if ef is not None:
            x = x + ef
        q, sc = _quant_int8(x, block)
        new_ef = x - _dequant_int8(q, sc, block) if ef is not None else None
        qr = coll.all_to_all(q, self.axes, 0, 0)
        scr = coll.all_to_all(sc, self.axes, 0, 0)
        seg = _rank_sum(_dequant_int8(qr, scr, block)) / self.K
        if not gather:
            return seg, new_ef
        q2, s2 = _quant_int8(seg, block)
        qg = coll.all_gather(q2[None], self.axes, 0)
        sg = coll.all_gather(s2[None], self.axes, 0)
        return _dequant_int8(qg, sg, block), new_ef

    def _reduce_bucket(self, b2d, bucket, ef, gather=True):
        """One bucket's collective → (reduced, new_ef): ``reduced`` is
        ``(K, seg_total)`` when ``gather``, else this rank's
        ``(seg_total,)`` segment."""
        mode, dtype = self._wire_mode(bucket)
        if mode == "cast":
            return self._two_stage_cast(b2d, dtype, _dtype_of(bucket.dtype), gather), ef
        if mode == "int8":
            out, new_ef = self._two_stage_int8(b2d, ef, gather)
            return (out.to(_dtype_of(bucket.dtype)) if gather else out), new_ef
        # psum: fp32 (or not a float) — ONE collective, the per-tensor sums
        flat = b2d.reshape(-1)
        if gather:
            return (coll.psum(flat, self.axes) / self.K).reshape(b2d.shape), ef
        return coll.psum_scatter(flat, self.axes) / self.K, ef

    # -- what the chain calls -----------------------------------------------------

    def reduce(self, grads: Tree, ef: Optional[Dict[str, torch.Tensor]] = None
               ) -> Tuple[Tree, Dict[str, torch.Tensor]]:
        """Mean-reduce the gradients over the axes: the whole dict out."""
        ef = ef or {}
        if not self.active or not grads:
            return grads, ef
        names = list(grads)
        leaves = [grads[k] for k in names]
        if not self.config.fuse:
            # the per-tensor baseline; a cast wire (bf16 config or an outer
            # FP16AllReduce) still rides narrow, int8 is not taken unfused
            st = self._wire_stack()
            wire = torch.bfloat16 if self.config.quant == "bf16" else (st[-1] if st else None)
            if wire is not None:
                red = [(coll.psum(g.to(wire), self.axes)
                        / torch.full((), self.K, dtype=wire, device=g.device)).to(g.dtype)
                       for g in leaves]
            else:
                red = [coll.psum(g, self.axes) / self.K for g in leaves]
            return dict(zip(names, red)), ef
        layout = self.layout_for(grads)
        out: List[Optional[torch.Tensor]] = [None] * len(leaves)
        new_ef = dict(ef)
        for i, bucket in enumerate(layout.buckets):
            b2d = _pack_bucket(leaves, bucket, self.K)
            ef_i = ef.get(f"b{i}")
            red, ef_o = self._reduce_bucket(
                b2d, bucket, None if ef_i is None else ef_i.reshape(self.K, bucket.seg_total))
            if ef_o is not None:
                new_ef[f"b{i}"] = ef_o.reshape(-1)
            for s, leaf in zip(bucket.slots, _unpack_bucket(red, bucket, self.K)):
                out[s.index] = leaf
        return dict(zip(names, out)), new_ef

    def reduce_to_shards(self, grads: Tree, ef: Optional[Dict[str, torch.Tensor]] = None
                         ) -> Tuple[Tree, Dict[str, torch.Tensor]]:
        """Mean reduce-scatter: each rank keeps its flat ``(seg_len,)``
        shard of every leaf (the ZeRO-1/2 path; never
        allreduce-then-slice, except on the unfused rung)."""
        ef = ef or {}
        names = list(grads)
        leaves = [grads[k] for k in names]
        layout = self.layout_for(grads)
        out: List[Optional[torch.Tensor]] = [None] * len(leaves)
        new_ef = dict(ef)
        for i, bucket in enumerate(layout.buckets):
            b2d = _pack_bucket(leaves, bucket, self.K)
            if not self.config.fuse:
                red = coll.psum(b2d.reshape(-1), self.axes) / self.K
                seg = red.reshape(self.K, bucket.seg_total)[self._my_index()]
            else:
                ef_i = ef.get(f"b{i}")
                seg, ef_o = self._reduce_bucket(
                    b2d, bucket, None if ef_i is None else ef_i.reshape(self.K, bucket.seg_total),
                    gather=False)
                if ef_o is not None:
                    new_ef[f"b{i}"] = ef_o.reshape(-1)
            for s, part in zip(bucket.slots, _split_segment(seg, bucket)):
                out[s.index] = part.to(_dtype_of(s.dtype))
        return dict(zip(names, out)), new_ef

    def slice_local_shards(self, tree: Tree) -> Tree:
        """This rank's own flat shard of every leaf, with no collective
        (the params entering the sharded update; LocalSGD's local steps)."""
        names = list(tree)
        leaves = [tree[k] for k in names]
        layout = self.layout_for(tree)
        my = self._my_index()
        out: List[Optional[torch.Tensor]] = [None] * len(leaves)
        for bucket in layout.buckets:
            seg = _pack_bucket(leaves, bucket, self.K)[my]
            for s, part in zip(bucket.slots, _split_segment(seg, bucket)):
                out[s.index] = part
        return dict(zip(names, out))

    def gather_params_from_shards(self, shard_tree: Tree, template: Tree) -> Tree:
        """Updated flat shards → whole params: one ``all_gather`` a bucket
        (the reference's stage-1 broadcast). Every rank receives the same
        tensors: read them, do not write into them."""
        names = list(template)
        shards = [shard_tree[k] for k in names]
        layout = self.layout_for(template)
        out: List[Optional[torch.Tensor]] = [None] * len(names)
        for bucket in layout.buckets:
            seg = _join_segment([shards[s.index] for s in bucket.slots], bucket)
            gat = coll.all_gather(seg[None], self.axes, 0)
            for s, leaf in zip(bucket.slots, _unpack_bucket(gat, bucket, self.K)):
                out[s.index] = leaf
        return dict(zip(names, out))

    def global_shard_template(self, params: Tree) -> Tree:
        """Each leaf as its zero-padded flat ``(K·seg_len,)`` buffer: what
        the inner optimizer's state is initialized over in shard mode.
        Rank r's shard of it is ``[r·seg_len, (r+1)·seg_len)``, exactly its
        :meth:`reduce_to_shards` shard."""
        layout = self.layout_for(params)
        names = list(params)
        out: Dict[str, torch.Tensor] = {}
        for bucket in layout.buckets:
            for s in bucket.slots:
                x = params[names[s.index]].detach().reshape(-1)
                flat = x.new_zeros((s.seg_len * self.K,))
                flat[:s.size] = x
                out[names[s.index]] = flat
        return {k: out[k] for k in names}

    # -- the chain's small helpers ---------------------------------------------------

    def sync_all_finite(self, ok: torch.Tensor) -> torch.Tensor:
        """AMP's skip flag, made uniform across the ranks under the
        pre-reduction contract (each rank checked its own gradients): all
        skip iff any saw a non-finite value."""
        if not self.active:
            return ok
        return coll.psum(ok.to(torch.int32), self.axes) == self.K
