"""Device-resident sparse embedding cache for one training pass (GPUPS).

Port of ``paddle_tpu.ps.embedding_cache``: the pass's working set lives
on the card as dense SoA columns (values + per-row optimizer state),
pulled by a gather and pushed by the merge_grad-shaped sparse update —
dedup the batch's rows, gather the touched rows, run the per-row CTR
rule (``ops.sparse_optimizer.ctr_sparse_rows``: the CUDA kernel on the
card), scatter them back. ``end_pass`` flushes the rows to the host
table.

Cache state is a dict of columns, the JAX package's layout:
``show [C]``, ``click [C]``, ``embed_w [C,1]``, ``embed_state [C,es]``,
``embedx_w [C,dim]``, ``embedx_state [C,xs]``, ``has_embedx [C]``
(float32), where es/xs are the rules' state widths. Unlike the JAX
package, which returns fresh arrays, the port updates these tensors IN
PLACE (``index_copy_``) and returns the same dict: the working set is
the largest allocation of a pass and is never copied per step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.enforce import enforce, enforce_le
from ..ops.sparse_optimizer import ctr_sparse_rows, fused_row_update
from .device_hash import DeviceKeyMap
from .native import FeasignIndex, dedup_u64
from .sgd_rule import SGDRuleConfig
from .table import MemorySparseTable

__all__ = ["CacheConfig", "HbmEmbeddingCache", "cache_pull", "cache_push",
           "cache_push_dense", "cache_push_sparse", "merge_sparse_grads",
           "resolve_push_mode"]

_COLUMNS = ("show", "click", "embed_w", "embed_state", "embedx_w",
            "embedx_state", "has_embedx")


def resolve_push_mode(mode: str) -> str:
    """Resolve CacheConfig.push_mode: ``"auto"`` → ``"sparse"``, the
    reference's own GPU shape (merge_grad, then one thread per touched
    row) and the only mode that runs the kernel. ``"dense"`` stays
    available as plain math."""
    return "sparse" if mode == "auto" else mode


@dataclasses.dataclass
class CacheConfig:
    capacity: int = 1 << 20
    embedx_dim: int = 8
    sgd: SGDRuleConfig = dataclasses.field(default_factory=SGDRuleConfig)
    nonclk_coeff: float = 0.1
    click_coeff: float = 1.0
    embedx_threshold: float = 10.0  # lazy embedx creation score threshold
    #: per-feature rules; must match the host table's accessor so the
    #: flushed-back optimizer state round-trips
    embed_rule: str = "adagrad"
    embedx_rule: str = "adagrad"
    #: lazy-embedx creation semantics: True = create then apply this
    #: push's gradient (the reference's CPU accessor order, bit-parity
    #: with the host tables); False = create only (its GPU optimizer)
    create_applies_grad: bool = True
    #: "sparse" (merge_grad shape, through the kernel), "dense" (one
    #: scatter-add then a masked update of the whole table, plain math)
    #: or "auto" (= "sparse")
    push_mode: str = "auto"


def cache_pull(state: Dict[str, torch.Tensor], rows: torch.Tensor) -> torch.Tensor:
    """[n, 1+dim] = embed_w ++ embedx_w for ``rows``. Sentinel-safe: rows
    ≥ capacity (missing key / padding) pull zeros."""
    C = state["embed_w"].shape[0]
    safe = rows.clamp(max=C - 1)
    pulled = torch.cat([state["embed_w"][safe], state["embedx_w"][safe]], dim=1)
    return torch.where((rows < C)[:, None], pulled, torch.zeros((), dtype=pulled.dtype,
                                                                device=pulled.device))


def merge_sparse_grads(rows: torch.Tensor, grads: torch.Tensor, shows: torch.Tensor,
                       clicks: torch.Tensor, capacity: int):
    """merge_grad: in-batch dedup (the cub sort+reduce step,
    heter_comm_inl.h:388). Mirrors ``jnp.unique(size=n, fill_value=C)``:
    ``uniq`` [n] is the sorted set of distinct rows padded with the
    sentinel ``capacity``, and the sums are [n]-long segment sums.

    On the CPU, ``index_add_`` sums duplicates in occurrence order, the
    order of the JAX package's segment_sum, so the result is bit-equal.
    On CUDA it sums with atomics in no fixed order: a row hit k times
    can differ from the CPU sum by a few ulp of its largest addend
    (relative ~k·2^-24). A deterministic sort-and-reduce merge belongs
    to the fused scatter-apply kernel of a later slice."""
    n = rows.shape[0]
    u, inv = torch.unique(rows, sorted=True, return_inverse=True)
    uniq = torch.full((n,), capacity, dtype=rows.dtype, device=rows.device)
    uniq[: u.shape[0]] = u
    show_sum = torch.zeros(n, dtype=shows.dtype, device=shows.device).index_add_(0, inv, shows)
    click_sum = torch.zeros(n, dtype=clicks.dtype, device=clicks.device).index_add_(0, inv, clicks)
    g = torch.zeros((n, grads.shape[1]), dtype=grads.dtype,
                    device=grads.device).index_add_(0, inv, grads)
    return uniq, show_sum, click_sum, g


def _scatter_rows(col: torch.Tensor, uniq: torch.Tensor, vals: torch.Tensor,
                  capacity: int) -> None:
    """``col[uniq] = vals`` in place, dropping sentinel entries (uniq ≥ C)
    without a host sync: each sentinel entry is redirected to write the
    same value that entry 0 writes to row uniq[0] (or, when every entry
    is a sentinel, row 0's own value back to row 0), so every duplicate
    index carries one value and the result does not depend on order."""
    valid = uniq < capacity
    first_valid = valid[0]
    tgt0 = torch.where(first_valid, uniq[0], torch.zeros_like(uniq[0]))
    val0 = torch.where(first_valid, vals[0], col[0])
    idx = torch.where(valid, uniq, tgt0)
    mask = valid.reshape((-1,) + (1,) * (vals.dim() - 1))
    col.index_copy_(0, idx, torch.where(mask, vals, val0))


def cache_push_sparse(
    state: Dict[str, torch.Tensor],
    rows: torch.Tensor,     # [n] cache rows (may repeat; ≥ C = dropped)
    grads: torch.Tensor,    # [n, 1+dim] embed_g ++ embedx_g
    shows: torch.Tensor,    # [n]
    clicks: torch.Tensor,   # [n]
    cfg: CacheConfig,
) -> Dict[str, torch.Tensor]:
    """The merge_grad-shaped push: dedup the batch's rows, gather the
    touched rows, apply the per-row CTR rule through ``ctr_sparse_rows``
    and scatter the rows back in place. Returns ``state``."""
    C = state["embed_w"].shape[0]
    sgd = cfg.sgd
    uniq, show_sum, click_sum, g = merge_sparse_grads(rows, grads, shows, clicks, C)
    srows = torch.where(uniq < C, uniq, torch.zeros_like(uniq))  # safe gather index
    gathered = tuple(state[k][srows] for k in _COLUMNS)
    new_rows = ctr_sparse_rows(
        gathered, show_sum, click_sum, g[:, :1].contiguous(), g[:, 1:].contiguous(),
        embed_rule=cfg.embed_rule, embedx_rule=cfg.embedx_rule,
        lr=sgd.learning_rate, initial_g2sum=sgd.initial_g2sum,
        weight_bounds=tuple(sgd.weight_bounds), beta1=sgd.beta1, beta2=sgd.beta2,
        eps=sgd.ada_epsilon, nonclk_coeff=cfg.nonclk_coeff,
        click_coeff=cfg.click_coeff, embedx_threshold=cfg.embedx_threshold,
        create_applies_grad=cfg.create_applies_grad)
    for k, vals in zip(_COLUMNS, new_rows):
        if state[k].numel():  # zero-width state (naive rule) has nothing to write
            _scatter_rows(state[k], uniq, vals, C)
    return state


def cache_push_dense(
    state: Dict[str, torch.Tensor],
    rows: torch.Tensor,
    grads: torch.Tensor,
    shows: torch.Tensor,
    clicks: torch.Tensor,
    cfg: CacheConfig,
) -> Dict[str, torch.Tensor]:
    """The JAX package's TPU push, kept as plain math off the main path:
    one duplicate-safe scatter-add of [grads | show | click | count] into
    a [C+1, 4+dim] accumulator (row C collects the sentinels), then the
    per-row rule over the whole table with a touched mask (a row present
    in the batch). Updates ``state`` in place and returns it."""
    C = state["embed_w"].shape[0]
    sgd = cfg.sgd
    dim = cfg.embedx_dim
    ones = torch.ones((rows.shape[0], 1), dtype=torch.float32, device=rows.device)
    upd = torch.cat([grads.float(), shows[:, None], clicks[:, None], ones], dim=1)
    acc = torch.zeros((C + 1, upd.shape[1]), dtype=torch.float32, device=rows.device)
    acc = acc.index_add_(0, rows, upd)[:C]
    touched = acc[:, 3 + dim] > 0
    outs = fused_row_update(
        *(state[k] for k in _COLUMNS), acc[:, 1 + dim], acc[:, 2 + dim],
        acc[:, :1], acc[:, 1:1 + dim],
        embed_rule=cfg.embed_rule, embedx_rule=cfg.embedx_rule, dim=dim,
        lr=sgd.learning_rate, initial_g2sum=sgd.initial_g2sum,
        wmin=sgd.weight_bounds[0], wmax=sgd.weight_bounds[1], beta1=sgd.beta1,
        beta2=sgd.beta2, eps=sgd.ada_epsilon, nonclk_coeff=cfg.nonclk_coeff,
        click_coeff=cfg.click_coeff, embedx_threshold=cfg.embedx_threshold,
        create_applies_grad=cfg.create_applies_grad)
    for k, new in zip(_COLUMNS, outs):
        mask = touched if new.dim() == 1 else touched[:, None]
        state[k].copy_(torch.where(mask, new, state[k]))
    return state


def cache_push(
    state: Dict[str, torch.Tensor],
    rows: torch.Tensor,     # [n] cache rows (may repeat)
    grads: torch.Tensor,    # [n, 1+dim] embed_g ++ embedx_g
    shows: torch.Tensor,    # [n]
    clicks: torch.Tensor,   # [n]
    cfg: CacheConfig,
) -> Dict[str, torch.Tensor]:
    """PushSparseGrad: dispatches on ``cfg.push_mode`` (see CacheConfig);
    both modes apply the same per-row math to the same per-row sums."""
    mode = resolve_push_mode(cfg.push_mode)
    if mode == "dense":
        return cache_push_dense(state, rows, grads, shows, clicks, cfg)
    enforce(mode == "sparse", f"unknown push_mode {cfg.push_mode!r}")
    return cache_push_sparse(state, rows, grads, shows, clicks, cfg)


class HbmEmbeddingCache:
    """Pass-scoped device working set over a host MemorySparseTable.

    Usage (the PSGPUWrapper pass lifecycle)::

        cache.begin_pass(all_keys_of_pass)      # dedup + build + upload
        ... steps read/update cache.state (and cache.device_map.state) ...
        cache.end_pass()                         # flush back to host table

    ``device`` defaults to ``"cuda"`` and raises without a GPU unless the
    caller passes ``device="cpu"``.
    """

    def __init__(self, table: MemorySparseTable, config: Optional[CacheConfig] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 device_map: bool = False) -> None:
        self.device = resolve_device(device)
        self.table = table
        acc_cfg = table.accessor.config
        self.config = config or CacheConfig(
            embedx_dim=acc_cfg.embedx_dim, embed_rule=acc_cfg.embed_sgd_rule,
            embedx_rule=acc_cfg.embedx_sgd_rule, sgd=acc_cfg.sgd,
            nonclk_coeff=acc_cfg.nonclk_coeff, click_coeff=acc_cfg.click_coeff,
            embedx_threshold=acc_cfg.embedx_threshold)
        enforce(self.config.embedx_dim == acc_cfg.embedx_dim,
                "cache embedx_dim must match table")
        # flush-back writes optimizer state into the table's columns —
        # the rules (and so the state layouts) must agree
        enforce(self.config.embed_rule == acc_cfg.embed_sgd_rule
                and self.config.embedx_rule == acc_cfg.embedx_sgd_rule,
                f"cache rules ({self.config.embed_rule}/{self.config.embedx_rule})"
                f" must match table accessor ({acc_cfg.embed_sgd_rule}/"
                f"{acc_cfg.embedx_sgd_rule})")
        # ... and so must the hyperparameters the device math uses
        for f in ("learning_rate", "initial_g2sum", "weight_bounds", "beta1",
                  "beta2", "ada_epsilon"):
            enforce(getattr(self.config.sgd, f) == getattr(acc_cfg.sgd, f),
                    f"cache sgd.{f} ({getattr(self.config.sgd, f)}) must match "
                    f"table accessor sgd.{f} ({getattr(acc_cfg.sgd, f)})")
        self._index: Optional[FeasignIndex] = None
        self.state: Optional[Dict[str, torch.Tensor]] = None
        self._pass_keys: Optional[np.ndarray] = None
        self._device_map_enabled = device_map
        #: per-pass on-device key→row map, set by begin_pass when
        #: device_map=True
        self.device_map: Optional[DeviceKeyMap] = None

    # -- pass lifecycle ---------------------------------------------------

    def prepare_pass(self, keys: np.ndarray) -> dict:
        """The host-only half of begin_pass (dedup + row assignment +
        cuckoo build); touches neither the table nor device state."""
        uniq = dedup_u64(keys)
        enforce_le(len(uniq), self.config.capacity,
                   "pass working set exceeds cache capacity")
        index = FeasignIndex(len(uniq) * 2)
        rows, _ = index.lookup_or_insert(uniq)
        prepared = {"uniq": uniq, "index": index, "rows": rows, "map_host": None}
        if self._device_map_enabled:
            prepared["map_host"] = DeviceKeyMap.build_host(uniq, rows)
        return prepared

    def begin_pass(self, keys: np.ndarray) -> int:
        """Dedup the pass's keys, pull current values from the host table,
        upload the working set. Returns the number of distinct keys."""
        return self.activate_pass(self.prepare_pass(keys))

    def activate_pass(self, prepared: dict) -> int:
        """The device half of begin_pass: export the table's rows for the
        prepared keys (insert-on-miss) and upload them and the key map."""
        cfg = self.config
        uniq, rows = prepared["uniq"], prepared["rows"]
        self._index = prepared["index"]
        self._pass_keys = uniq
        acc = self.table.accessor
        es = acc.embed_rule.state_dim
        xs = acc.embedx_rule.state_dim
        xd = acc.config.embedx_dim
        values, _ = self.table.export_full(uniq, create=True)
        C = cfg.capacity
        host = {
            "show": np.zeros(C, np.float32),
            "click": np.zeros(C, np.float32),
            "embed_w": np.zeros((C, 1), np.float32),
            "embed_state": np.zeros((C, es), np.float32),
            "embedx_w": np.zeros((C, xd), np.float32),
            "embedx_state": np.zeros((C, xs), np.float32),
            "has_embedx": np.zeros(C, np.float32),
        }
        # full layout: slot, unseen_days, delta_score, show, click,
        # embed_w, embed_state[es], has_embedx, embedx_w[xd], embedx_state
        host["show"][rows] = values[:, 3]
        host["click"][rows] = values[:, 4]
        host["embed_w"][rows, 0] = values[:, 5]
        host["embed_state"][rows] = values[:, 6:6 + es]
        host["has_embedx"][rows] = values[:, 6 + es]
        host["embedx_w"][rows] = values[:, 7 + es:7 + es + xd]
        host["embedx_state"][rows] = values[:, 7 + es + xd:7 + es + xd + xs]
        if self._device_map_enabled:
            self.device_map = DeviceKeyMap(prepared["map_host"], self.device)
        self.state = {k: torch.from_numpy(v).to(self.device) for k, v in host.items()}
        return len(uniq)

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Batch keys → cache rows on the host (the row-fed step's input)."""
        enforce(self._index is not None, "begin_pass first")
        rows = self._index.lookup(np.ascontiguousarray(keys, np.uint64))
        enforce(bool((rows >= 0).all()), "batch contains keys outside the pass working set")
        return rows

    def end_pass(self) -> None:
        """EndPass / dump_to_cpu: write the working set back into the host
        table (values + optimizer state, direct overwrite)."""
        if self._index is None or self.state is None:
            return
        host = {k: v.cpu().numpy() for k, v in self.state.items()}
        keys = self._pass_keys
        rows = self._index.lookup(keys)
        acc = self.table.accessor
        es = acc.embed_rule.state_dim
        xs = acc.embedx_rule.state_dim
        xd = acc.config.embedx_dim
        # flush-back runs at a pass boundary with training quiesced; all
        # pass keys were created in begin_pass, so every row must exist
        old, found = self.table.export_full(keys)
        enforce(bool(found.all()),
                "end_pass: pass keys missing from host table (table was "
                "mutated mid-pass)")
        new = old.copy()
        # lifecycle stats: features trained in this pass were seen —
        # zero unseen_days and fold the show/click growth into delta_score
        cfg = acc.config
        d_show = host["show"][rows] - old[:, 3]
        d_click = host["click"][rows] - old[:, 4]
        new[:, 2] = old[:, 2] + (d_show - d_click) * cfg.nonclk_coeff + d_click * cfg.click_coeff
        new[:, 1] = 0.0
        new[:, 3] = host["show"][rows]
        new[:, 4] = host["click"][rows]
        new[:, 5] = host["embed_w"][rows, 0]
        new[:, 6:6 + es] = host["embed_state"][rows]
        has = host["has_embedx"][rows] > 0
        keep_old = old[:, 6 + es] != 0.0
        new[:, 6 + es] = (has | keep_old).astype(np.float32)
        new[has, 7 + es:7 + es + xd] = host["embedx_w"][rows[has]]
        new[has, 7 + es + xd:7 + es + xd + xs] = host["embedx_state"][rows[has]]
        self.table.import_full(keys, new)
        self.discard_pass()

    def discard_pass(self) -> None:
        """Drop the working set WITHOUT flushing back (aborted pass)."""
        self._index = None
        self.state = None
        self._pass_keys = None
        self.device_map = None
