"""Auto-parallel (reference ``python/paddle/distributed/auto_parallel/``).

The port's own copy of ``paddle_tpu.distributed.auto_parallel``: the
reference's semi-automatic pipeline of a ``ProcessMesh``, per-tensor
``dims_mapping`` dist-attrs (interface.py ``shard_tensor``), a
``Completer`` that propagates a few annotations to every parameter
(completion.py; here :func:`complete_shardings` and
``distributed.completion``), a cost-model planner (planner_v2.py,
cost_model.py; here :func:`choose_strategy` and
:func:`estimate_plan_cost`) and ``Engine`` (engine.py:50).

Placement on the port's mesh: a :class:`ProcessMesh` is a grid of LOGICAL
ranks (``core.mesh``) that all live on one device, and a placement is a
layout record, the tuple ``core.mesh.named_sharding`` returns (one entry
a dimension: a mesh axis name or None). :func:`shard_tensor`,
:func:`annotate`, :func:`shard_op` and :func:`reshard` attach that record
to a tensor (``dist_layout``, read back by :func:`layout_of`) and leave
its values whole on the mesh's device. So :class:`Engine` runs its step
on the card over the whole batch, which is the program GSPMD's partition
of the JAX package computes, and keeps the planned layouts
(``param_specs``, and with ``sharding_stage=1`` the optimizer slots'
``slot_specs``) for :meth:`Engine.completion`, ``save`` and ``load``.
Running an annotated dp×mp plan rank by rank over distinct cards comes
with the mesh over distinct devices (ROADMAP item 7). A pp-bearing plan
runs through :func:`hybrid_trainer_from_plan` (``parallel.hybrid``).

Layouts of 2-D weights: a ``Linear`` weight is ``[out, in]`` (the JAX
package's is ``[in, out]``); ERNIE's raw ``x @ w`` weights keep
``[in, out]``. The traced completion reads placements from the traced
contraction, so it needs no convention; the registration-order walk and
the cost model treat the weight of an ``nn.Linear`` as ``[out, in]`` and
any other 2-D parameter as ``[in, out]``.

Defaults that describe the machine are an H100's (:class:`ClusterSpec`,
``per_device_bytes``), each with its source; the device count defaults to
the number of cards (``torch.cuda.device_count()``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from ..core.enforce import InvalidArgumentError, UnavailableError, enforce
from .completion import (_canon, complete_shardings_traced, mp_annotations_traced,
                         trace_param_graph)

__all__ = ["ProcessMesh", "shard_tensor", "shard_op", "annotate", "layout_of",
           "complete_shardings", "reshard", "plan_strategy", "Engine", "ClusterSpec",
           "estimate_plan_cost", "choose_strategy", "hybrid_trainer_from_plan"]

Layout = Tuple[Optional[str], ...]

#: one H100 SXM's memory, 80 GB of HBM3 (NVIDIA's data sheet)
H100_MEMORY_BYTES = 80e9


def _card_count() -> int:
    n = torch.cuda.device_count()
    enforce(n > 0, "no CUDA device: pass the device count (n_devices= or a ProcessMesh shape) "
            "explicitly", UnavailableError)
    return n


class ProcessMesh:
    """Reference ``ProcessMesh`` (process_mesh.py): an N-D grid of ranks
    with named dimensions. The ranks are logical (``core.mesh``): ``mesh``
    builds the ``core.mesh.Mesh`` on ``device`` (None: the card, raising
    without one; ``"cpu"`` for the CPU) when first read. Without
    ``shape`` or ``mesh`` it has one axis of the number of cards."""

    def __init__(self, mesh: Optional[Sequence] = None,
                 dim_names: Optional[Sequence[str]] = None,
                 shape: Optional[Sequence[int]] = None,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        if shape is None:
            arr = np.asarray(mesh if mesh is not None else [])
            shape = arr.shape if arr.size else (_card_count(),)
        self.shape = tuple(int(s) for s in shape)
        self.dim_names = list(dim_names or [f"d{i}" for i in range(len(self.shape))])
        enforce(len(self.dim_names) == len(self.shape), "dim_names must match mesh rank")
        self._device = device
        self._mesh = None

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def mesh(self):
        """The ``core.mesh.Mesh`` of these ranks."""
        if self._mesh is None:
            from ..core.mesh import make_mesh

            self._mesh = make_mesh(dict(zip(self.dim_names, self.shape)), device=self._device)
        return self._mesh

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def __repr__(self) -> str:
        return f"ProcessMesh(shape={self.shape}, dim_names={self.dim_names})"


def _spec_from_dims_mapping(mesh: ProcessMesh,
                            dims_mapping: Sequence[Optional[int]]) -> Layout:
    """dims_mapping[i] = the index of the mesh dim tensor dim i is split
    over, or None/-1 for replicated (the reference's convention)."""
    entries = []
    for m in dims_mapping:
        if m is None or m == -1:
            entries.append(None)
        else:
            enforce(0 <= m < mesh.ndim, f"dims_mapping entry {m} out of range")
            entries.append(mesh.dim_names[m])
    return tuple(entries)


def _with_layout(x: torch.Tensor, mesh: ProcessMesh, dims_mapping) -> torch.Tensor:
    from ..core.mesh import named_sharding

    x.dist_layout = named_sharding(mesh.mesh, *_spec_from_dims_mapping(mesh, dims_mapping))
    return x


def layout_of(x: torch.Tensor) -> Layout:
    """The layout record :func:`shard_tensor` and its kin attached to
    ``x`` (the empty tuple: replicated, or never annotated)."""
    return getattr(x, "dist_layout", ())


def shard_tensor(x, process_mesh: ProcessMesh, dims_mapping: Sequence[Optional[int]]):
    """Reference ``auto_parallel.shard_tensor`` (interface.py): ``x`` (a
    tensor or array) on the mesh's device with its layout recorded."""
    return _with_layout(torch.as_tensor(x, device=process_mesh.device), process_mesh,
                        dims_mapping)


def annotate(x: torch.Tensor, process_mesh: ProcessMesh,
             dims_mapping: Sequence[Optional[int]]) -> torch.Tensor:
    """The in-graph spelling of :func:`shard_tensor`: records the layout on
    ``x`` itself, wherever it lives."""
    return _with_layout(x, process_mesh, dims_mapping)


def shard_op(fn: Callable, process_mesh: ProcessMesh,
             out_dims_mappings: Optional[Sequence[Sequence[Optional[int]]]] = None) -> Callable:
    """Reference ``shard_op``: ``fn`` with its outputs annotated."""

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        if out_dims_mappings is None:
            return out
        outs = out if isinstance(out, tuple) else (out,)
        enforce(len(outs) == len(out_dims_mappings), "one dims_mapping per output")
        annotated = tuple(annotate(o, process_mesh, dm) for o, dm in zip(outs, out_dims_mappings))
        return annotated if isinstance(out, tuple) else annotated[0]

    return wrapped


def reshard(x: torch.Tensor, process_mesh: ProcessMesh,
            dims_mapping: Sequence[Optional[int]]) -> torch.Tensor:
    """The Resharder (reference ``auto_parallel/reshard.py``): ``x`` moved
    to ``process_mesh``'s device (a copy when it lives elsewhere) under a
    new layout record; its values are unchanged."""
    return _with_layout(x.to(process_mesh.device), process_mesh, dims_mapping)


def _named_leaf_layers(layer: torch.nn.Module, prefix: str = ""):
    """(name, module) of the modules that own parameters, in registration
    order (forward order for the sequential compositions the walk
    covers)."""
    out = []
    if any(p is not None for p in layer._parameters.values()):
        out.append((prefix, layer))
    for sub_name, sub in layer._modules.items():
        if sub is not None:
            out.extend(_named_leaf_layers(sub, f"{prefix}.{sub_name}" if prefix else sub_name))
    return out


def _axis_of(entry) -> Optional[str]:
    return entry if isinstance(entry, str) else None


def _linear_types() -> tuple:
    from ..nn.layers import Linear

    return (Linear, torch.nn.Linear)


def _out_in_weights(model: torch.nn.Module) -> Set[str]:
    """The names of the ``[out, in]`` 2-D weights: those of linear layers."""
    lin = _linear_types()
    return {f"{name}.weight" if name else "weight"
            for name, m in model.named_modules() if isinstance(m, lin)}


def complete_shardings(model: torch.nn.Module, process_mesh: ProcessMesh,
                       annotations: Dict[str, Sequence[Optional[int]]],
                       example_inputs: Optional[Sequence[Any]] = None) -> Dict[str, Layout]:
    """The Completer (reference ``auto_parallel/completion.py``): from one
    or two dist-attr hints (``{param_name: dims_mapping}``), a layout for
    every parameter.

    With ``example_inputs`` (tensors, ``meta`` ones included) completion
    runs on the traced dataflow graph (``distributed.completion``:
    branches, residuals, fused weights, repeated-block hints). Without
    them, a walk of the parameter-owning modules in registration order,
    right for chains of ``Linear``/``Embedding``/``Conv2D``/norms only:
    backward, a row-parallel hint demands a column-parallel producer;
    forward, the axis the activation's features are sharded over makes an
    unannotated ``Linear`` consuming it row-parallel, and a
    column-parallel ``Linear``'s bias follows its output dim."""
    if example_inputs is not None:
        return complete_shardings_traced(model, process_mesh, annotations, example_inputs)
    from ..nn.layers import Conv2D, Embedding, LayerNorm

    lin = _linear_types()
    leaves = _named_leaf_layers(model)
    user = {name: _spec_from_dims_mapping(process_mesh, dm) for name, dm in annotations.items()}
    assigned: Dict[str, Layout] = {}

    def w_name(name):
        return f"{name}.weight" if name else "weight"

    # backward: column-parallel partners for row hints (weights [out, in])
    need: Optional[str] = None   # the axis the producer's output must carry
    for name, layer in reversed(leaves):
        wn = w_name(name)
        if isinstance(layer, lin):
            if wn in user:
                spec = user[wn]
                need = _axis_of(spec[1]) if len(spec) > 1 else None
            elif need is not None:
                assigned[wn] = (need,)    # column-parallel: the out dim
                need = None
            else:
                need = None
        elif isinstance(layer, (LayerNorm, torch.nn.LayerNorm)):
            pass   # feature-preserving: the demand flows through
        else:
            need = None

    # forward: the activation's feature-dim axis
    specs: Dict[str, Layout] = {}
    act: Optional[str] = None
    for name, layer in leaves:
        wn = w_name(name)
        pnames = [k for k, v in layer._parameters.items() if v is not None]

        def put(pname, spec, name=name):
            full = f"{name}.{pname}" if name else pname
            specs[full] = user.get(full, spec)

        if isinstance(layer, lin):
            if wn in user:
                w = user[wn]
            elif wn in assigned:
                w = assigned[wn]
            elif act is not None:
                w = (None, act)           # row-parallel completion: the in dim
            else:
                w = ()
            w = tuple(w) + (None,) * (2 - len(w))
            specs[wn] = _canon(*w)
            out_ax = _axis_of(w[0])
            if "bias" in pnames:
                put("bias", _canon(out_ax))
            act = out_ax     # a row-parallel output is psummed: replicated
        elif isinstance(layer, Embedding):
            w = tuple(user.get(wn, ()))
            specs[wn] = _canon(*w)
            act = _axis_of(w[1]) if len(w) > 1 else None
        elif isinstance(layer, Conv2D):
            if wn in user:
                w = tuple(user[wn])
            elif act is not None:
                w = (None, act, None, None)   # in channels (the row analogue)
            else:
                w = ()
            specs[wn] = _canon(*w)
            out_ax = _axis_of(w[0]) if len(w) > 0 else None
            if "bias" in pnames:
                put("bias", _canon(out_ax))
            act = out_ax
        else:
            for pname in pnames:   # norms and the rest: 1-D params replicate
                put(pname, ())
    return specs


def _pipeline_stages(model: torch.nn.Module, graph=None) -> int:
    """The largest count of homogeneous repeated blocks (a ``ModuleList``
    whose entries share one class): the deepest usable pipeline. With a
    traced graph the list must also be sequential in the dataflow (block
    i consumes block i-1's output), which tells parallel experts or heads
    from stages."""

    def sequential(prefix: str, n: int) -> bool:
        if graph is None:
            return True   # structural fallback: assume sequential
        for i in range(1, n):
            prev = {u.name for u in graph.uses if u.name.startswith(f"{prefix}.{i - 1}.")}
            cur = [u for u in graph.uses if u.name.startswith(f"{prefix}.{i}.")]
            if not cur or not any(u.preds & prev for u in cur):
                return False
        return True

    best = 1
    stack = [(model, "")]
    while stack:
        layer, prefix = stack.pop()
        for name, sub in layer.named_children():
            q = f"{prefix}.{name}" if prefix else name
            if (isinstance(sub, torch.nn.ModuleList) and len(sub) > 1
                    and len({type(b) for b in sub}) == 1 and sequential(q, len(sub))):
                best = max(best, len(sub))
            stack.append((sub, q))
    return best


def _mp_annotations(model: torch.nn.Module, mp: int,
                    example_inputs: Optional[Sequence[Any]] = None
                    ) -> Dict[str, Sequence[Optional[int]]]:
    """The planner's hint rule: large linears in alternating Megatron
    column/row pairs, embeddings vocab- or hidden-parallel, only dims
    divisible by ``mp``. With ``example_inputs`` the pairing runs on the
    traced dataflow (``completion.mp_annotations_traced``); otherwise in
    registration order (sequential chains only)."""
    if example_inputs is not None:
        return mp_annotations_traced(model, mp, 1, example_inputs)
    from ..nn.layers import Embedding

    lin = _linear_types()
    annotations: Dict[str, Sequence[Optional[int]]] = {}
    leaves = _named_leaf_layers(model)
    sizes = [int(np.prod(l._parameters["weight"].shape)) for _, l in leaves
             if isinstance(l, lin + (Embedding,)) and l._parameters.get("weight") is not None]
    threshold = max(sizes, default=0) // 4
    col_next = True
    for name, layer in leaves:
        w = layer._parameters.get("weight")
        wn = f"{name}.weight" if name else "weight"
        if w is None or int(np.prod(w.shape)) < threshold:
            continue
        if isinstance(layer, lin):        # [out, in]
            if col_next and w.shape[0] % mp == 0:
                annotations[wn] = [1, -1]   # column-parallel
                col_next = False
            elif not col_next and w.shape[1] % mp == 0:
                annotations[wn] = [-1, 1]   # row-parallel partner
                col_next = True
        elif isinstance(layer, Embedding):
            if w.shape[0] % mp == 0:
                annotations[wn] = [1, -1]   # vocab-parallel
            elif w.shape[1] % mp == 0:
                annotations[wn] = [-1, 1]   # hidden-parallel
    return annotations


def _param_bytes(p: torch.Tensor) -> int:
    return int(np.prod(p.shape)) * p.element_size()


def plan_strategy(model: torch.nn.Module, n_devices: Optional[int] = None,
                  per_device_bytes: float = H100_MEMORY_BYTES,
                  state_multiplier: float = 4.0
                  ) -> Tuple[ProcessMesh, Dict[str, Sequence[Optional[int]]]]:
    """The greedy Planner: the smallest power-of-two ``mp`` dividing the
    device count that brings ``state_multiplier`` × the parameter bytes
    under ``per_device_bytes``, with one hint per large Megatron pair
    (:func:`complete_shardings` derives the rest). An mp that shards
    nothing falls back to pure dp. Returns ``(ProcessMesh(dp, mp),
    annotations)``."""
    devs = n_devices if n_devices is not None else _card_count()
    total = sum(_param_bytes(p) for _, p in model.named_parameters())
    need = total * state_multiplier
    mp = 1
    while need / mp > per_device_bytes:
        nxt = mp * 2
        if nxt > devs or devs % nxt != 0:
            break
        mp = nxt
    annotations: Dict[str, Sequence[Optional[int]]] = {}
    if mp > 1:
        annotations = _mp_annotations(model, mp)
        if not annotations:
            mp = 1   # nothing shardable at this mp: it would halve dp for nothing
    return ProcessMesh(shape=(devs // mp, mp), dim_names=("dp", "mp")), annotations


@dataclasses.dataclass
class ClusterSpec:
    """What the cost model needs of the machine (the reference's
    ``auto_parallel/cluster.py``): per-axis link bandwidth and the device's
    peak. With ``hosts > 1`` the outermost mesh axis is laid across hosts
    and its collectives ride the inter-host link; every inner axis rides
    NVLink. Defaults are one H100 SXM's published figures at its 700 W
    limit (not measured here)."""

    # NVLink 4: 900 GB/s per H100 SXM, both directions together (NVIDIA's
    # data sheet); one direction
    ici_gbytes_per_s: float = 450.0
    # one 400 Gb/s NDR InfiniBand port per GPU (NVIDIA's DGX H100 data sheet)
    dcn_gbytes_per_s: float = 50.0
    hosts: int = 1
    # dense bf16 tensor-core peak of an H100 SXM (NVIDIA's data sheet); feeds
    # the pp bubble term only
    device_tflops: float = 989.0

    def axis_bw(self, axis_index: int, axis_size: int) -> float:
        if axis_size <= 1:
            return float("inf")
        if self.hosts > 1 and axis_index == 0:
            return self.dcn_gbytes_per_s
        return self.ici_gbytes_per_s


def estimate_plan_cost(model: torch.nn.Module, mesh: ProcessMesh,
                       annotations: Dict[str, Sequence[Optional[int]]],
                       batch_tokens: int, cluster: Optional[ClusterSpec] = None,
                       state_multiplier: float = 4.0, microbatches: int = 8,
                       sh: int = 0, recompute: bool = False) -> Dict[str, float]:
    """The analytic per-step cost of a (mesh, annotations) plan (the
    reference's ``cost_model.py``/``cost/comm_op_cost.py`` in closed form):

    - dp gradient all-reduce: ring volume 2·(dp-1)/dp of the gradient
      bytes (an mp-sharded tensor's 1/mp shard; 1/pp of them a stage);
    - mp activation all-reduce: each column→row pair psums a
      [batch_tokens, width] activation forward and backward; an unpaired
      column-parallel weight all-gathers its output instead;
    - pp: the 1F1B bubble, (pp-1)/microbatches of the per-device compute
      time, and the stage boundaries' activation sends;
    - ``sh`` (ZeRO stage over dp): stage 1 divides the optimizer state by
      dp, stage 2 the gradients too, stage 3 the parameters too and pays
      one more ring volume;
    - ``recompute``: activations drop to block boundaries for one more
      forward (compute/3).

    Memory: params + grads + optimizer state (``state_multiplier`` - 2 of
    it) + activations, each with its relief. The order of the estimates
    over candidate plans is what :func:`choose_strategy` reads."""
    cluster = cluster or ClusterSpec()
    dims = dict(zip(mesh.dim_names, mesh.shape))
    dp = int(dims.get("dp", 1))
    mp = int(dims.get("mp", 1))
    pp = int(dims.get("pp", 1))
    names = list(mesh.dim_names)
    dp_ax = names.index("dp") if "dp" in names else 0
    mp_ax = names.index("mp") if "mp" in names else 1

    params = dict(model.named_parameters())
    out_in = _out_in_weights(model)
    sharded_bytes = 0.0
    unsharded_bytes = 0.0
    total_count = 0
    for name, p in params.items():
        cnt = int(np.prod(p.shape))
        total_count += cnt
        b = float(cnt * p.element_size())
        if name in annotations and any(d is not None and d >= 0 for d in annotations[name]):
            sharded_bytes += b
        else:
            unsharded_bytes += b
    dp_grad_bytes = (sharded_bytes / mp + unsharded_bytes) / pp
    ring = lambda n: 2.0 * (n - 1) / n if n > 1 else 0.0
    dp_s = ring(dp) * dp_grad_bytes / (cluster.axis_bw(dp_ax, dp) * 1e9)
    sh = int(sh) if dp > 1 else 0   # ZeRO over a 1-wide dp axis is a no-op
    sh_extra_s = dp_s if sh >= 3 else 0.0
    dp_s += sh_extra_s

    mp_act_bytes = 0.0
    mp_gather_bytes = 0.0
    if mp > 1:
        open_col_widths: List[float] = []
        for name, spec in annotations.items():
            p = params.get(name)
            if p is None or len(p.shape) not in (2, 4):
                continue
            sdims = [d for d, m in enumerate(spec) if m == mp_ax]
            if len(sdims) != 1:
                continue   # only mp-axis shards are mp collectives
            sdim = sdims[0]
            if len(p.shape) == 2 and name in out_in:    # [out, in]
                is_row, width = sdim == 1, float(p.shape[0])
            elif len(p.shape) == 2:                     # [in, out]
                is_row, width = sdim == 0, float(p.shape[1])
            elif sdim in (0, 1):                        # OIHW conv
                is_row, width = sdim == 1, float(p.shape[0])
            else:
                continue   # a spatial shard is not a Megatron pattern
            if is_row:
                # a row partner closes every open column (Q/K/V then proj)
                mp_act_bytes += 2.0 * batch_tokens * width * 4.0
                open_col_widths.clear()
            else:
                open_col_widths.append(width)
        for width in open_col_widths:   # unpaired columns gather their output
            mp_gather_bytes += 2.0 * batch_tokens * width * 4.0
        mp_act_bytes /= max(dp, 1) * max(pp, 1)
        mp_gather_bytes /= max(dp, 1) * max(pp, 1)
    mp_bw = cluster.axis_bw(mp_ax, mp) * 1e9
    mp_s = (ring(mp) * mp_act_bytes + ring(mp) * mp_gather_bytes) / mp_bw

    flops = 6.0 * total_count * batch_tokens   # forward 2PB + backward 4PB
    compute_s = flops / (dp * mp * pp) / (cluster.device_tflops * 1e12)
    two_d = [min(int(p.shape[0]), int(p.shape[1])) for p in params.values() if len(p.shape) == 2]
    hidden = float(max(two_d, default=0))
    n_layers = max(len(two_d), 1)

    bubble_s = 0.0
    pp_p2p_s = 0.0
    if pp > 1:
        bubble_s = compute_s * (pp - 1) / max(microbatches, 1)
        pp_p2p_s = (2.0 * (pp - 1) * (batch_tokens / dp) * hidden * 4.0
                    / (cluster.ici_gbytes_per_s * 1e9))
    recompute_s = compute_s / 3.0 if recompute else 0.0

    param_pd = (sharded_bytes / mp + unsharded_bytes) / pp
    opt_mult = max(state_multiplier - 2.0, 0.0)
    shard = lambda stage_at_least: dp if sh >= stage_at_least else 1.0
    mem_params = param_pd / shard(3)
    mem_grads = param_pd / shard(2)
    mem_opt = param_pd * opt_mult / shard(1)
    act_full = (batch_tokens / max(dp, 1) / max(pp, 1)) * hidden * n_layers * 4.0
    mem_act = act_full / (n_layers if recompute else 1)
    per_device_state = mem_params + mem_grads + mem_opt + mem_act
    return {
        "dp": dp, "mp": mp, "pp": pp, "sh": sh,
        "recompute": bool(recompute),
        "dp_allreduce_bytes": dp_grad_bytes * ring(dp),
        "dp_allreduce_s": dp_s,
        "sh_extra_s": sh_extra_s,
        "mp_activation_bytes": mp_act_bytes * ring(mp),
        "mp_gather_bytes": mp_gather_bytes * ring(mp),
        "mp_activation_s": mp_s,
        "pp_bubble_s": bubble_s,
        "pp_p2p_s": pp_p2p_s,
        "recompute_s": recompute_s,
        "param_bytes": mem_params,
        "grad_bytes": mem_grads,
        "opt_state_bytes": mem_opt,
        "activation_bytes": mem_act,
        "per_device_state_bytes": per_device_state,
        "total_s": dp_s + mp_s + bubble_s + pp_p2p_s + recompute_s,
    }


def choose_strategy(model: torch.nn.Module, batch_tokens: int,
                    n_devices: Optional[int] = None,
                    per_device_bytes: float = H100_MEMORY_BYTES,
                    cluster: Optional[ClusterSpec] = None,
                    state_multiplier: float = 4.0, microbatches: int = 8,
                    example_inputs: Optional[Sequence[Any]] = None,
                    allow_pp: bool = True,
                    allow_sh=True,   # bool, or an int: the highest ZeRO stage
                    ) -> Tuple[ProcessMesh, Dict[str, Sequence[Optional[int]]],
                               List[Dict[str, float]]]:
    """The Planner's cost-model search (planner_v2.py + cost_model.py):
    every power-of-two (dp, mp, pp) factorization of the device count (pp
    capped by :func:`_pipeline_stages`) × ZeRO stage 0..3 over dp × the
    recompute toggle; each candidate's hints come from the hint rule
    (dataflow-exact with ``example_inputs``); an mp that shards nothing is
    no plan. Returns the feasible candidate (fits ``per_device_bytes``)
    with the least estimated overhead, enumeration order breaking ties
    (the least mechanism wins); when nothing fits, the one with the least
    memory. Also returns every scored candidate, the chosen one marked
    ``chosen: True``. A pp > 1 plan runs through
    :func:`hybrid_trainer_from_plan`; :class:`Engine` refuses it."""
    devs = n_devices if n_devices is not None else _card_count()
    cluster = cluster or ClusterSpec()
    graph = None
    if example_inputs is not None:
        graph = trace_param_graph(model, example_inputs)   # trace once
    max_pp = _pipeline_stages(model, graph) if allow_pp else 1
    candidates: List[Dict[str, float]] = []
    plans = {}
    ann_cache: Dict[int, Dict] = {}

    def ann_for(mp: int):
        if mp not in ann_cache:
            if graph is not None:
                ann_cache[mp] = mp_annotations_traced(model, mp, 1, example_inputs, graph=graph)
            else:
                ann_cache[mp] = _mp_annotations(model, mp)
        return ann_cache[mp]

    mp = 1
    while mp <= devs:
        pp = 1
        while mp * pp <= devs and pp <= max_pp:
            if devs % (mp * pp) == 0:
                dp = devs // (mp * pp)
                mesh = ProcessMesh(shape=(dp, mp, pp), dim_names=("dp", "mp", "pp"))
                ann = ann_for(mp) if mp > 1 else {}
                if mp == 1 or ann:
                    if dp > 1 and allow_sh:
                        max_stage = 3 if allow_sh is True else int(allow_sh)
                        sh_stages = tuple(range(0, max_stage + 1))
                    else:
                        sh_stages = (0,)
                    for sh in sh_stages:
                        for rc in (False, True):
                            cost = estimate_plan_cost(model, mesh, ann, batch_tokens, cluster,
                                                      state_multiplier, microbatches,
                                                      sh=sh, recompute=rc)
                            cost["fits"] = bool(cost["per_device_state_bytes"]
                                                <= per_device_bytes)
                            candidates.append(cost)
                            plans[(dp, mp, pp, sh, rc)] = (mesh, ann)
            pp *= 2
        mp *= 2
    feasible = [c for c in candidates if c["fits"]]
    if feasible:
        best = min(feasible, key=lambda c: c["total_s"])
    else:
        best = min(candidates, key=lambda c: c["per_device_state_bytes"])
    best["chosen"] = True
    mesh, ann = plans[(int(best["dp"]), int(best["mp"]), int(best["pp"]), int(best["sh"]),
                       bool(best["recompute"]))]
    return mesh, ann, candidates


def hybrid_trainer_from_plan(cfg, process_mesh: ProcessMesh, optimizer, num_micro: int = 2,
                             seed: int = 0, sh: int = 1,
                             device: Optional[Union[str, torch.device]] = None):
    """Run a :func:`choose_strategy` (dp, mp, pp) plan through the hybrid
    trainer: ``parallel.hybrid.HybridParallelTrainer`` of ERNIE config
    ``cfg`` over a ``{"dp", "pp", "cp": 1, "mp"}`` mesh of logical ranks on
    ``device`` (None: the card, raising without one). ``sh`` is a ZeRO
    group WIDTH (how many ranks of the plan's dp form the inner sharding
    group; it must divide dp), not the planner's stage number: above 1
    the mesh is ``{"dp": dp // sh, "pp", "cp": 1, "mp", "sh": sh}`` and
    the trainer holds every optimizer slot as per-sh-rank slices (stage
    1's memory at ``sh=dp``; stages 2-3 run through ``parallel.spmd``).
    Returns the trainer (``train_step(ids, labels)``)."""
    from ..core.mesh import make_mesh
    from ..parallel.hybrid import HybridParallelTrainer

    dims = dict(zip(process_mesh.dim_names, process_mesh.shape))
    dp, mp, pp = (int(dims.get(a, 1)) for a in ("dp", "mp", "pp"))
    sh = max(int(sh), 1)
    if sh > 1:
        enforce(dp % sh == 0, f"sh={sh} must divide dp={dp}", InvalidArgumentError)
        mesh = make_mesh({"dp": dp // sh, "pp": pp, "cp": 1, "mp": mp, "sh": sh}, device=device)
    else:
        mesh = make_mesh({"dp": dp, "pp": pp, "cp": 1, "mp": mp}, device=device)
    return HybridParallelTrainer(cfg, mesh, optimizer, num_micro=num_micro, seed=seed,
                                 device=device)


def _insert_axis_spec(spec: Layout, shape: Sequence[int], axis: str, size: int) -> Layout:
    """``spec`` with ``axis`` on its first free dim divisible by ``size``;
    unchanged when no dim qualifies."""
    t = tuple(spec) if spec is not None else ()
    t = t + (None,) * (len(shape) - len(t))
    for i, (ax, d) in enumerate(zip(t, shape)):
        if ax is None and d and d % size == 0:
            return (*t[:i], axis, *t[i + 1:])
    return tuple(spec)


def _as_tuple(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


class Engine:
    """Reference ``Engine`` (auto_parallel/engine.py:50): prepare →
    fit/evaluate/predict with the planned distribution recorded.

    The step is ``executor.Trainer``'s (the same ops, so its losses equal
    a ``Trainer``'s on the same weights and batches), run on ``device``
    (None: the card, raising without one) over the whole batch; the mesh's
    ranks are logical, so the plan is kept as layouts: ``param_specs``
    (completion of ``annotations``) and, with ``sharding_stage=1``, the
    optimizer slots' ``slot_specs`` (each slot's layout with the batch axis
    on its first free divisible dim). ``plan="auto"`` lets
    :func:`choose_strategy` pick the (dp, mp) mesh, the hints and the
    stage (pp excluded, sh up to 1) for ``n_devices`` (None: the number of
    cards). A pp > 1 mesh is refused at :meth:`prepare`: it runs through
    :func:`hybrid_trainer_from_plan`."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 process_mesh: Optional[ProcessMesh] = None,
                 batch_dim_mesh_axis: Optional[str] = None,
                 annotations: Optional[Dict[str, Sequence[Optional[int]]]] = None,
                 example_inputs: Optional[Sequence[Any]] = None,
                 plan: Optional[str] = None, batch_tokens: int = 4096,
                 per_device_bytes: float = H100_MEMORY_BYTES, sharding_stage: int = 0,
                 n_devices: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        from ..core.device import resolve_device

        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.example_inputs = example_inputs
        self.device = resolve_device(device)
        enforce(sharding_stage in (0, 1),
                f"Engine executes sharding stage 0 or 1; stage {sharding_stage} (grad/param "
                "sharding) runs through parallel.spmd / parallel.sharding", InvalidArgumentError)
        self.sharding_stage = int(sharding_stage)
        if plan == "auto":
            enforce(process_mesh is None and not annotations,
                    "plan='auto' derives mesh and annotations — don't also pass them",
                    InvalidArgumentError)
            process_mesh, annotations, cands = choose_strategy(
                model, batch_tokens=batch_tokens, n_devices=n_devices,
                per_device_bytes=per_device_bytes, example_inputs=example_inputs,
                allow_pp=False, allow_sh=1)
            self.sharding_stage = int(next(c for c in cands if c.get("chosen"))["sh"])
            batch_dim_mesh_axis = batch_dim_mesh_axis or "dp"
        else:
            enforce(plan is None, f"plan must be None or 'auto', got {plan!r}",
                    InvalidArgumentError)
        self.process_mesh = process_mesh or ProcessMesh(
            shape=(n_devices if n_devices is not None else _card_count(),), dim_names=("dp",))
        self.batch_axis = batch_dim_mesh_axis or self.process_mesh.dim_names[0]
        self.annotations = annotations or {}
        self.param_specs: Optional[Dict[str, Layout]] = None
        self.slot_specs: Dict[str, Layout] = {}
        self._trainer = None

    # -- prepare (plan + layouts, engine.py prepare/_build) -------------------

    def prepare(self) -> None:
        from ..executor import Trainer

        dims = dict(zip(self.process_mesh.dim_names, self.process_mesh.shape))
        enforce(dims.get("pp", 1) == 1,
                "Engine executes dp/mp plans only: a pp>1 plan from choose_strategy runs "
                "through the pipeline trainer (hybrid_trainer_from_plan), which partitions "
                "the stages", InvalidArgumentError)
        if self.annotations:
            self.param_specs = complete_shardings(self.model, self.process_mesh,
                                                  self.annotations,
                                                  example_inputs=self.example_inputs)
        else:
            self.param_specs = None
        params = dict(self.model.named_parameters())
        dp = dims.get(self.batch_axis, 1)
        stage1 = self.sharding_stage >= 1 and dp > 1
        self.slot_specs = {
            name: (_insert_axis_spec(self._pspec(name), p.shape, self.batch_axis, dp)
                   if stage1 else self._pspec(name))
            for name, p in params.items()}
        self._trainer = Trainer(self.model, self.optimizer, self.loss_fn, device=self.device)

    def _pspec(self, name: str) -> Layout:
        return (self.param_specs or {}).get(name, ())

    # -- train/eval/predict (engine.py fit, evaluate, predict) ----------------

    def fit(self, train_data: Iterable, epochs: int = 1, log_every: int = 0) -> List[float]:
        if self._trainer is None:
            self.prepare()
        losses: List[float] = []
        for _ in range(epochs):
            for inputs, labels in train_data:
                losses.append(float(self._trainer.train_step(_as_tuple(inputs),
                                                             _as_tuple(labels))))
                if log_every and len(losses) % log_every == 0:
                    print(f"[auto_parallel] step {len(losses)} loss {losses[-1]:.4f}")
        return losses

    def evaluate(self, data: Iterable, metric_fn: Optional[Callable] = None) -> float:
        if self._trainer is None:
            self.prepare()
        total, n = 0.0, 0
        with torch.no_grad():
            for inputs, labels in data:
                out = self._trainer.predict(_as_tuple(inputs))
                lbs = self._trainer._to_device(labels)
                total += float((metric_fn or self.loss_fn)(out, *lbs))
                n += 1
        return total / max(n, 1)

    def predict(self, inputs) -> torch.Tensor:
        if self._trainer is None:
            self.prepare()
        return self._trainer.predict(_as_tuple(inputs))

    # -- checkpoint (engine.py save/load) -------------------------------------

    def save(self, path: str) -> None:
        """Model and optimizer state and the dropout generator's state
        (``io.checkpoint.save_train_state``)."""
        from ..io.checkpoint import save_train_state

        enforce(self._trainer is not None, "prepare()/fit() before save")
        tr = self._trainer
        save_train_state(path, tr.state, opt_state=tr.opt_state,
                         rng=tr.generator.get_state().numpy(), step=tr.global_step)

    def load(self, path: str) -> None:
        """Restore a :meth:`save` snapshot onto this engine's device, under
        this engine's layouts (``param_specs``, ``slot_specs``): an engine
        prepared on another mesh or with other hints takes the same values
        under its own plan."""
        from ..io.checkpoint import graft_into, load_train_state

        if self._trainer is None:
            self.prepare()
        snap = load_train_state(path)
        tr = self._trainer
        tr.state = graft_into(tr.state, snap["state"])
        tr.opt_state = graft_into(tr.opt_state, snap["opt"])
        if snap["rng"] is not None:
            tr.generator.set_state(torch.from_numpy(np.asarray(snap["rng"], np.uint8)))
        tr.global_step = snap["step"]

    # -- introspection ---------------------------------------------------------

    def completion(self, example_inputs=None, example_labels=None) -> Dict[str, Any]:
        """The planned layouts: ``param_specs`` (every parameter's),
        ``slot_specs`` (the optimizer slots'), and, in the JAX package's
        shape, ``input_shardings`` ((params, buffers), optimizer slots, the
        batch's inputs and labels over the batch axis) and
        ``output_shardings`` ((params, buffers), slots, the loss)."""
        if self._trainer is None:
            self.prepare()
        tr = self._trainer
        params = {k: self._pspec(k) for k in tr.state["params"]}
        state = {"params": params, "buffers": {k: () for k in tr.state["buffers"]}}
        batch = (self.batch_axis,)
        ins = tuple(batch for _ in _as_tuple(example_inputs)) if example_inputs is not None else ()
        lbs = tuple(batch for _ in _as_tuple(example_labels)) if example_labels is not None else ()
        return {"param_specs": params, "slot_specs": dict(self.slot_specs),
                "input_shardings": (state, dict(self.slot_specs), ins, lbs),
                "output_shardings": (state, dict(self.slot_specs), ())}
