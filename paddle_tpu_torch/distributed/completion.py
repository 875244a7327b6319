"""Trace-based sharding completion: the Completer over a model's real graph.

The port's own copy of ``paddle_tpu.distributed.completion``. The
reference Completer (``auto_parallel/completion.py``) propagates
per-operator dist-attrs over a whole program: QKV branches, residual
sums, fused weights. Here the forward is traced to an aten graph on
shapes alone (``make_fx(..., tracing_mode="fake")`` over
``torch.func.functional_call`` with every parameter a placeholder, all of
it on the ``meta`` device, so the trace allocates nothing, runs no FLOPs
and launches no kernel), and the graph says how each parameter is USED:

- a parameter that reaches ``aten.mm``, ``addmm``, ``bmm`` or ``linear``
  through a chain of ``t``/``transpose``/``permute``/``view``/``expand``/
  ``_to_copy`` is a matmul-use: the traced contraction says which of its
  dims was contracted, and ``preds`` is the set of upstream matmul or
  lookup parameters whose output feeds its input activation (residual
  adds take the union of their inputs' sets, so branches and skips are
  exact);
- ``aten.embedding``, ``index_select``, ``index.Tensor`` or a ``slice`` of
  a parameter is an embedding-use (the JAX package's ``gather``/
  ``dynamic_slice``);
- ``aten.convolution`` pairs on its channel dims (out channels the column
  side, in channels the contracted side);
- a 1-D parameter added onto a matmul output (or fused into ``addmm`` or
  the convolution) is that matmul's bias.

Completion then runs Megatron pairing on this graph to a fixpoint: a
column-parallel hint makes every unannotated use consuming its output the
row-parallel partner; a row-parallel hint makes its producers
column-parallel; siblings consuming the exact same input activation (Q/K/V
as separate linears) take the hint's annotation; a hint whose path holds an
index segment expands over the repeated blocks (``blocks.0.attn.qkv_w``
seeds every block).

The placement comes from the traced contraction, not from a layout
convention: column-parallel shards the parameter's non-contracted dim,
row-parallel its contracted dim. So a ``Linear`` weight (``[out, in]``)
and ERNIE's raw ``x @ w`` weights (``[in, out]``, as in the JAX package)
both come out right.

Two differences from a jaxpr walk: tracing unrolls Python loops (a
recurrent cell records its weights once, at the first step, where JAX
walks a ``scan`` body once), and model code takes the one branch its
inputs choose (JAX walks every branch of a ``cond``). Two identical views
of one activation count as the same activation (a ``Linear`` on a 3-D
input reshapes it before its ``addmm``, where ``dot_general`` reads the
3-D input itself).
"""

from __future__ import annotations

import dataclasses
import itertools
import operator
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..core.enforce import enforce

__all__ = ["ParamUse", "ParamGraph", "trace_param_graph",
           "complete_shardings_traced", "mp_annotations_traced"]

# ops whose output is the same value as their input (a cast or a copy)
_IDENTITY_OPS = ("_to_copy", "clone", "detach", "alias", "lift_fresh_copy")
# ops whose output is a re-laid-out view of their input activation
_RELAYOUT_OPS = ("t", "transpose", "permute", "view", "_unsafe_view", "reshape", "expand",
                 "unsqueeze", "squeeze")
# ops through which "is a view of parameter P" propagates, with a dim map
_VIEW_OPS = _IDENTITY_OPS + _RELAYOUT_OPS
# matmul ops: (lhs arg, lhs contracted dim, rhs arg, rhs contracted dim, bias arg)
_MATMUL_OPS = {"mm": (0, 1, 1, 0, None), "addmm": (1, 1, 2, 0, 0), "bmm": (0, 2, 1, 1, None),
               "linear": (0, -1, 1, 1, 2)}
_LOOKUP_OPS = ("embedding", "index_select", "index", "slice", "narrow")


def _canon(*entries) -> Tuple:
    """The canonical layout tuple: trailing replicated dims dropped."""
    es = list(entries)
    while es and es[-1] is None:
        es.pop()
    return tuple(es)


@dataclasses.dataclass
class ParamUse:
    """One traced use of a parameter inside the forward."""

    name: str
    kind: str                 # "matmul" | "conv" | "gather"
    contracted_dim: Optional[int]  # param dim contracted / conv in-channels
    ndim: int
    preds: frozenset         # matmul/gather param names feeding the input
    order: int               # position in trace order
    out_dim: Optional[int] = None  # non-contracted feature dim (column side)
    act_id: Optional[int] = None   # identity of the input activation: two
    # uses are siblings (Q/K/V) only if they consume the same activation


@dataclasses.dataclass
class ParamGraph:
    uses: List[ParamUse]           # first use per param, trace order
    bias_of: Dict[str, str]        # weight name -> bias param name
    shapes: Dict[str, Tuple[int, ...]]

    def use_of(self, name: str) -> Optional[ParamUse]:
        for u in self.uses:
            if u.name == name:
                return u
        return None


def _op_name(target) -> str:
    if target is operator.getitem:
        return "getitem"
    packet = getattr(target, "overloadpacket", None)
    return packet.__name__ if packet is not None else getattr(target, "__name__", str(target))


def _shape(node) -> Tuple[int, ...]:
    val = node.meta.get("val") if hasattr(node, "meta") else None
    return tuple(int(s) for s in val.shape) if isinstance(val, torch.Tensor) else ()


def _meta(x) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def trace_param_graph(model: torch.nn.Module, example_inputs: Sequence[Any]) -> ParamGraph:
    """Trace ``model``'s forward (eval mode) on ``example_inputs`` (tensors
    of any device, ``meta`` included, or arrays: only shapes and dtypes are
    read) and return the parameter-dataflow graph. The trace runs on
    ``meta`` copies of the parameters, buffers and inputs."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.func import functional_call

    params = dict(model.named_parameters())
    pnames = sorted(params)
    buffers = {k: _meta(b) for k, b in model.named_buffers()}
    ins = tuple(_meta(x) for x in (example_inputs if isinstance(example_inputs, (tuple, list))
                                   else (example_inputs,)))

    def fwd(pvals, *xs):
        return functional_call(model, {**pvals, **buffers}, xs)

    was_training = model.training
    model.eval()
    try:
        gm = make_fx(fwd, tracing_mode="fake")({n: _meta(params[n]) for n in pnames}, *ins)
    finally:
        model.train(was_training)

    psrc: Dict[Any, Tuple[str, Tuple[Optional[int], ...]]] = {}   # node -> (param, dim map)
    actsrc: Dict[Any, frozenset] = {}                              # node -> producer params
    canon: Dict[Any, int] = {}                                     # node -> activation id
    relayouts: Dict[Tuple, int] = {}
    ids = itertools.count(1)
    uses: List[ParamUse] = []
    seen: Set[str] = set()
    bias_of: Dict[str, str] = {}

    def is_node(v) -> bool:
        return isinstance(v, torch.fx.Node)

    def rd_act(v) -> frozenset:
        if isinstance(v, (list, tuple)):
            return frozenset().union(*(rd_act(x) for x in v)) if v else frozenset()
        return actsrc.get(v, frozenset()) if is_node(v) else frozenset()

    def rd_psrc(v):
        return psrc.get(v) if is_node(v) else None

    def canon_of(v) -> Optional[int]:
        if not is_node(v):
            return None
        if v not in canon:
            canon[v] = next(ids)
        return canon[v]

    def record(name, kind, cdim, ndim, preds, out_dim=None, act_id=None):
        if name in seen:
            return
        seen.add(name)
        if out_dim is None and kind == "matmul" and ndim == 2 and cdim is not None:
            out_dim = 1 - cdim
        uses.append(ParamUse(name, kind, cdim, ndim, frozenset(preds), len(uses), out_dim,
                             act_id))

    def real_dims(p) -> List[int]:
        return [d for d in p[1] if d is not None]

    def view_map(op, node, dm):
        args = node.args
        out_shape, in_shape = _shape(node), _shape(args[0])
        if op in _IDENTITY_OPS:
            return dm
        if op == "t":
            return tuple(reversed(dm))
        if op == "transpose":
            d0, d1 = (int(a) % len(dm) for a in args[1:3])
            out = list(dm)
            out[d0], out[d1] = out[d1], out[d0]
            return tuple(out)
        if op == "permute":
            return tuple(dm[int(i) % len(dm)] for i in args[1])
        if op == "expand":
            return (None,) * (len(out_shape) - len(dm)) + tuple(dm)
        # view / reshape / squeeze / unsqueeze: the non-1 dims must match
        in_real = [s for s in in_shape if s != 1]
        if in_real != [s for s in out_shape if s != 1]:
            return None
        it = iter([dm[i] for i, s in enumerate(in_shape) if s != 1])
        return tuple(next(it) if s != 1 else None for s in out_shape)

    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    for i, n in enumerate(placeholders):
        if i < len(pnames):
            psrc[n] = (pnames[i], tuple(range(len(_shape(n)))))
        actsrc[n] = frozenset()

    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        op = _op_name(node.target)
        args = node.args
        tensors = [a for a in torch.utils._pytree.tree_leaves((args, node.kwargs)) if is_node(a)]
        union = frozenset().union(*(rd_act(a) for a in tensors)) if tensors else frozenset()

        if op in _MATMUL_OPS:
            li, lc, ri, rc, bi = _MATMUL_OPS[op]
            lhs, rhs = args[li], args[ri]
            wp = None
            for v, cdim in ((rhs, rc), (lhs, lc)):
                p = rd_psrc(v)
                if p is not None and len(real_dims(p)) == 2:
                    pdim = p[1][cdim]
                    if pdim is None:
                        continue
                    other = lhs if v is rhs else rhs
                    wp = (p[0], pdim, rd_act(other), canon_of(other))
                    break
            if wp is not None:
                record(wp[0], "matmul", wp[1], 2, wp[2], act_id=wp[3])
                b = rd_psrc(args[bi]) if bi is not None and bi < len(args) else None
                if b is not None and len(real_dims(b)) == 1:
                    bias_of.setdefault(wp[0], b[0])
                actsrc[node] = frozenset([wp[0]])
                canon[node] = next(ids)
                continue
        elif op == "convolution":
            p = rd_psrc(args[1])
            if p is not None and p[1][0] is not None and p[1][1] is not None:
                record(p[0], "conv", p[1][1], len(p[1]), rd_act(args[0]), out_dim=p[1][0],
                       act_id=canon_of(args[0]))
                b = rd_psrc(args[2]) if len(args) > 2 else None
                if b is not None and len(real_dims(b)) == 1:
                    bias_of.setdefault(p[0], b[0])
                actsrc[node] = frozenset([p[0]])
                canon[node] = next(ids)
                continue
        elif op in _LOOKUP_OPS:
            p = rd_psrc(args[0])
            if p is not None and len(p[1]) >= 1:
                idx = [a for a in torch.utils._pytree.tree_leaves(args[1:]) if is_node(a)]
                record(p[0], "gather", None, len(p[1]), rd_act(idx))
                actsrc[node] = frozenset([p[0]])
                canon[node] = next(ids)
                continue
        elif op == "add":
            # bias detection: a 1-D parameter (or a broadcast of one) onto
            # the output of exactly one matmul
            for a, b in ((args[0], args[1]), (args[1], args[0])):
                p = rd_psrc(a)
                if p is None:
                    continue
                other = rd_act(b)
                if len(real_dims(p)) == 1 and len(other) == 1:
                    bias_of.setdefault(next(iter(other)), p[0])

        actsrc[node] = union
        p = rd_psrc(args[0]) if op in _VIEW_OPS and args else None
        dm2 = view_map(op, node, p[1]) if p is not None else None
        if dm2 is not None:
            psrc[node] = (p[0], dm2)
        if op in _IDENTITY_OPS and args and is_node(args[0]):
            canon[node] = canon_of(args[0])
        elif op in _RELAYOUT_OPS and args and is_node(args[0]):
            key = (canon_of(args[0]), op, repr(args[1:]))
            canon[node] = relayouts.setdefault(key, next(ids))
        else:
            canon[node] = next(ids)

    shapes = {n: tuple(int(s) for s in params[n].shape) for n in pnames}
    return ParamGraph(uses=uses, bias_of=bias_of, shapes=shapes)


def _expand_block_hints(hints: Dict[str, Any], all_names: Sequence[str]) -> Dict[str, Any]:
    """A hint whose dotted path holds numeric segments seeds every
    isomorphic position: ``blocks.0.attn.qkv_w`` also annotates
    ``blocks.i.attn.qkv_w`` for every i."""
    out = dict(hints)
    for name, dm in hints.items():
        parts = name.split(".")
        if not any(p.isdigit() for p in parts):
            continue
        for cand in all_names:
            cp = cand.split(".")
            if len(cp) != len(parts) or cand in out:
                continue
            if all(a == b or (a.isdigit() and b.isdigit()) for a, b in zip(parts, cp)):
                out[cand] = dm
    return out


def _axis_entry(mesh, dims_mapping) -> Tuple[Optional[int], Optional[str]]:
    """(the param dim that is sharded, the mesh axis name) of a dims_mapping."""
    for d, m in enumerate(dims_mapping):
        if m is not None and m != -1:
            enforce(0 <= m < mesh.ndim, f"mesh dim {m} out of range")
            return d, mesh.dim_names[m]
    return None, None


def complete_shardings_traced(model: torch.nn.Module, process_mesh,
                              annotations: Dict[str, Sequence[Optional[int]]],
                              example_inputs: Sequence[Any]) -> Dict[str, Tuple]:
    """Graph-aware completion: the user's hints and the traced parameter
    graph → a layout tuple for every parameter (see the module docstring
    for the rules)."""
    graph = trace_param_graph(model, example_inputs)
    all_params = list(graph.shapes)
    hints = _expand_block_hints(annotations, all_params)
    mesh_sizes = dict(zip(process_mesh.dim_names, process_mesh.shape))

    role: Dict[str, Tuple[str, str, int]] = {}   # name -> (col|row|fixed, axis, dim)

    def classify(name, dm):
        u = graph.use_of(name)
        sdim, axis = _axis_entry(process_mesh, dm)
        if sdim is None or axis is None:
            return None
        if u is None or u.kind not in ("matmul", "conv") or u.contracted_dim is None:
            return ("fixed", axis, sdim)
        if sdim == u.contracted_dim:
            return ("row", axis, sdim)
        if sdim == u.out_dim:
            return ("col", axis, sdim)
        return ("fixed", axis, sdim)  # e.g. a conv's spatial dim: placed, not paired

    for name, dm in hints.items():
        if name in graph.shapes:
            r = classify(name, dm)
            if r is not None:
                role[name] = r

    changed = True
    while changed:
        changed = False
        for name, (kind, axis, _) in list(role.items()):
            u = graph.use_of(name)
            if u is None:
                continue
            if kind == "col":
                for s in graph.uses:   # successors consuming P's output
                    if (s.kind in ("matmul", "conv") and s.name not in role
                            and name in s.preds and s.contracted_dim is not None):
                        role[s.name] = ("row", axis, s.contracted_dim)
                        changed = True
                for s in graph.uses:   # siblings on the exact same input activation
                    if (s.kind in ("matmul", "conv") and s.name not in role
                            and u.act_id is not None and s.act_id == u.act_id
                            and s.out_dim is not None):
                        role[s.name] = ("col", axis, s.out_dim)
                        changed = True
            elif kind == "row":
                for pname in u.preds:  # producers become column-parallel
                    pu = graph.use_of(pname)
                    if (pu is not None and pu.kind in ("matmul", "conv")
                            and pname not in role and pu.out_dim is not None):
                        role[pname] = ("col", axis, pu.out_dim)
                        changed = True

    specs: Dict[str, Tuple] = {}
    for name in all_params:
        shape = graph.shapes[name]
        if name in role:
            _, axis, sdim = role[name]
            if sdim >= len(shape) or shape[sdim] % max(mesh_sizes.get(axis, 1), 1) != 0:
                specs[name] = ()   # indivisible: replicate
                continue
            entries = [None] * len(shape)
            entries[sdim] = axis
            specs[name] = _canon(*entries)
        else:
            specs[name] = ()

    # biases follow their weight's output sharding (column-parallel only)
    for w, b in graph.bias_of.items():
        if w in role and b in specs:
            kind, axis, _ = role[w]
            if kind == "col":
                bsize = graph.shapes[b][-1] if graph.shapes[b] else 0
                if bsize % max(mesh_sizes.get(axis, 1), 1) == 0:
                    specs[b] = (axis,)
    return specs


def mp_annotations_traced(model: torch.nn.Module, mp: int, mp_dim: int,
                          example_inputs: Optional[Sequence[Any]] = None,
                          graph: Optional[ParamGraph] = None) -> Dict[str, List[int]]:
    """The planner's hint rule on the traced graph: walk the matmul uses in
    dataflow order; an unassigned use whose input derives from an open
    column-parallel parameter becomes its row partner, otherwise it opens
    a new column-parallel pair. Lookups go vocab-parallel when divisible
    (else hidden-parallel). Only parameters of at least a quarter of the
    largest's size take part, and only divisible dims. Pass ``graph`` to
    reuse a trace."""
    if graph is None:
        graph = trace_param_graph(model, example_inputs)
    sizes = [int(np.prod(graph.shapes[u.name])) for u in graph.uses]
    threshold = max(sizes, default=0) // 4
    ann: Dict[str, List[int]] = {}
    open_cols: Set[str] = set()

    def dm_for(ndim, sdim):
        out = [-1] * ndim
        out[sdim] = mp_dim
        return out

    for u in graph.uses:
        shape = graph.shapes[u.name]
        if int(np.prod(shape)) < threshold or u.name in ann:
            continue
        if u.kind == "gather":
            if shape[0] % mp == 0:
                ann[u.name] = dm_for(len(shape), 0)   # vocab-parallel
            elif len(shape) > 1 and shape[1] % mp == 0:
                ann[u.name] = dm_for(len(shape), 1)   # hidden-parallel
            continue
        if u.kind not in ("matmul", "conv") or u.contracted_dim is None or u.out_dim is None:
            continue
        closing = [p for p in u.preds if p in open_cols]
        if closing and shape[u.contracted_dim] % mp == 0:
            ann[u.name] = dm_for(u.ndim, u.contracted_dim)  # row partner
            for p in closing:
                open_cols.discard(p)
        elif shape[u.out_dim] % mp == 0:
            ann[u.name] = dm_for(u.ndim, u.out_dim)  # column
            open_cols.add(u.name)
    return ann
