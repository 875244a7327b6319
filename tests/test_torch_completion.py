"""The port's traced Completer (``paddle_tpu_torch.distributed.completion``)
against the JAX package's jaxpr walk: the same models (weights of the
same names in both packages) give the same parameter graph (uses, kinds,
contracted dims, producer sets, sibling classes, biases), the same specs
from ``complete_shardings`` (traced and sequential) and the same hints
from ``mp_annotations_traced``, for the cases of
``tests/test_auto_parallel.py``'s ``TestCompletion`` and
``TestTracedCompletion``. A ``Linear`` weight is ``[in, out]`` in the JAX
package and ``[out, in]`` in the port: its dims map across (specs and
dims_mappings transposed, contracted dim 0 ↔ 1). Exact equality
throughout: the two walks compute no floating-point value."""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu.distributed import auto_parallel as jauto
from paddle_tpu.distributed import completion as jcomp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed import auto_parallel as tauto
from paddle_tpu_torch.distributed import completion as tcomp


def _model_classes(jax_side):
    nn = jnn if jax_side else tnn
    Base = jnn.Layer if jax_side else torch.nn.Module
    relu = jax.nn.relu if jax_side else torch.relu

    class Mlp(Base):
        def __init__(self, d=16, h=32, out=4):
            super().__init__()
            self.fc1 = nn.Linear(d, h)
            self.ln = nn.LayerNorm(h)
            self.fc2 = nn.Linear(h, h)
            self.fc3 = nn.Linear(h, out)

        def forward(self, x):
            return self.fc3(relu(self.fc2(self.ln(relu(self.fc1(x))))))

    class ConvNet(Base):
        def __init__(self, k=3, cin=3, mid=16, cout=32):
            super().__init__()
            self.c1 = nn.Conv2D(cin, mid, k, padding=1)
            self.c2 = nn.Conv2D(mid, cout, 3, padding=1)

        def forward(self, x):
            return self.c2(relu(self.c1(x)))

    class TwoTower(Base):
        def __init__(self):
            super().__init__()
            self.a1 = nn.Linear(16, 32)
            self.a2 = nn.Linear(32, 8)
            self.b1 = nn.Linear(16, 32)
            self.b2 = nn.Linear(32, 8)

        def forward(self, x):
            return (self.a2(relu(self.a1(x))) * self.b2(relu(self.b1(x)))).sum(-1)

    class TwoInput(Base):
        def __init__(self):
            super().__init__()
            self.a1 = nn.Linear(16, 32)
            self.b1 = nn.Linear(24, 32)

        def forward(self, x, y):
            return (self.a1(x) + self.b1(y)).sum(-1)

    if jax_side:
        @jax.jit
        def tower(w1, w2, x):
            return jax.nn.relu(x @ w1) @ w2
    else:
        def tower(w1, w2, x):   # the port's Linear weights are [out, in]
            return torch.relu(x @ w1.t()) @ w2.t()

    class SharedFn(Base):
        def __init__(self):
            super().__init__()
            self.a1 = nn.Linear(16, 32)
            self.a2 = nn.Linear(32, 8)
            self.b1 = nn.Linear(16, 32)
            self.b2 = nn.Linear(32, 8)

        def forward(self, x, y):
            a = tower(self.a1.weight, self.a2.weight, x)
            b = tower(self.b1.weight, self.b2.weight, y)
            return (a + b).sum(-1)

    class Block(Base):
        def __init__(self, d):
            super().__init__()
            self.fc = nn.Linear(d, d)

        def forward(self, x):
            return relu(self.fc(x))

    class Stacked(Base):
        def __init__(self, n_blocks=4, d=32):
            super().__init__()
            self.blocks = nn.LayerList([Block(d) for _ in range(n_blocks)])

        def forward(self, x):
            for b in self.blocks:
                x = b(x)
            return x

    class Experts(Base):
        def __init__(self):
            super().__init__()
            self.experts = nn.LayerList([nn.Linear(16, 16) for _ in range(4)])

        def forward(self, x):
            return sum(e(x) for e in self.experts)

    class EmbNet(Base):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(4096, 16)
            self.head = nn.Linear(16, 4)

        def forward(self, x):
            return self.head(self.emb(x))

    return dict(mlp=Mlp, conv=ConvNet, two_tower=TwoTower, two_input=TwoInput,
                shared_fn=SharedFn, stacked=Stacked, experts=Experts, emb=EmbNet)


ERNIE_SMALL = dict(vocab_size=128, hidden_size=32, num_heads=4, ffn_size=64, num_layers=2,
                   max_seq_len=16, mp_axis=None, cp_axis=None, ep_axis=None)

#: model → (constructor kwargs, example input shapes and dtypes)
MODELS = {
    "mlp": ({}, [((4, 16), "f")]),
    "conv": ({}, [((2, 3, 8, 8), "f")]),
    "conv_k4": ({"k": 4}, [((2, 3, 8, 8), "f")]),
    "conv8": ({"cin": 8, "mid": 64, "cout": 64}, [((2, 8, 8, 8), "f")]),
    "two_tower": ({}, [((4, 16), "f")]),
    "two_input": ({}, [((4, 16), "f"), ((4, 24), "f")]),
    "shared_fn": ({}, [((4, 16), "f"), ((4, 16), "f")]),
    "stacked": ({}, [((4, 32), "f")]),
    "stacked33": ({"n_blocks": 8, "d": 33}, [((4, 33), "f")]),
    "experts": ({}, [((4, 16), "f")]),
    "emb": ({}, [((4, 3), "i")]),
    "ernie": ({}, [((2, 16), "i")]),
}


def build(kind, jax_side, **kw):
    """(model, example inputs, the names of its [out, in] Linear weights)
    of one package."""
    ctor_kw, shapes = MODELS[kind]
    ctor_kw = {**ctor_kw, **kw}
    if kind == "ernie":
        if jax_side:
            from paddle_tpu.models.ernie import Ernie, ErnieConfig
            pt.seed(0)
        else:
            from paddle_tpu_torch.models.ernie import Ernie, ErnieConfig
        model = Ernie(ErnieConfig(**{**ERNIE_SMALL, **ctor_kw}))
    else:
        if jax_side:
            pt.seed(0)
        cls = _model_classes(jax_side)[kind.rstrip("0123456789").replace("conv_k", "conv")]
        model = cls(**ctor_kw)
    if jax_side:
        ins = [jax.ShapeDtypeStruct(s, np.float32 if d == "f" else np.int32) for s, d in shapes]
    else:
        ins = [torch.empty(s, dtype=torch.float32 if d == "f" else torch.int64, device="meta")
               for s, d in shapes]
    lin = set() if jax_side else tauto._out_in_weights(model)
    return model, ins, lin


def _canon(entries):
    es = list(entries)
    while es and es[-1] is None:
        es.pop()
    return tuple(es)


def port_spec_as_jax(name, spec, lin):
    """A port layout in the JAX package's dim order (Linear weights
    transposed)."""
    if name in lin:
        es = list(spec) + [None] * (2 - len(spec))
        return _canon((es[1], es[0]))
    return _canon(spec)


def jax_dm_for_port(name, dm, lin):
    """A JAX dims_mapping in the port's dim order."""
    return list(reversed(dm)) if name in lin else list(dm)


def _use_rows(graph, lin, jax_side):
    rows = []
    for u in graph.uses:
        cd, od = u.contracted_dim, u.out_dim
        if not jax_side and u.name in lin:
            cd, od = (None if cd is None else 1 - cd), (None if od is None else 1 - od)
        rows.append((u.name, u.kind, cd, od, u.ndim, u.preds))
    return rows


def _sibling_classes(graph):
    ids = [u.act_id for u in graph.uses]
    return [[j for j, b in enumerate(ids) if a is not None and a == b] for a in ids]


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_traced_param_graph_matches_jax(kind):
    jm, jins, _ = build(kind, True)
    tm, tins, lin = build(kind, False)
    jg = jcomp.trace_param_graph(jm, jins)
    tg = tcomp.trace_param_graph(tm, tins)
    assert _use_rows(tg, lin, False) == _use_rows(jg, set(), True)
    assert _sibling_classes(tg) == _sibling_classes(jg)
    assert tg.bias_of == jg.bias_of
    assert {k: (v[::-1] if k in lin else v) for k, v in tg.shapes.items()} == jg.shapes


def test_trace_runs_on_meta_and_leaves_the_model_alone():
    tm, _, _ = build("ernie", False)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tm.train()
    g = tcomp.trace_param_graph(tm, [torch.zeros(2, 16, dtype=torch.int64)])
    assert tm.training and len(g.uses) == 11
    assert all(torch.equal(v, before[k]) for k, v in tm.state_dict().items())
    assert all(p.device.type == "cpu" for p in tm.parameters())


def _mesh(jax_side, shape=(2, 4), names=("dp", "mp")):
    if jax_side:
        return jauto.ProcessMesh(shape=shape, dim_names=names)
    return tauto.ProcessMesh(shape=shape, dim_names=names, device="cpu")


#: (model, its kwargs, JAX-layout hints, traced?)
COMPLETION_CASES = {
    "mlp_col_traced": ("mlp", {}, {"fc2.weight": [-1, 1]}, True),
    "mlp_row_traced": ("mlp", {}, {"fc2.weight": [1, -1]}, True),
    "mlp_col_sequential": ("mlp", {}, {"fc2.weight": [-1, 1]}, False),
    "mlp_row_sequential": ("mlp", {}, {"fc2.weight": [1, -1]}, False),
    "conv_chain_traced": ("conv", {}, {"c1.weight": [1, -1, -1, -1]}, True),
    "conv_chain_sequential": ("conv", {}, {"c1.weight": [1, -1, -1, -1]}, False),
    "conv_spatial_traced": ("conv_k4", {}, {"c1.weight": [-1, -1, 1, -1]}, True),
    "two_tower_traced": ("two_tower", {}, {"a1.weight": [-1, 1]}, True),
    "two_input_traced": ("two_input", {}, {"a1.weight": [-1, 1]}, True),
    "shared_fn_traced": ("shared_fn", {}, {"a1.weight": [-1, 1]}, True),
    "emb_sequential": ("emb", {}, {"emb.weight": [1, -1]}, False),
    "ernie_two_hints": ("ernie", {}, {"blocks.0.attn.qkv_w": [-1, 1],
                                      "blocks.0.ffn.w_in": [-1, 1]}, True),
    "ernie_row_hint": ("ernie", {}, {"blocks.1.ffn.w_out": [1, -1]}, True),
}


@pytest.mark.parametrize("case", sorted(COMPLETION_CASES))
def test_complete_shardings_matches_jax(case):
    kind, kw, hints, traced = COMPLETION_CASES[case]
    jm, jins, _ = build(kind, True, **kw)
    tm, tins, lin = build(kind, False, **kw)
    want = jauto.complete_shardings(jm, _mesh(True), hints,
                                    example_inputs=jins if traced else None)
    got = tauto.complete_shardings(tm, _mesh(False),
                                   {k: jax_dm_for_port(k, v, lin) for k, v in hints.items()},
                                   example_inputs=tins if traced else None)
    assert {k: port_spec_as_jax(k, v, lin) for k, v in got.items()} == \
        {k: _canon(tuple(v)) for k, v in want.items()}
    assert len(got) == len(dict(tm.named_parameters()))


def test_two_hints_shard_the_whole_encoder():
    """The JAX test's Megatron layout, read on the port's specs (ERNIE keeps
    the [in, out] layout in both packages)."""
    tm, tins, _ = build("ernie", False)
    specs = tauto.complete_shardings(
        tm, _mesh(False), {"blocks.0.attn.qkv_w": [-1, 1], "blocks.0.ffn.w_in": [-1, 1]},
        example_inputs=tins)
    for b in range(2):
        assert specs[f"blocks.{b}.attn.qkv_w"] == (None, "mp")
        assert specs[f"blocks.{b}.attn.qkv_b"] == ("mp",)
        assert specs[f"blocks.{b}.attn.proj_w"] == ("mp",)
        assert specs[f"blocks.{b}.ffn.w_in"] == (None, "mp")
        assert specs[f"blocks.{b}.ffn.b_in"] == ("mp",)
        assert specs[f"blocks.{b}.ffn.w_out"] == ("mp",)
    assert specs["blocks.0.attn.proj_b"] == ()
    assert specs["blocks.0.ln1.weight"] == ()
    assert specs["embed.word_emb"] == ()


@pytest.mark.parametrize("kind,mp", [("ernie", 4), ("ernie", 2), ("mlp", 2), ("two_tower", 2),
                                     ("conv", 4), ("stacked", 2), ("emb", 2)])
def test_mp_annotations_traced_match_jax(kind, mp):
    jm, jins, _ = build(kind, True)
    tm, tins, lin = build(kind, False)
    want = jcomp.mp_annotations_traced(jm, mp, 1, jins)
    got = tcomp.mp_annotations_traced(tm, mp, 1, tins)
    assert list(got) == list(want)   # the order feeds the cost model's pairing
    assert {k: jax_dm_for_port(k, v, lin) for k, v in got.items()} == want


def test_pipeline_stages_read_the_trace_like_jax():
    for kind, structural, traced in (("mlp", 1, 1), ("stacked", 4, 4), ("experts", 4, 1)):
        jm, jins, _ = build(kind, True)
        tm, tins, _ = build(kind, False)
        assert tauto._pipeline_stages(tm) == jauto._pipeline_stages(jm) == structural
        assert (tauto._pipeline_stages(tm, tcomp.trace_param_graph(tm, tins))
                == jauto._pipeline_stages(jm, jcomp.trace_param_graph(jm, jins)) == traced)
