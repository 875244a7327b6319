"""The port's mesh of several axes, its topology arithmetic and its
axis-named collectives, against the JAX package on the CPU.

The JAX side runs each collective under ``shard_map`` on the 8-device
CPU mesh of the same shape (rank r's value is block r of the input, in
the mesh's device order); the port runs it in ``run_ranks`` over its
logical ranks. Sums run in rank order in the port and in XLA's order in
JAX; the inputs are small integers in f32, so every sum is exact and
every comparison here is exact too.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from paddle_tpu.core import mesh as jmesh
from paddle_tpu.ops import collectives as jcoll
from paddle_tpu.parallel.topology import CommunicateTopology as JTopo
from paddle_tpu.parallel.topology import HybridCommunicateGroup as JHcg
from paddle_tpu_torch.core.enforce import InvalidArgumentError, PreconditionNotMetError
from paddle_tpu_torch.core import mesh as tmesh
from paddle_tpu_torch.core.mesh import make_mesh
from paddle_tpu_torch.ops import collectives as coll
from paddle_tpu_torch.parallel.topology import CommunicateTopology, HybridCommunicateGroup

LAYOUTS = [{"dp": 2, "cp": 4}, {"dp": 2, "mp": 4}, {"dp": 2, "ep": 4},
           {"dp": 1, "pp": 2, "cp": 2, "mp": 2}, {"dp": 2, "pp": 2, "cp": 1, "mp": 2}]


@pytest.mark.parametrize("shape", LAYOUTS, ids=lambda s: "x".join(f"{k}{v}" for k, v in s.items()))
def test_mesh_ranks_are_row_major_like_jax(shape):
    m = make_mesh(shape, device="cpu")
    jm = jmesh.make_mesh(shape)
    ids = np.vectorize(lambda d: d.id)(jm.devices)      # device r sits at coords(r)
    assert m.size == ids.size and m.axis_names == tuple(shape)
    for r in range(m.size):
        c = m.coords(r)
        assert ids[tuple(c[a] for a in shape)] == jax.devices()[r].id
        assert m.rank(**c) == r


@pytest.mark.parametrize("shape", LAYOUTS, ids=lambda s: "x".join(f"{k}{v}" for k, v in s.items()))
def test_topology_matches_jax(shape):
    names, sizes = list(shape), list(shape.values())
    t, jt = CommunicateTopology(names, sizes), JTopo(names, sizes)
    assert CommunicateTopology.from_mesh(make_mesh(shape, device="cpu")).get_hybrid_group_names() \
        == jt.get_hybrid_group_names()
    assert t.world_size() == jt.world_size()
    for r in range(t.world_size()):
        assert t.get_coord(r) == jt.get_coord(r)
        assert t.get_rank(**t.get_coord(r)) == jt.get_rank(**jt.get_coord(r))
        g, jg = HybridCommunicateGroup(t, r), JHcg(jt, r)
        for fn in ("get_data_parallel_rank", "get_data_parallel_group",
                   "get_model_parallel_rank", "get_model_parallel_world_size",
                   "get_model_parallel_group", "get_stage_id", "get_pipe_parallel_group",
                   "is_first_stage", "is_last_stage"):
            assert getattr(g, fn)() == getattr(jg, fn)(), (fn, r)
    for a in names:
        assert t.get_comm_list(a) == jt.get_comm_list(a)
        assert t.get_axis_list(a, 0) == jt.get_axis_list(a, 0)


def test_make_mesh_checks():
    with pytest.raises(InvalidArgumentError, match="positive"):
        make_mesh({"dp": 2, "mp": 0}, device="cpu")
    m = make_mesh({"dp": 2, "mp": 4}, device="cpu")
    with pytest.raises(InvalidArgumentError, match="out of range"):
        m.coords(8)
    with pytest.raises(InvalidArgumentError, match="every axis"):
        m.rank(dp=1)


# -- collectives ---------------------------------------------------------------

MESH = {"dp": 2, "cp": 4}
N = 6


def _inputs(seed=0):
    """[8, 4, N] small integers in f32: rank r's value is block r."""
    rng = np.random.default_rng(seed)
    return rng.integers(-8, 8, size=(8, 4, N)).astype(np.float32)


def _jax_per_rank(fn, x):
    jm = jmesh.make_mesh(MESH)
    spec = P(("dp", "cp"))
    out = jax.jit(shard_map(lambda a: fn(a[0])[None], mesh=jm, in_specs=spec,
                            out_specs=spec))(jnp.asarray(x))
    return np.asarray(out)


def _port_per_rank(fn, x):
    m = make_mesh(MESH, device="cpu")
    return np.stack([t.numpy() for t in
                     coll.run_ranks(m, lambda r: fn(torch.from_numpy(x[r])))])


CASES = {
    "psum_cp": (lambda a: jax.lax.psum(a, "cp"), lambda a: coll.psum(a, "cp")),
    "psum_dp_cp": (lambda a: jax.lax.psum(a, ("dp", "cp")), lambda a: coll.psum(a, ("cp", "dp"))),
    "pmax_cp": (lambda a: jax.lax.pmax(a, "cp"), lambda a: coll.pmax(a, "cp")),
    "all_gather_cp": (lambda a: jcoll.all_gather(a, "cp", concat_axis=1),
                      lambda a: coll.all_gather(a, "cp", concat_axis=1)),
    "all_to_all_cp": (lambda a: jcoll.all_to_all(a, "cp", split_axis_=0, concat_axis=1),
                      lambda a: coll.all_to_all(a, "cp", split_axis_=0, concat_axis=1)),
    "all_to_all_dp": (lambda a: jcoll.all_to_all(a, "dp", split_axis_=1, concat_axis=0),
                      lambda a: coll.all_to_all(a, "dp", split_axis_=1, concat_axis=0)),
    "shift_cp": (lambda a: jcoll.shift(a, "cp", 1), lambda a: coll.shift(a, "cp", 1)),
    "shift_cp_back": (lambda a: jcoll.shift(a, "cp", -1), lambda a: coll.shift(a, "cp", -1)),
    "ppermute_partial": (lambda a: jcoll.ppermute(a, "cp", [(0, 2), (3, 1)]),
                         lambda a: coll.ppermute(a, "cp", [(0, 2), (3, 1)])),
    "broadcast_cp": (lambda a: jcoll.broadcast(a, "cp", root=2),
                     lambda a: coll.broadcast(a, "cp", root=2)),
    "axis_index": (lambda a: a * 0 + jax.lax.axis_index("cp") * 10 + jax.lax.axis_index("dp"),
                   lambda a: a * 0 + coll.axis_index("cp") * 10 + coll.axis_index("dp")),
    "reduce_cp_root2": (lambda a: jcoll.reduce(a, "cp", root=2),
                        lambda a: coll.reduce(a, "cp", root=2)),
    "reduce_dp_max": (lambda a: jcoll.reduce(a, "dp", root=1, op=jcoll.ReduceOp.MAX),
                      lambda a: coll.reduce(a, "dp", root=1, op=coll.ReduceOp.MAX)),
    "reduce_cp_min": (lambda a: jcoll.reduce(a, "cp", op=jcoll.ReduceOp.MIN),
                      lambda a: coll.reduce(a, "cp", op=coll.ReduceOp.MIN)),
    "reduce_cp_prod": (lambda a: jcoll.reduce(a, "cp", root=3, op=jcoll.ReduceOp.PROD),
                       lambda a: coll.reduce(a, "cp", root=3, op=coll.ReduceOp.PROD)),
    "reduce_cp_avg": (lambda a: jcoll.reduce(a, "cp", root=1, op=jcoll.ReduceOp.AVG),
                      lambda a: coll.reduce(a, "cp", root=1, op=coll.ReduceOp.AVG)),
    "split_axis_cp": (lambda a: jcoll.split_axis(a, "cp", dim=0),
                      lambda a: coll.split_axis(a, "cp", dim=0)),
    "split_axis_dp_last": (lambda a: jcoll.split_axis(a, "dp"),
                           lambda a: coll.split_axis(a, "dp")),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_axis_collectives_match_shard_map(name):
    jfn, tfn = CASES[name]
    x = _inputs()
    np.testing.assert_array_equal(_port_per_rank(tfn, x), _jax_per_rank(jfn, x))


def test_collective_gradients_are_the_autograd_of_the_moves():
    """One backward through the ranks' collectives: the gradient of a
    psum'd, shifted, all-to-all'd value is the same move's transpose."""
    x = torch.from_numpy(_inputs(1)).requires_grad_(True)
    m = make_mesh(MESH, device="cpu")

    def f(r):
        y = coll.all_to_all(coll.shift(x[r] * (r + 1), "cp", 1), "cp", 0, 1)
        return (coll.psum(y, "dp") ** 2).sum()

    total = sum(coll.run_ranks(m, f))
    total.backward()

    def ref(xx):
        out = 0.0
        blocks = {}
        for r in range(8):
            blocks[r] = xx[r] * (r + 1)
        shifted = {}
        for dp in range(2):
            for c in range(4):
                shifted[dp * 4 + (c + 1) % 4] = blocks[dp * 4 + c]
        a2a = {}
        for dp in range(2):
            tiles = [shifted[dp * 4 + c].chunk(4, 0) for c in range(4)]
            for s in range(4):
                a2a[dp * 4 + s] = torch.cat([tiles[c][s] for c in range(4)], 1)
        for r in range(8):
            c = r % 4
            out = out + ((a2a[c] + a2a[4 + c]) ** 2).sum()
        return out

    xr = torch.from_numpy(_inputs(1)).requires_grad_(True)
    ref(xr).backward()
    assert torch.equal(x.grad, xr.grad)


def test_failing_rank_aborts_the_others():
    m = make_mesh(MESH, device="cpu")
    before = threading.active_count()

    def f(r):
        if r == 5:
            raise ValueError("rank five fails")
        return coll.psum(torch.ones(2), ("dp", "cp"))

    with pytest.raises(ValueError, match="rank five fails") as e:
        coll.run_ranks(m, f)
    assert "rank 5" in "".join(getattr(e.value, "__notes__", []))
    assert threading.active_count() <= before        # every rank's thread ended


def test_diverging_ranks_raise_instead_of_hanging():
    m = make_mesh(MESH, device="cpu")

    def f(r):
        if coll.axis_index("cp") != 3:        # rank cp=3 never joins
            return coll.psum(torch.ones(2), "cp")
        return None

    with pytest.raises(PreconditionNotMetError, match="returned without joining"):
        coll.run_ranks(m, f)
    with pytest.raises(PreconditionNotMetError, match="timed out"):
        coll.run_ranks(m, lambda r: coll.psum(torch.ones(1), "cp") if r != 0 else
                       (threading.Event().wait(1.0), coll.psum(torch.ones(1), "dp")),
                       timeout=0.2)


def test_collectives_outside_a_run_raise():
    with pytest.raises(InvalidArgumentError, match="run_ranks"):
        coll.psum(torch.ones(1), "mp")
    assert not coll.axis_active("mp")
    m = make_mesh({"mp": 2}, device="cpu")
    got = coll.run_ranks(m, lambda r: (coll.axis_active("mp"), coll.axis_active("cp")))
    assert got == [(True, False), (True, False)]


def test_split_axis_that_does_not_divide_raises():
    m = make_mesh(MESH, device="cpu")
    with pytest.raises(InvalidArgumentError, match="not divisible"):
        coll.run_ranks(m, lambda r: coll.split_axis(torch.zeros(4, N), "cp", dim=1))


def test_barrier_waits_for_the_group():
    """``barrier(axis)``: no rank leaves before every rank of its group has
    arrived; it returns None, as the JAX package's (a no-op there: any
    collective of a compiled program is one)."""
    m = make_mesh(MESH, device="cpu")
    arrived, mu = [0, 0], threading.Lock()

    def f(r):
        with mu:
            arrived[coll.axis_index("dp")] += 1
        out = coll.barrier("cp")
        with mu:
            return out, arrived[coll.axis_index("dp")]

    assert coll.run_ranks(m, f) == [(None, 4)] * 8
    assert jcoll.barrier("cp") is None
    with pytest.raises(InvalidArgumentError, match="run_ranks"):
        coll.barrier("cp")


def test_hybrid_mesh_helpers_match_jax():
    """``make_hybrid_mesh``, ``use_mesh``/``current_mesh``, and
    ``named_sharding``/``replicated`` (the port's layout tuples: JAX's
    ``PartitionSpec`` entries)."""
    assert tmesh.HYBRID_AXES == jmesh.HYBRID_AXES
    for sizes in (dict(dp=2, mp=4), dict(pp=2, cp=2, mp=2), dict(dp=2, sharding=2, ep=2)):
        m, jm = tmesh.make_hybrid_mesh(**sizes, device="cpu"), jmesh.make_hybrid_mesh(**sizes)
        assert m.shape == dict(jm.shape) and m.axis_names == tuple(jm.axis_names)
        for spec in ((), ("dp", None), (None, "mp"), (("dp", "sharding"), None, "mp")):
            assert tmesh.named_sharding(m, *spec) == tuple(jmesh.named_sharding(jm, *spec).spec)
        assert tmesh.replicated(m) == tuple(jmesh.replicated(jm).spec) == ()
        with pytest.raises(InvalidArgumentError, match="no axis 'xx'"):
            tmesh.named_sharding(m, "dp", "xx")
    a, b = make_mesh({"dp": 8}, device="cpu"), make_mesh({"mp": 2}, device="cpu")
    assert tmesh.current_mesh() is None
    with tmesh.use_mesh(a) as got:
        assert got is a and tmesh.current_mesh() is a
        with tmesh.use_mesh(b):
            assert tmesh.current_mesh() is b
        assert tmesh.current_mesh() is a
    assert tmesh.current_mesh() is None
