"""``ops.device_graph.DeviceGraph`` against the JAX package, on the CPU.

- The device state from both builders (``from_graph_table``,
  ``from_arrays``) equals JAX's bit for bit: neighbour halves, CDF,
  kept degree, the cuckoo map.
- ``_draw``'s slot given the same uniforms equals JAX's (JAX's
  ``jax.random.uniform`` is monkeypatched, in this test only, to return
  them): tolerance 0, on graphs with ties in the CDF (zero weights).
- The port's own draws (a ``torch.Generator``; the streams differ from
  JAX's keys): samples stay on edges, walks follow edges and freeze at
  dead ends, unknown/isolated/zero-mass nodes mask out, the degree cap is
  counted, weights are respected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.device_graph import DeviceGraph as JDeviceGraph
from paddle_tpu.ps.graph_table import GraphTable as JGraphTable
from paddle_tpu_torch.ops import DeviceGraph
from paddle_tpu_torch.ps.device_hash import split_keys
from paddle_tpu_torch.ps.graph_table import GraphTable
from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("jax_native")


def _graph(cls, rng, n_nodes=64, n_edges=400):
    g = cls(shard_num=4)
    nodes = np.arange(1, n_nodes + 1, dtype=np.uint64)
    g.add_graph_node(nodes)
    src, dst = rng.choice(nodes, n_edges), rng.choice(nodes, n_edges)
    w = rng.uniform(0.5, 2.0, n_edges).astype(np.float32)
    w[::9] = 0.0
    g.add_edges(src, dst, w)
    adj = {}
    for s, d, ww in zip(src.tolist(), dst.tolist(), w):
        if ww > 0:
            adj.setdefault(s, set()).add(d)
    return g, nodes, adj


def _keys64(hi, lo):
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _assert_state_equal(t, j):
    for k in ("nbr_hi", "nbr_lo"):
        np.testing.assert_array_equal(t.state[k].numpy().view(np.uint32), np.asarray(j.state[k]))
    np.testing.assert_array_equal(t.state["cdf"].numpy(), np.asarray(j.state["cdf"]))
    np.testing.assert_array_equal(t.state["deg"].numpy(), np.asarray(j.state["deg"]))
    for k in ("hi", "lo", "row"):
        got = t.state["map"][k].numpy()
        np.testing.assert_array_equal(got, np.asarray(j.state["map"][k]).astype(got.dtype))
    assert int(t.state["map"]["seed"]) == int(np.asarray(j.state["map"]["seed"]))
    assert (t.max_deg, t.capped_rows) == (j.max_deg, j.capped_rows)


@pytest.mark.parametrize("max_deg", [4, 32])
def test_state_from_graph_table_bitwise_equal_jax(max_deg):
    jg, _, _ = _graph(JGraphTable, np.random.default_rng(0))
    tg, _, _ = _graph(GraphTable, np.random.default_rng(0))
    _assert_state_equal(DeviceGraph.from_graph_table(tg, max_deg, device="cpu"),
                        JDeviceGraph.from_graph_table(jg, max_deg))


def test_state_from_arrays_bitwise_equal_jax():
    rng = np.random.default_rng(1)
    n, d = 300, 8
    nodes = rng.choice(np.arange(1, 10 ** 6, dtype=np.uint64), n, replace=False)
    nbrs = rng.choice(nodes, (n, d)).astype(np.uint64)
    deg = rng.integers(0, 12, n).astype(np.int32)
    for weights in (None, rng.uniform(-0.5, 2.0, (n, d)).astype(np.float32)):
        _assert_state_equal(DeviceGraph.from_arrays(nodes, nbrs, deg, weights, device="cpu"),
                            JDeviceGraph.from_arrays(nodes, nbrs, deg, weights))


def test_draw_slots_equal_jax_given_the_same_uniforms(monkeypatch):
    jg, nodes, _ = _graph(JGraphTable, np.random.default_rng(2))
    tg, _, _ = _graph(GraphTable, np.random.default_rng(2))
    jd = JDeviceGraph.from_graph_table(jg, 16)
    td = DeviceGraph.from_graph_table(tg, 16, device="cpu")
    q = np.concatenate([nodes, np.asarray([777777], np.uint64)])
    hi, lo = split_keys(q)
    rng = np.random.default_rng(3)
    u = rng.random((len(q), 40)).astype(np.float32)
    u[:, :4] = [0.0, 0.5, 0.999999, 1e-7]
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(u))
    jrows = JDeviceGraph.lookup_rows(jd.state, jnp.asarray(hi), jnp.asarray(lo))
    want = np.asarray(JDeviceGraph._draw(jd.state, jax.random.key(0), jrows[:, None], u.shape))
    trows = DeviceGraph.lookup_rows(td.state, _t(hi), _t(lo))
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    got = DeviceGraph._slot_of(td.state, trows[:, None], torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sample_neighbors_stay_on_edges():
    g, nodes, adj = _graph(GraphTable, np.random.default_rng(4))
    dg = DeviceGraph.from_graph_table(g, max_deg=32, device="cpu")
    assert dg.capped_rows == 0
    q = np.random.default_rng(5).choice(nodes, 20, replace=False)
    hi, lo = split_keys(q)
    nh, nl, mask = DeviceGraph.sample_neighbors(dg.state, torch.Generator().manual_seed(0),
                                                _t(hi), _t(lo), 8)
    for i, nid in enumerate(q.tolist()):
        cand = adj.get(nid, set())
        if not cand:
            assert not mask[i].any()
            continue
        assert mask[i].all()
        assert set(_keys64(nh[i].numpy(), nl[i].numpy()).tolist()) <= cand


def test_unknown_isolated_and_zero_mass_nodes_mask_out():
    g, _, _ = _graph(GraphTable, np.random.default_rng(6))
    g.add_graph_node([999])
    dg = DeviceGraph.from_graph_table(g, max_deg=32, device="cpu")
    hi, lo = split_keys(np.asarray([999, 123456789], np.uint64))
    _, _, mask = DeviceGraph.sample_neighbors(dg.state, torch.Generator().manual_seed(1),
                                              _t(hi), _t(lo), 4)
    assert not mask.any()
    nodes = np.asarray([5], np.uint64)
    dz = DeviceGraph.from_arrays(nodes, np.asarray([[7, 8, 0, 0]], np.uint64),
                                 np.asarray([2], np.int32), weights=np.zeros((1, 4), np.float32),
                                 device="cpu")
    hi, lo = split_keys(nodes)
    gen = torch.Generator().manual_seed(0)
    assert not DeviceGraph.sample_neighbors(dz.state, gen, _t(hi), _t(lo), 4)[2].any()
    wh, wl, live = DeviceGraph.random_walk(dz.state, gen, _t(hi), _t(lo), 3)
    assert not live[0, 1:].any()
    np.testing.assert_array_equal(_keys64(wh.numpy(), wl.numpy())[0], 5)


@pytest.mark.parametrize("cls", [GraphTable, JGraphTable])
def test_walks_follow_edges_and_freeze_at_dead_ends(cls):
    """The path 1→2→3→4 with the sink 4, from either package's host table."""
    g = cls(shard_num=2)
    g.add_edges([1, 2, 3], [2, 3, 4])
    dg = DeviceGraph.from_graph_table(g, max_deg=4, device="cpu")
    hi, lo = split_keys(np.asarray([1, 4], np.uint64))
    wh, wl, live = DeviceGraph.random_walk(dg.state, torch.Generator().manual_seed(0),
                                           _t(hi), _t(lo), 5)
    walks, live = _keys64(wh.numpy(), wl.numpy()), live.numpy()
    assert wh.dtype == torch.int64 and walks.shape == live.shape == (2, 6)
    np.testing.assert_array_equal(walks[0, :4], [1, 2, 3, 4])
    assert live[0, :4].all() and not live[0, 4:].any()
    np.testing.assert_array_equal(walks[0, 4:], 4)
    np.testing.assert_array_equal(walks[1], 4)
    assert live[1, 0] and not live[1, 1:].any()


def test_weighted_sampling_respects_weights():
    g = GraphTable(shard_num=2)
    g.add_edges([1, 1], [2, 3], [9.0, 1.0])
    dg = DeviceGraph.from_graph_table(g, max_deg=4, device="cpu")
    hi, lo = split_keys(np.asarray([1], np.uint64))
    nh, nl, _ = DeviceGraph.sample_neighbors(dg.state, torch.Generator().manual_seed(2),
                                             _t(hi), _t(lo), 2000)
    frac2 = (_keys64(nh[0].numpy(), nl[0].numpy()) == 2).mean()
    assert 0.85 < frac2 < 0.95, frac2


def test_degree_cap_is_counted_not_silent():
    g = GraphTable(shard_num=2)
    g.add_edges(np.ones(10, np.int64), np.arange(2, 12))
    dg = DeviceGraph.from_graph_table(g, max_deg=4, device="cpu")
    assert dg.capped_rows == 1
    hi, lo = split_keys(np.asarray([1], np.uint64))
    nh, nl, _ = DeviceGraph.sample_neighbors(dg.state, torch.Generator().manual_seed(3),
                                             _t(hi), _t(lo), 16)
    assert set(_keys64(nh[0].numpy(), nl[0].numpy()).tolist()) <= {2, 3, 4, 5}
    assert DeviceGraph.from_arrays(np.asarray([1], np.uint64), np.asarray([[2, 3]], np.uint64),
                                   np.asarray([9], np.int32), device="cpu").capped_rows == 1
