"""``ps.graph_client.DistGraphClient`` over the port's PS servers, against
the JAX package's local ``GraphTable`` (the oracle of JAX's own
``tests/test_dist_graph.py``) and JAX's ``DistGraphClient`` routing.

Three port ``NativePsServer``s hold the graph stores (the graph-store
commands of ``csrc/ps_service.cc``). Structure, degrees and features
must equal the oracle exactly; sampled neighbours must be true
neighbours, as many as the oracle's samplable degree allows (the
servers sample with their own generator, so draws are not compared
value for value). The node → server route is JAX's ``_route`` exactly."""

import numpy as np
import pytest

from paddle_tpu.ps.graph_client import DistGraphClient as JDistGraphClient
from paddle_tpu.ps.graph_table import GraphTable as JGraphTable
from paddle_tpu_torch.core.enforce import NotFoundError
from paddle_tpu_torch.ps import rpc
from paddle_tpu_torch.ps.graph_client import DistGraphClient
from paddle_tpu_torch.ps.graph_table import GraphTable

N_SERVERS = 3
FEAT_DIM = 5


@pytest.fixture
def cluster():
    servers = [rpc.NativePsServer(n_trainers=1) for _ in range(N_SERVERS)]
    client = rpc.RpcPsClient([f"127.0.0.1:{s.port}" for s in servers])
    yield client
    client.close()
    for s in servers:
        s.close()


def _build(graph_like, rng):
    nodes = np.arange(1, 201, dtype=np.uint64)
    feats = rng.normal(size=(len(nodes), FEAT_DIM)).astype(np.float32)
    graph_like.add_graph_node(nodes, feats)
    src, dst = rng.choice(nodes, 1200), rng.choice(nodes, 1200)
    w = rng.uniform(0.1, 2.0, 1200).astype(np.float32)
    w[::7] = 0.0
    graph_like.add_edges(src, dst, w)
    return nodes, feats, src, dst, w


def test_route_is_jax_route(cluster):
    dist = DistGraphClient(cluster, table_id=3)
    ids = np.random.default_rng(0).integers(0, 2 ** 63, 1000, dtype=np.uint64)
    jax_view = JDistGraphClient.__new__(JDistGraphClient)
    jax_view._cli = cluster          # only num_servers is read
    np.testing.assert_array_equal(dist._route(ids), JDistGraphClient._route(jax_view, ids))


def test_partitioned_graph_matches_jax_oracle(cluster):
    dist = DistGraphClient(cluster, table_id=7)
    nodes, feats, src, dst, w = _build(dist, np.random.default_rng(0))
    local = JGraphTable(shard_num=4)
    _build(local, np.random.default_rng(0))
    assert dist.node_count == local.node_count == len(nodes)
    assert dist.edge_count == local.edge_count == len(src)
    q = np.random.default_rng(1).choice(nodes, 64, replace=False)
    np.testing.assert_array_equal(dist.get_node_degree(q), local.get_node_degree(q))
    np.testing.assert_array_equal(dist.get_node_feat(q, FEAT_DIM), local.get_node_feat(q, FEAT_DIM))
    adj, wpos, cnt, wcnt = {}, {}, {}, {}
    for s, d, ww in zip(src.tolist(), dst.tolist(), w):
        adj.setdefault(s, set()).add(d)
        cnt[s] = cnt.get(s, 0) + 1
        if ww > 0:
            wpos.setdefault(s, set()).add(d)
            wcnt[s] = wcnt.get(s, 0) + 1
    for weighted in (True, False):
        k = 6
        nbrs, mask = dist.sample_neighbors(q, k, weighted=weighted)
        lnbrs, lmask = local.sample_neighbors(q, k, weighted=weighted)
        assert nbrs.shape == mask.shape == lnbrs.shape == (len(q), k)
        assert nbrs.dtype == lnbrs.dtype and mask.dtype == lmask.dtype
        np.testing.assert_array_equal(mask.sum(axis=1), lmask.sum(axis=1))
        for i, n in enumerate(q.tolist()):
            cand = (wpos if weighted else adj).get(n, set())
            assert set(nbrs[i][mask[i]].tolist()) <= cand
            assert mask[i].sum() == min(k, (wcnt if weighted else cnt).get(n, 0))
    samp = dist.sample_nodes(300)
    assert len(samp) == 300 and set(samp.tolist()) <= set(nodes.tolist())
    assert len({int(s) % N_SERVERS for s in samp}) == N_SERVERS


def test_sample_nodes_permutation_and_zero_weight_fallback(cluster):
    dist = DistGraphClient(cluster, table_id=13)
    nodes = np.arange(1, 61, dtype=np.uint64)
    dist.add_graph_node(nodes)
    dist.add_edges([7, 7, 7], [8, 9, 10], [0.0, 0.0, 0.0])
    assert sorted(dist.sample_nodes(len(nodes)).tolist()) == nodes.tolist()
    nbrs, mask = dist.sample_neighbors([7], 2, weighted=True)
    local = JGraphTable(shard_num=2)
    local.add_graph_node(nodes)
    local.add_edges([7, 7, 7], [8, 9, 10], [0.0, 0.0, 0.0])
    assert mask[0].sum() == local.sample_neighbors([7], 2, weighted=True)[1][0].sum() == 2
    assert set(nbrs[0][mask[0]].tolist()) <= {8, 9, 10}


def test_set_node_feat_and_missing_node(cluster):
    dist = DistGraphClient(cluster, table_id=9)
    nodes = np.arange(10, 20, dtype=np.uint64)
    dist.add_graph_node(nodes)
    new = np.random.default_rng(1).normal(size=(len(nodes), FEAT_DIM)).astype(np.float32)
    dist.set_node_feat(nodes, new)
    np.testing.assert_array_equal(dist.get_node_feat(nodes, FEAT_DIM), new)
    with pytest.raises(NotFoundError):
        dist.set_node_feat(np.asarray([999], np.uint64), np.zeros((1, FEAT_DIM), np.float32))


def test_two_hop_loop_swaps_local_for_distributed(cluster, tmp_path):
    """A sampling loop written against the graph table runs unchanged on
    the distributed client, in the same shapes (JAX
    ``test_graph_trainer_swaps_local_for_distributed``); the edges load
    from a file through ``load_edges``."""
    rng = np.random.default_rng(3)
    nodes = np.arange(1, 101, dtype=np.uint64)
    src, dst = rng.choice(nodes, 400), rng.choice(nodes, 400)
    path = tmp_path / "edges.txt"
    path.write_text("".join(f"{s}\t{d}\n" for s, d in zip(src, dst)))

    def two_hop(g):
        seeds = np.asarray([1, 2, 3], np.uint64)
        n1, m1 = g.sample_neighbors(seeds, 4, weighted=False)
        n2, m2 = g.sample_neighbors(n1.reshape(-1), 4, weighted=False)
        return n1.shape, m1.shape, n2.shape, m2.shape, n1.dtype, m2.dtype

    shapes = []
    for g in (JGraphTable(shard_num=2), GraphTable(shard_num=2),
              DistGraphClient(cluster, table_id=11)):
        assert g.load_edges(str(path)) == 400
        shapes.append(two_hop(g))
    assert shapes[0] == shapes[1] == shapes[2]
