"""``ps.graph_table`` (``GraphTable``, ``parse_edge_file``) against the JAX
package, on the CPU.

Both tables get the same numpy-seeded graph and the same seed; every
query (degrees, features, weighted and uniform neighbour sampling, node
sampling) must return the JAX package's arrays bit for bit (tolerance 0:
the same host numpy calls in the same order)."""

import numpy as np
import pytest

from paddle_tpu.core.enforce import NotFoundError as JNotFound
from paddle_tpu.ps import graph_table as jgt
from paddle_tpu_torch.core.enforce import NotFoundError
from paddle_tpu_torch.ps import GraphTable
from paddle_tpu_torch.ps import graph_table as tgt

FEAT = 3


def _fill(table, seed):
    rng = np.random.default_rng(seed)
    nodes = np.arange(1, 81, dtype=np.uint64)
    table.add_graph_node(nodes, rng.normal(size=(len(nodes), FEAT)).astype(np.float32))
    src, dst = rng.choice(nodes, 500), rng.choice(nodes, 500)
    w = rng.uniform(0.1, 2.0, 500).astype(np.float32)
    w[::5] = 0.0                       # zero-weight edges: unsamplable when weighted
    table.add_edges(src, dst, w)
    table.add_graph_node([999])        # isolated
    return nodes


def _pair(seed=0, shard_num=4):
    j, t = jgt.GraphTable(shard_num=shard_num, seed=seed), GraphTable(shard_num=shard_num,
                                                                      seed=seed)
    nodes = _fill(j, 7)
    _fill(t, 7)
    return j, t, nodes


def test_package_export():
    assert GraphTable is tgt.GraphTable


def test_structure_degrees_and_features_equal_jax():
    j, t, nodes = _pair()
    assert (t.node_count, t.edge_count) == (j.node_count, j.edge_count)
    np.testing.assert_array_equal(t.all_nodes(), j.all_nodes())
    q = np.concatenate([nodes[::3], np.asarray([999, 12345], np.uint64)])
    np.testing.assert_array_equal(t.get_node_degree(q), j.get_node_degree(q))
    np.testing.assert_array_equal(t.get_node_feat(q, FEAT + 1), j.get_node_feat(q, FEAT + 1))


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("seed", [0, 3])
def test_neighbor_sampling_bitwise_equal_jax(weighted, seed):
    j, t, nodes = _pair(seed)
    q = np.concatenate([nodes, np.asarray([999, 5555], np.uint64)])
    for k in (1, 4, 9):
        jn, jm = j.sample_neighbors(q, k, weighted=weighted)
        tn, tm = t.sample_neighbors(q, k, weighted=weighted)
        np.testing.assert_array_equal(tn, jn)
        np.testing.assert_array_equal(tm, jm)
        assert tn.dtype == np.int64 and tm.dtype == bool and tn.shape == (len(q), k)


def test_sample_nodes_bitwise_equal_jax():
    j, t, _ = _pair(5)
    for size in (10, 81, 200):
        np.testing.assert_array_equal(t.sample_nodes(size), j.sample_nodes(size))


def test_set_node_feat_and_missing_node():
    j, t, nodes = _pair()
    new = np.full((2, FEAT), 4.5, np.float32)
    j.set_node_feat(nodes[:2], new)
    t.set_node_feat(nodes[:2], new)
    np.testing.assert_array_equal(t.get_node_feat(nodes[:3], FEAT),
                                  j.get_node_feat(nodes[:3], FEAT))
    with pytest.raises(JNotFound):
        j.set_node_feat([4242], new[:1])
    with pytest.raises(NotFoundError):
        t.set_node_feat([4242], new[:1])


def test_edge_and_node_files_parse_as_jax(tmp_path):
    edges = tmp_path / "edges.txt"
    edges.write_text("1\t2\t0.5\n2 3\n\n3\t1\t2.0\nbad\n4\t4\n")
    nodes = tmp_path / "nodes.txt"
    nodes.write_text("1 0.1 0.2\n2\n7 1.5 -2\n")
    assert tgt.parse_edge_file(str(edges)) == jgt.parse_edge_file(str(edges))
    assert tgt.parse_edge_file(str(edges), True) == jgt.parse_edge_file(str(edges), True)
    j, t = jgt.GraphTable(shard_num=2, seed=1), GraphTable(shard_num=2, seed=1)
    for g in (j, t):
        assert g.load_edges(str(edges), reverse=True) == 4
        assert g.load_nodes(str(nodes)) == 3
    np.testing.assert_array_equal(t.all_nodes(), j.all_nodes())
    q = t.all_nodes()
    np.testing.assert_array_equal(t.get_node_feat(q, 2), j.get_node_feat(q, 2))
    np.testing.assert_array_equal(t.sample_neighbors(q, 3)[0], j.sample_neighbors(q, 3)[0])
