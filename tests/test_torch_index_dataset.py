"""The port's tree index (``paddle_tpu_torch.data.index_dataset``) and
TDM's batch sampler against the JAX package's, on the CPU: tree codes,
paths, layers and the sampler's outputs for the same seed are equal
exactly (the same numpy calls in the same order)."""

import numpy as np
import pytest

from paddle_tpu.data import index_dataset as jid
from paddle_tpu.models.tdm import tdm_sample_batch as jax_sample_batch
from paddle_tpu_torch.core.enforce import EnforceNotMet, NotFoundError
from paddle_tpu_torch.data import index_dataset as tid
from paddle_tpu_torch.models.tdm import tdm_sample_batch


@pytest.mark.parametrize("n,branch", [(1, 2), (16, 2), (21, 3), (100, 4), (8192, 2)])
def test_tree_structure_matches_jax(n, branch):
    items = list(np.random.default_rng(n).permutation(n * 3)[:n])
    j, t = jid.TreeIndex(items, branch), tid.TreeIndex(items, branch)
    assert (t.height, t.total_node_num(), t.emb_size()) == \
        (j.height, j.total_node_num(), j.emb_size())
    for level in range(t.height + 1):
        np.testing.assert_array_equal(t.get_layer_codes(level), j.get_layer_codes(level))
    for i in items[:50]:
        np.testing.assert_array_equal(t.get_travel_codes(i), j.get_travel_codes(i))
        leaf = int(t.get_travel_codes(i)[0])
        assert t.get_ancestor(leaf, 2) == j.get_ancestor(leaf, 2)
    codes = np.arange(t.total_node_num() + 3)
    assert t.get_items_of_codes(codes) == j.get_items_of_codes(codes)


def test_tree_errors():
    t = tid.TreeIndex([3, 5, 7], branch=2)
    with pytest.raises(NotFoundError):
        t.get_travel_codes(4)
    with pytest.raises(EnforceNotMet):
        t.get_layer_codes(t.height + 1)
    with pytest.raises(EnforceNotMet):
        tid.TreeIndex([], branch=2)
    with pytest.raises(EnforceNotMet):
        tid.TreeIndex([1], branch=1)
    with pytest.raises(EnforceNotMet):
        tid.LayerWiseSampler(t, layer_counts=[1], seed=0)


@pytest.mark.parametrize("counts,start", [(None, 1), ("two", 1), (None, 2), ("big", 1)])
def test_sampler_matches_jax_bitwise(counts, start):
    items = list(range(40))
    j, t = jid.TreeIndex(items, 2), tid.TreeIndex(items, 2)
    L = t.height - start + 1
    lc = {None: [1] * L, "two": [2] * L, "big": [100] * L}[counts]
    js = jid.LayerWiseSampler(j, lc, seed=11, start_sample_layer=start)
    ts = tid.LayerWiseSampler(t, lc, seed=11, start_sample_layer=start)
    rng = np.random.default_rng(3)
    for _ in range(3):  # the generator's stream carries over between calls
        targets = rng.integers(0, 40, 9)
        for a, b in zip(ts.sample(targets), js.sample(targets)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_tdm_sample_batch_matches_jax():
    """tests/test_tdm.py's sampler-shape test, held against JAX's output."""
    tree, jtree = tid.TreeIndex(list(range(16)), 2), jid.TreeIndex(list(range(16)), 2)
    sampler = tid.LayerWiseSampler(tree, [1] * tree.height, seed=0)
    jsampler = jid.LayerWiseSampler(jtree, [1] * jtree.height, seed=0)
    targets = np.array([0, 5, 9])
    codes, labels = tdm_sample_batch(sampler, targets)
    jcodes, jlabels = jax_sample_batch(jsampler, targets)
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(labels, jlabels)
    assert codes.shape == labels.shape == (3, 2 * tree.height)
    assert labels.dtype == np.float32 and (labels.sum(axis=1) == tree.height).all()
    for b, item in enumerate(targets):
        path = set(int(x) for x in tree.get_travel_codes(item))
        assert set(int(c) for c, l in zip(codes[b], labels[b]) if l == 1) <= path
