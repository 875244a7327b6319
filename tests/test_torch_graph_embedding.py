"""DeepWalk (``models.graph_embedding``) against the JAX package, on the CPU.

The step: both packages get the same host tables (``init_node_embeddings``
from one numpy seed; the port's rows then take the JAX table's, whose
embed_w init draws from its own shard generators), the same pass, the
same walks and the same negative indices — injected by monkeypatching
``DeviceGraph.random_walk`` (both packages) and the negative draw (JAX's ``jax.random.randint``, the port's
``_negative_indices``) in the test only, since the draws' streams differ
(``jax.random`` keys against a ``torch.Generator``). The JAX step is
compiled with XLA's algebraic simplifier off (it folds the push's sums
into scatter-adds). Tolerances: the loss rtol 1e-6, every cache column
rtol 1e-5 / atol 1e-6 after two steps (the SGNS products reduce in
another order; Adam's moments of near-zero gradients sit near 1e-7).

The rest are the port counterparts of JAX's ``tests/test_graph_embedding.py``
(communities, dead ends under Adam, the SSD table) with the port's own
draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import graph_embedding as jge
from paddle_tpu.ops.device_graph import DeviceGraph as JDeviceGraph
from paddle_tpu.ps import accessor as jacc
from paddle_tpu.ps import embedding_cache as jec
from paddle_tpu.ps import sgd_rule as jsgd
from paddle_tpu.ps import table as jtab
from paddle_tpu.ps.graph_table import GraphTable as JGraphTable
from paddle_tpu_torch.models import DeepWalkConfig, make_deepwalk_train_step
from paddle_tpu_torch.models import graph_embedding as tge
from paddle_tpu_torch.ops.device_graph import DeviceGraph
from paddle_tpu_torch.ps import accessor as tacc
from paddle_tpu_torch.ps import embedding_cache as tec
from paddle_tpu_torch.ps import sgd_rule as tsgd
from paddle_tpu_torch.ps import table as ttab
from paddle_tpu_torch.ps.graph_table import GraphTable
from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("jax_native")

LOSS_RTOL = 1e-6
CACHE_TOL = dict(rtol=1e-5, atol=1e-6)


def _graph(cls, k=6):
    """Two k-cliques joined by one bridge, a path 2k → 2k+1 → 2k+2 (a
    sink) and the isolated node 2k+3."""
    g = cls(shard_num=4, seed=0)
    src, dst = [], []
    for base in (0, k):
        for i in range(k):
            for j in range(k):
                if i != j:
                    src.append(base + i)
                    dst.append(base + j)
    src += [0, k, 2 * k, 2 * k + 1]
    dst += [k, 0, 2 * k + 1, 2 * k + 2]
    g.add_graph_node(list(range(2 * k + 4)))
    g.add_edges(src, dst)
    return g, np.arange(2 * k + 4, dtype=np.uint64)


def _pair(rule="adagrad", dim=8, cap=1 << 7):
    """The JAX and port (table, cache, cache config) from one seed."""
    out = []
    for acc_mod, sgd_mod, tab_mod, ec_mod, ge, kw in (
            (jacc, jsgd, jtab, jec, jge, {}), (tacc, tsgd, ttab, tec, tge, {"device": "cpu"})):
        sgd = sgd_mod.SGDRuleConfig(learning_rate=0.3, initial_g2sum=1.0)
        acc = acc_mod.AccessorConfig(embedx_dim=dim, embedx_threshold=0.0, sgd=sgd,
                                     embed_sgd_rule=rule, embedx_sgd_rule=rule)
        table = tab_mod.MemorySparseTable(tab_mod.TableConfig(shard_num=4, accessor_config=acc))
        cfg = ec_mod.CacheConfig(capacity=cap, embedx_dim=dim, embedx_threshold=0.0, sgd=sgd,
                                 embed_rule=rule, embedx_rule=rule)
        _, nodes = _graph(GraphTable)
        keys = np.concatenate([ge.tag_center(nodes), ge.tag_context(nodes)])
        ge.init_node_embeddings(table, nodes, np.random.default_rng(11), scale=0.1)
        if out:   # the port's rows: the JAX table's (their embed_w draws differ)
            table.import_full(keys, out[0][0].export_full(keys)[0])
        cache = ec_mod.HbmEmbeddingCache(table, cfg, device_map=True, **kw)
        cache.begin_pass(keys)
        out.append((table, cache, cfg))
    return out


def _walks(seed, B, L):
    """Real walks of the port's walker (dead ends included) as numpy."""
    g, _ = _graph(GraphTable)
    dg = DeviceGraph.from_graph_table(g, max_deg=8, device="cpu")
    starts = torch.from_numpy(np.random.default_rng(seed).integers(0, 16, B))
    wh, wl, live = DeviceGraph.random_walk(dg.state, torch.Generator().manual_seed(seed),
                                           torch.zeros_like(starts), starts, L)
    return wh.numpy(), wl.numpy(), live.numpy(), starts.numpy()


@pytest.mark.parametrize("rule", ["adagrad", "adam"])
def test_step_loss_and_cache_match_jax_on_injected_draws(monkeypatch, rule):
    (jt, jcache, jcfg), (tt, tcache, tcfg) = _pair(rule)
    for k in jcache.state:
        np.testing.assert_array_equal(tcache.state[k].numpy(), np.asarray(jcache.state[k]))
    B, L, W, K = 16, 5, 2, 3
    cfg_j = jge.DeepWalkConfig(walk_len=L, window=W, negatives=K, embed_dim=8)
    cfg_t = DeepWalkConfig(walk_len=L, window=W, negatives=K, embed_dim=8)
    jg, nodes = _graph(JGraphTable)
    tg, _ = _graph(GraphTable)
    jd, td = JDeviceGraph.from_graph_table(jg, 8), DeviceGraph.from_graph_table(tg, 8,
                                                                                 device="cpu")
    pool = nodes.astype(np.uint32)
    P = B * L * 2 * W
    for step in range(2):
        wh, wl, live, starts = _walks(step, B, L)
        neg = np.random.default_rng(100 + step).integers(0, len(pool), (P, K)).astype(np.int32)
        monkeypatch.setattr(JDeviceGraph, "random_walk", staticmethod(
            lambda *a: (jnp.asarray(wh, jnp.uint32), jnp.asarray(wl, jnp.uint32),
                        jnp.asarray(live))))
        monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi: jnp.asarray(neg))
        monkeypatch.setattr(DeviceGraph, "random_walk", staticmethod(
            lambda *a: (torch.from_numpy(wh), torch.from_numpy(wl), torch.from_numpy(live))))
        monkeypatch.setattr(tge, "_negative_indices",
                            lambda gen, n, k, pool_n, dev: torch.from_numpy(neg.astype(np.int64)))
        jstep = jge.make_deepwalk_train_step(jd, jcfg, cfg_j, pool_lo=pool, donate=False)
        args = (jcache.state, jcache.device_map.state, jnp.asarray(starts, jnp.uint32),
                jax.random.PRNGKey(step))
        compiled = jstep.lower(*args).compile({"xla_disable_hlo_passes": "algsimp"})
        jcache.state, jloss = compiled(*args)
        tstep = make_deepwalk_train_step(td, tcfg, cfg_t, pool_lo=pool)
        tcache.state, tloss = tstep(tcache.state, tcache.device_map.state,
                                    torch.from_numpy(starts), torch.Generator().manual_seed(0))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
        for k in jcache.state:
            np.testing.assert_allclose(tcache.state[k].numpy(), np.asarray(jcache.state[k]),
                                       err_msg=f"{k} after step {step}", **CACHE_TOL)
    tt.close()


def test_pairs_from_walks_equal_jax():
    wh, wl, live, _ = _walks(3, 8, 6)
    want = jge._pairs_from_walks(jnp.asarray(wh, jnp.uint32), jnp.asarray(wl, jnp.uint32),
                                 jnp.asarray(live), 3)
    got = tge._pairs_from_walks(torch.from_numpy(wh), torch.from_numpy(wl),
                                torch.from_numpy(live), 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))


def test_tags_equal_jax():
    nodes = np.asarray([0, 1, 2 ** 32 - 1], np.uint64)
    np.testing.assert_array_equal(tge.tag_center(nodes), jge.tag_center(nodes))
    np.testing.assert_array_equal(tge.tag_context(nodes), jge.tag_context(nodes))


def _two_clique(k=10):
    g = GraphTable(shard_num=4, seed=0)
    src, dst = [], []
    for base in (0, k):
        for i in range(k):
            for j in range(k):
                if i != j:
                    src.append(base + i)
                    dst.append(base + j)
    src += [0, k]
    dst += [k, 0]
    g.add_graph_node(list(range(2 * k)))
    g.add_edges(src, dst)
    return g


def _train(cache, cfg, dgraph, nodes, steps, batch, seed=0):
    step = make_deepwalk_train_step(dgraph, cfg[0], cfg[1], pool_lo=nodes.astype(np.uint32))
    gen = torch.Generator().manual_seed(seed)
    losses = []
    for _ in range(steps):
        starts = torch.randint(0, len(nodes), (batch,), generator=gen)
        cache.state, loss = step(cache.state, cache.device_map.state, starts, gen)
        losses.append(float(loss))
    return losses


def test_deepwalk_learns_communities():
    k, dim = 10, 16
    nodes = np.arange(2 * k, dtype=np.uint64)
    dgraph = DeviceGraph.from_graph_table(_two_clique(k), max_deg=32, device="cpu")
    sgd = tsgd.SGDRuleConfig(learning_rate=0.3, initial_g2sum=1.0)
    acc = tacc.AccessorConfig(embedx_dim=dim, embedx_threshold=0.0, sgd=sgd)
    table = ttab.MemorySparseTable(ttab.TableConfig(shard_num=4, accessor_config=acc))
    cache_cfg = tec.CacheConfig(capacity=1 << 8, embedx_dim=dim, embedx_threshold=0.0, sgd=sgd)
    tge.init_node_embeddings(table, nodes, np.random.default_rng(0), scale=0.1)
    cache = tec.HbmEmbeddingCache(table, cache_cfg, device="cpu", device_map=True)
    keys = np.concatenate([tge.tag_center(nodes), tge.tag_context(nodes)])
    cache.begin_pass(keys)
    losses = _train(cache, (cache_cfg, DeepWalkConfig(6, 2, 4, dim)), dgraph, nodes, 60, 64)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])
    intra = np.array([[i, j] for i in range(k) for j in range(k) if i != j]
                     + [[k + i, k + j] for i in range(k) for j in range(k) if i != j])
    cross = np.array([[i, k + j] for i in range(2, k) for j in range(2, k)])
    auc = tge.link_prediction_auc(cache, intra, cross)
    assert auc > 0.8, auc
    cache.end_pass()
    cache.begin_pass(keys)
    np.testing.assert_allclose(tge.link_prediction_auc(cache, intra, cross), auc, atol=1e-6)


def test_deepwalk_dead_end_pairs_masked_under_adam():
    """An isolated node's walk freezes at its start; every pair is masked,
    so under Adam (where even a zero-delta touch moves the state) no cache
    column changes."""
    g = GraphTable(shard_num=2, seed=0)
    g.add_graph_node([0, 1, 2])
    g.add_edges([0, 1], [1, 0])
    nodes = np.arange(3, dtype=np.uint64)
    dgraph = DeviceGraph.from_graph_table(g, max_deg=4, device="cpu")
    dim = 8
    sgd = tsgd.SGDRuleConfig(learning_rate=0.2)
    acc = tacc.AccessorConfig(embedx_dim=dim, embedx_threshold=0.0, sgd=sgd,
                              embed_sgd_rule="adam", embedx_sgd_rule="adam")
    table = ttab.MemorySparseTable(ttab.TableConfig(shard_num=2, accessor_config=acc))
    cache_cfg = tec.CacheConfig(capacity=1 << 6, embedx_dim=dim, embedx_threshold=0.0, sgd=sgd,
                                embed_rule="adam", embedx_rule="adam")
    tge.init_node_embeddings(table, nodes, np.random.default_rng(0), scale=0.1)
    cache = tec.HbmEmbeddingCache(table, cache_cfg, device="cpu", device_map=True)
    cache.begin_pass(np.concatenate([tge.tag_center(nodes), tge.tag_context(nodes)]))
    before = {k: v.clone() for k, v in cache.state.items()}
    step = make_deepwalk_train_step(dgraph, cache_cfg, DeepWalkConfig(4, 2, 0, dim),
                                    pool_lo=nodes.astype(np.uint32))
    cache.state, loss = step(cache.state, cache.device_map.state, torch.tensor([2, 2, 2, 2]),
                             torch.Generator().manual_seed(1))
    assert float(loss) == 0.0
    for k, v in cache.state.items():
        assert torch.equal(v, before[k]), k


def test_deepwalk_over_ssd_table(tmp_path):
    k, dim = 6, 8
    nodes = np.arange(2 * k, dtype=np.uint64)
    dgraph = DeviceGraph.from_graph_table(_two_clique(k), max_deg=16, device="cpu")
    sgd = tsgd.SGDRuleConfig(learning_rate=0.3, initial_g2sum=1.0)
    acc = tacc.AccessorConfig(embedx_dim=dim, embedx_threshold=0.0, sgd=sgd)
    table = ttab.make_sparse_table(ttab.TableConfig(shard_num=2, accessor_config=acc,
                                                    storage="ssd", ssd_path=str(tmp_path / "s")))
    cache_cfg = tec.CacheConfig(capacity=1 << 7, embedx_dim=dim, embedx_threshold=0.0, sgd=sgd)
    tge.init_node_embeddings(table, nodes, np.random.default_rng(0), scale=0.1)
    cache = tec.HbmEmbeddingCache(table, cache_cfg, device="cpu", device_map=True)
    keys = np.concatenate([tge.tag_center(nodes), tge.tag_context(nodes)])
    cache.begin_pass(keys)
    losses = _train(cache, (cache_cfg, DeepWalkConfig(4, 2, 2, dim)), dgraph, nodes, 30, 32)
    assert np.isfinite(losses).all() and losses[-1] < losses[0], (losses[0], losses[-1])
    before = tge.node_embeddings(cache, nodes[:4]).copy()
    cache.end_pass()
    cache.begin_pass(keys)
    np.testing.assert_allclose(tge.node_embeddings(cache, nodes[:4]), before, rtol=1e-6,
                               atol=1e-7)
    table.close()
