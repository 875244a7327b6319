"""paddle_tpu_torch's pass cache against the JAX package's, on the CPU.

- ``merge_sparse_grads`` with duplicate and sentinel rows: bitwise (the
  CPU ``index_add_`` sums duplicates in occurrence order, like the JAX
  segment_sum).
- ``cache_push`` in both push modes over every rule: bitwise against
  the JAX package's sparse push (jnp path) and dense push.
- A pass lifecycle over the host tables (begin_pass → pushes → end_pass)
  ends in flushed table rows bit-equal to the JAX package's, per key.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ps import embedding_cache as jec
from paddle_tpu.ps.accessor import AccessorConfig as JaxAccessorConfig
from paddle_tpu.ps.sgd_rule import SGDRuleConfig as JaxSGDRuleConfig
from paddle_tpu.ps.table import MemorySparseTable as JaxTable
from paddle_tpu.ps.table import TableConfig as JaxTableConfig
from paddle_tpu_torch.convert import cache_state_from_jax
from paddle_tpu_torch.ops.sparse_optimizer import rule_state_dim
from paddle_tpu_torch.ps import embedding_cache as tec
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig
from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig
from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

# the JAX side's pass build needs its native dedup order and key map
pytestmark = pytest.mark.usefixtures("jax_native")

RULES = ["naive", "adagrad", "std_adagrad", "adam"]
COLS = ("show", "click", "embed_w", "embed_state", "embedx_w", "embedx_state",
        "has_embedx")


def _state(rng, C, dim, rule):
    es, xs = rule_state_dim(rule, 1), rule_state_dim(rule, dim)
    f = np.float32
    st = {"show": rng.uniform(0, 5, C).astype(f), "click": rng.uniform(0, 2, C).astype(f),
          "embed_w": rng.normal(size=(C, 1)).astype(f),
          "embed_state": rng.uniform(0, 1, (C, es)).astype(f),
          "embedx_w": rng.normal(size=(C, dim)).astype(f),
          "embedx_state": rng.uniform(0, 1, (C, xs)).astype(f),
          "has_embedx": (rng.random(C) < 0.5).astype(f)}
    if rule == "adam":
        st["embed_state"][:, -2:] = 0.9
        st["embedx_state"][:, -2:] = 0.9
    return st


def _push_inputs(rng, C, n, dim, sentinels=True):
    rows = rng.integers(0, C // 4, n)  # heavy duplicates
    if sentinels:
        rows[rng.random(n) < 0.1] = C  # missing keys / padding
    grads = rng.normal(size=(n, 1 + dim)).astype(np.float32)
    shows = np.ones(n, np.float32)
    shows[rng.random(n) < 0.2] = 0.0
    clicks = ((rng.random(n) < 0.4) * shows).astype(np.float32)
    return rows, grads, shows, clicks


def test_merge_sparse_grads_bitwise():
    rng = np.random.default_rng(0)
    C, n, dim = 64, 300, 4
    rows, grads, shows, clicks = _push_inputs(rng, C, n, dim)
    want = jec.merge_sparse_grads(jnp.asarray(rows, jnp.int32), jnp.asarray(grads),
                                  jnp.asarray(shows), jnp.asarray(clicks), C)
    got = tec.merge_sparse_grads(torch.from_numpy(rows), torch.from_numpy(grads),
                                 torch.from_numpy(shows), torch.from_numpy(clicks), C)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0][-1]) == C and (got[0] == C).sum() > 1  # sentinel + padding


@pytest.mark.parametrize("push_mode", ["sparse", "dense"])
@pytest.mark.parametrize("rule", RULES)
def test_cache_push_bitwise_vs_jax(rule, push_mode):
    rng = np.random.default_rng(RULES.index(rule))
    C, n, dim = 256, 300, 4
    st = _state(rng, C, dim, rule)
    rows, grads, shows, clicks = _push_inputs(rng, C, n, dim)
    kw = dict(capacity=C, embedx_dim=dim, embedx_threshold=2.0, embed_rule=rule,
              embedx_rule=rule, push_mode=push_mode)
    jcfg = jec.CacheConfig(pallas_update=False, **kw)
    want = jec.cache_push({k: jnp.asarray(v) for k, v in st.items()},
                          jnp.asarray(rows, jnp.int32), jnp.asarray(grads),
                          jnp.asarray(shows), jnp.asarray(clicks), jcfg)
    tstate = cache_state_from_jax(st, "cpu")
    got = tec.cache_push(tstate, torch.from_numpy(rows), torch.from_numpy(grads),
                         torch.from_numpy(shows), torch.from_numpy(clicks),
                         tec.CacheConfig(**kw))
    assert got is tstate  # the port updates the working set in place
    for k in COLS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    untouched = np.setdiff1d(np.arange(C), rows)
    np.testing.assert_array_equal(got["embedx_w"].numpy()[untouched],
                                  st["embedx_w"][untouched])


def test_scatter_drops_all_sentinel_batch():
    """A batch whose rows are all sentinels leaves the state untouched."""
    rng = np.random.default_rng(4)
    C, n, dim = 32, 16, 4
    st = _state(rng, C, dim, "adagrad")
    tstate = cache_state_from_jax(st, "cpu")
    tec.cache_push(tstate, torch.full((n,), C, dtype=torch.int64),
                   torch.from_numpy(rng.normal(size=(n, 1 + dim)).astype(np.float32)),
                   torch.ones(n), torch.zeros(n),
                   tec.CacheConfig(capacity=C, embedx_dim=dim))
    for k in COLS:
        np.testing.assert_array_equal(tstate[k].numpy(), st[k], err_msg=k)


def test_cache_pull_zeros_sentinel_rows():
    rng = np.random.default_rng(5)
    C, dim = 16, 4
    st = cache_state_from_jax(_state(rng, C, dim, "adagrad"), "cpu")
    rows = torch.tensor([0, C, 3, C])
    got = tec.cache_pull(st, rows)
    want = jec.cache_pull({k: jnp.asarray(v.numpy()) for k, v in st.items()},
                          jnp.asarray(rows.numpy(), jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[1] == 0).all() and (got[3] == 0).all()


@pytest.mark.parametrize("rule", ["adagrad", "std_adagrad"])
def test_host_table_push_pull_digest_match_jax(rule):
    """The port's host table (Python shards) and the JAX package's take
    the same pushes — duplicate keys merged client-side, embedx created
    past the threshold — and end with equal pulls and equal digests."""
    dim = 4
    common = dict(embedx_dim=dim, embedx_threshold=2.0, embed_sgd_rule=rule,
                  embedx_sgd_rule=rule)
    jt = JaxTable(JaxTableConfig(shard_num=3, backend="python",
                                 accessor_config=JaxAccessorConfig(**common)))
    tt = MemorySparseTable(TableConfig(shard_num=3,
                                       accessor_config=AccessorConfig(**common)))
    rng = np.random.default_rng(12)
    keys = rng.integers(1, 1 << 40, size=60).astype(np.uint64)
    slots = rng.integers(0, 5, 60).astype(np.int32)
    np.testing.assert_array_equal(tt.pull_sparse(keys, slots), jt.pull_sparse(keys, slots))
    for _ in range(4):
        bkeys = keys[rng.integers(0, len(keys), 80)]  # duplicates
        push = np.zeros((80, 4 + dim), np.float32)
        push[:, 0] = rng.integers(0, 5, 80)
        push[:, 1] = 1.0
        push[:, 2] = (rng.random(80) < 0.4).astype(np.float32)
        push[:, 3:] = rng.normal(size=(80, 1 + dim)).astype(np.float32)
        jt.push_sparse(bkeys, push)
        tt.push_sparse(bkeys, push)
    np.testing.assert_array_equal(tt.pull_sparse(keys, create=False),
                                  jt.pull_sparse(keys, create=False))
    assert tt.size() == jt.size()
    assert tt.digest() == jt.digest()
    tt.close()


@pytest.mark.parametrize("rule", ["adagrad", "adam"])
def test_pass_lifecycle_flushes_rows_like_jax(rule):
    """begin_pass → 3 pushes → end_pass: the host table's rows are
    bit-equal to the JAX package's, per key (same dedup order, same
    shard RNG init, same rule math)."""
    dim = 4
    common = dict(embedx_dim=dim, embedx_threshold=1.0, embed_sgd_rule=rule,
                  embedx_sgd_rule=rule)
    jtable = JaxTable(JaxTableConfig(
        shard_num=4, backend="python",
        accessor_config=JaxAccessorConfig(sgd=JaxSGDRuleConfig(), **common)))
    ttable = MemorySparseTable(TableConfig(
        shard_num=4, accessor_config=AccessorConfig(sgd=SGDRuleConfig(), **common)))
    kw = dict(capacity=512, embedx_dim=dim, embedx_threshold=1.0,
              embed_rule=rule, embedx_rule=rule)
    jcache = jec.HbmEmbeddingCache(jtable, jec.CacheConfig(**kw))
    tcache = tec.HbmEmbeddingCache(ttable, tec.CacheConfig(**kw), device="cpu")

    rng = np.random.default_rng(11)
    keys = rng.integers(1, 1 << 40, size=400).astype(np.uint64)
    assert jcache.begin_pass(keys) == tcache.begin_pass(keys)
    uniq = np.unique(keys)
    for _ in range(3):
        bkeys = uniq[rng.integers(0, len(uniq), 96)]
        grads = rng.normal(size=(96, 1 + dim)).astype(np.float32)
        shows = np.ones(96, np.float32)
        clicks = (rng.random(96) < 0.4).astype(np.float32)
        jrows = jcache.lookup(bkeys)
        trows = tcache.lookup(bkeys)
        np.testing.assert_array_equal(trows, jrows)
        jcache.state = jec.cache_push(jcache.state, jnp.asarray(jrows), jnp.asarray(grads),
                                      jnp.asarray(shows), jnp.asarray(clicks),
                                      jcache.config)
        tec.cache_push(tcache.state, torch.from_numpy(trows.astype(np.int64)),
                       torch.from_numpy(grads), torch.from_numpy(shows),
                       torch.from_numpy(clicks), tcache.config)
    jcache.end_pass()
    tcache.end_pass()
    want, _ = jtable.export_full(uniq)
    got, found = ttable.export_full(uniq)
    assert found.all()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 3] > 0).any()  # the pushes landed
    ttable.close()
