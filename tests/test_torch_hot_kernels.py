"""paddle_tpu_torch's hot-tier kernels against the JAX package, on the CPU.

The JAX kernels run as the JAX package's own tests run them here
(``interpret=True``); the port's wrappers run their plain versions (CPU
tensors). Inputs come from numpy seeds and go through both packages.
Tolerance: bitwise everywhere — the probe is integer work and the gather
a copy; the push sums duplicates in occurrence order from 0.0 in both
packages and applies the same f32-sealed rule math.

The CUDA kernels of ``ops/csrc/hot_kernels.cu`` cannot run here;
``tests/test_torch_hot_kernels_cuda.py`` (``cuda``-marked, no jax) holds
them bitwise against the plain versions on a card, and ``chip_smoke.py``
does the same at the main path's shape.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.hot_kernels import hot_probe_gather as jax_probe_gather
from paddle_tpu.ops.hot_kernels import hot_scatter_apply as jax_scatter_apply
from paddle_tpu.ps.device_hash import DynamicDeviceKeyMap as JaxMap
from paddle_tpu.ps.device_hash import split_keys as jax_split_keys
from paddle_tpu.ps.embedding_cache import CacheConfig as JaxCacheConfig
from paddle_tpu.ps.embedding_cache import merge_sparse_grads as jax_merge
from paddle_tpu.ps.sgd_rule import SGDRuleConfig as JaxSGDRuleConfig
from paddle_tpu_torch.convert import cache_state_from_jax, dynamic_map_state_from_jax
from paddle_tpu_torch.ops import hot_kernels as hk
from paddle_tpu_torch.ops.sparse_optimizer import rule_state_dim
from paddle_tpu_torch.ps.embedding_cache import CacheConfig
from paddle_tpu_torch.ps.embedding_cache import merge_sparse_grads as port_merge
from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig

RULES = ["naive", "adagrad", "std_adagrad", "adam"]


def _banked_map(C, banks, keys):
    """A JAX map with the tier's placement contract: a key's row lives
    inside its bank's contiguous row block."""
    m = JaxMap(C, banks=banks)
    Cb = C // banks
    rows = np.zeros(len(keys), np.int32)
    nxt = [0] * banks
    for i, b in enumerate(m.bank_of(keys)):
        rows[i] = b * Cb + nxt[b]
        nxt[b] += 1
    m.insert(keys, rows)
    return m, rows


def _tier_state_np(C, xd, rng, es=1, xs=1, adam_embed=False, adam_embedx=False):
    f = np.float32
    st = {"show": np.abs(rng.normal(size=C)).astype(f),
          "click": np.abs(rng.normal(size=C)).astype(f),
          "embed_w": rng.normal(size=(C, 1)).astype(f),
          "embed_state": np.abs(rng.normal(size=(C, es))).astype(f),
          "embedx_w": rng.normal(size=(C, xd)).astype(f),
          "embedx_state": np.abs(rng.normal(size=(C, xs))).astype(f),
          "has_embedx": (rng.random(C) > 0.5).astype(f)}
    if adam_embed:  # beta-power columns in (0, 1) like real rows
        st["embed_state"][:, 2:] = 0.9
    if adam_embedx:
        st["embedx_state"][:, 2 * xd:] = rng.uniform(0.5, 0.99, (C, 2)).astype(f)
    return st


def _port_keys(keys):
    hi, lo = jax_split_keys(keys)
    return torch.from_numpy(hi.view(np.int32)), torch.from_numpy(lo.view(np.int32))


def _map_arrays(m):
    return {"hi": m.hi, "lo": m.lo, "row": m.row, "seed": m.seed}


@pytest.mark.parametrize("stage", ["fresh", "removed", "rebuilt"])
@pytest.mark.parametrize("banks", [1, 4])
def test_probe_gather_plain_matches_jax_kernel(banks, stage):
    """B2: rows and pulled rows bitwise, n = 157 (resident + absent keys,
    not a block multiple), before and after removals (tombstones) and a
    grow rebuild (new seed, new layout)."""
    rng = np.random.default_rng(0)
    C, xd = 256, 8
    keys = np.unique(rng.integers(1, 2**63, 300).astype(np.uint64))[:120]
    m, rows = _banked_map(C, banks, keys)
    if stage in ("removed", "rebuilt"):
        m.remove(keys[::3])
    if stage == "rebuilt":
        m._rebuild(grow=True)
    state = _tier_state_np(C, xd, rng)
    probe = np.concatenate([keys, rng.integers(1, 2**63, 37).astype(np.uint64)])
    hi, lo = jax_split_keys(probe)
    ms = m.device_state()
    jrows, jpull = jax_probe_gather(ms, jnp.asarray(hi), jnp.asarray(lo),
                                    {k: jnp.asarray(v) for k, v in state.items()},
                                    probe_buckets=m.probe_buckets, banks=banks,
                                    block=64, interpret=True)
    th, tl = _port_keys(probe)
    prows, ppull = hk.hot_probe_gather(dynamic_map_state_from_jax(_map_arrays(m), "cpu"),
                                       th, tl, cache_state_from_jax(state, "cpu"),
                                       probe_buckets=m.probe_buckets, banks=banks)
    assert prows.dtype == torch.int32 and ppull.shape == (157, 1 + xd)
    np.testing.assert_array_equal(prows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(ppull.numpy(), np.asarray(jpull))
    # not a trivially all-miss (or all-hit) probe
    want = m.lookup_host(probe)
    np.testing.assert_array_equal(prows.numpy(), want)
    assert (want[len(keys):] == -1).all() and (want >= 0).sum() > 60


def _cfgs(rule, C, xd, cag):
    kw = dict(capacity=C, embedx_dim=xd, embed_rule=rule, embedx_rule=rule,
              embedx_threshold=1.5, create_applies_grad=cag, push_mode="sparse")
    return (JaxCacheConfig(sgd=JaxSGDRuleConfig(), **kw),
            CacheConfig(sgd=SGDRuleConfig(), **kw))


def _push_inputs(rng, C, xd, n):
    rows = np.concatenate([rng.integers(0, C, n - 24),
                           rng.integers(0, 8, 8),   # heavy duplicates
                           np.full(5, C),           # sentinel: dropped
                           np.full(3, C + 7),       # past the sentinel
                           -rng.integers(1, 5, 8)]) # negative: dropped
    rng.shuffle(rows)
    return (rows.astype(np.int32), rng.normal(size=(n, 1 + xd)).astype(np.float32),
            rng.integers(1, 3, n).astype(np.float32),
            (rng.random(n) > 0.6).astype(np.float32))


@pytest.mark.parametrize("cag", [True, False])
@pytest.mark.parametrize("rule", RULES)
def test_scatter_apply_plain_matches_jax_kernel(rule, cag):
    """B4: every state column bitwise after one push — prime n = 101,
    duplicate rows, sentinel rows C and beyond, negative rows, the four
    rules × ``create_applies_grad``. The port updates in place."""
    rng = np.random.default_rng(2)
    C, xd, n = 128, 8, 101
    es, xs = rule_state_dim(rule, 1), rule_state_dim(rule, xd)
    state = _tier_state_np(C, xd, rng, es, xs, rule == "adam", rule == "adam")
    rows, grads, shows, clicks = _push_inputs(rng, C, xd, n)
    jcfg, tcfg = _cfgs(rule, C, xd, cag)
    want = jax_scatter_apply({k: jnp.asarray(v) for k, v in state.items()},
                             jnp.asarray(rows), jnp.asarray(grads), jnp.asarray(shows),
                             jnp.asarray(clicks), jcfg, interpret=True)
    tstate = cache_state_from_jax(state, "cpu")
    got = hk.hot_scatter_apply(tstate, torch.from_numpy(rows), torch.from_numpy(grads),
                               torch.from_numpy(shows), torch.from_numpy(clicks), tcfg)
    assert got is tstate  # in place
    for k in state:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=f"{rule} cag={cag}: column {k}")
    assert not np.array_equal(got["embed_w"].numpy(), state["embed_w"])


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_merge_plain_matches_jax_merge(dtype):
    """The merge alone (``uniq`` sorted and padded with C, sums in
    occurrence order from 0.0): the port's ``merge_sparse_grads`` on CPU
    tensors equals the JAX package's bitwise, heavy duplicates included."""
    rng = np.random.default_rng(5)
    C, xd, n = 64, 4, 97
    rows, grads, shows, clicks = _push_inputs(rng, C, xd, n)
    rows = rows.astype(dtype)
    # addends of mixed magnitude make the summation order visible
    grads *= np.float32(10.0) ** rng.integers(-4, 5, (n, 1)).astype(np.float32)
    ju, js, jc, jg = jax_merge(jnp.asarray(rows), jnp.asarray(grads), jnp.asarray(shows),
                               jnp.asarray(clicks), C)
    tu, ts, tc, tg = port_merge(torch.from_numpy(rows), torch.from_numpy(grads),
                                torch.from_numpy(shows), torch.from_numpy(clicks), C)
    for got, want in ((tu, ju), (ts, js), (tc, jc), (tg, jg)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scatter_apply_plain_equals_cache_push_sparse():
    """Inside the port: the fused push's plain version and the unfused
    ``cache_push_sparse`` (merge → ``ctr_sparse_rows_at``: on the CPU
    gather → rule → scatter) give the same state, bitwise (valid rows
    only — the unfused path never sees negative rows)."""
    from paddle_tpu_torch.ps.embedding_cache import cache_push_sparse

    rng = np.random.default_rng(7)
    C, xd, n = 96, 8, 211
    state = _tier_state_np(C, xd, rng)
    rows = np.concatenate([rng.integers(0, C, n - 11), np.full(11, C)]).astype(np.int64)
    grads = rng.normal(size=(n, 1 + xd)).astype(np.float32)
    shows = np.ones(n, np.float32)
    clicks = (rng.random(n) > 0.5).astype(np.float32)
    cfg = CacheConfig(capacity=C, embedx_dim=xd, embedx_threshold=0.5)
    args = [torch.from_numpy(a) for a in (rows, grads, shows, clicks)]
    a = hk.hot_scatter_apply(cache_state_from_jax(state, "cpu"), *args, cfg)
    b = cache_push_sparse(cache_state_from_jax(state, "cpu"), *args, cfg)
    for k in a:
        assert torch.equal(a[k], b[k]), k
