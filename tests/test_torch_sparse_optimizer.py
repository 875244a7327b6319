"""paddle_tpu_torch's per-row CTR optimizer against the JAX package.

The port's plain ``fused_row_update`` and its ``ctr_sparse_rows`` (which
takes the plain path for CPU tensors) are held BITWISE against the JAX
package's Pallas ``ctr_sparse_rows`` run in interpret mode on the CPU,
over the 4×4 rule matrix × ``create_applies_grad``, with an unaligned
row count and rows on both sides of ``embedx_threshold``. Both sides
round every f32 op separately (no FMA, IEEE div/sqrt), so the bits must
agree exactly. The in-place form ``ctr_sparse_rows_at`` (CPU: its plain
version) after the port's merge is held bitwise against the JAX
package's ``cache_push_sparse`` composition around the same Pallas
kernel (merge → gather → ``ctr_sparse_rows`` → ``.at[uniq].set(mode=
"drop")``), compiled with the algebraic simplifier off (jitted XLA folds
``click + segment_sum(...)`` into a scatter-add, 1 ulp off the formula).
The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_ctr_rows_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.sparse_optimizer import ctr_sparse_rows as jax_ctr_sparse_rows
from paddle_tpu.ps import embedding_cache as jec
from paddle_tpu.ps.sgd_rule import SGDRuleConfig as JaxSGDRuleConfig
from paddle_tpu_torch.ops import hot_kernels as thk
from paddle_tpu_torch.ops import sparse_optimizer as tso

RULES = ["naive", "adagrad", "std_adagrad", "adam"]
HYPER = dict(lr=0.05, initial_g2sum=3.0, weight_bounds=(-10.0, 10.0),
             beta1=0.9, beta2=0.999, eps=1e-8, nonclk_coeff=0.1,
             click_coeff=1.0, embedx_threshold=1.5)


def _rows(rng, n, dim, embed_rule, embedx_rule):
    """Random gathered rows + merged deltas (numpy). Scores straddle the
    threshold: show+dshow ∈ [0, 6), click ∈ [0, 2) → some rows create."""
    es = tso.rule_state_dim(embed_rule, 1)
    xs = tso.rule_state_dim(embedx_rule, dim)
    f = np.float32
    st = [rng.uniform(0, 4, n).astype(f), rng.uniform(0, 1, n).astype(f),
          rng.normal(size=(n, 1)).astype(f), rng.uniform(0, 1, (n, es)).astype(f),
          rng.normal(size=(n, dim)).astype(f), rng.uniform(0, 1, (n, xs)).astype(f),
          (rng.random(n) < 0.5).astype(f)]
    if embed_rule == "adam":
        st[3][:, -2:] = 0.9
    if embedx_rule == "adam":
        st[5][:, -2:] = rng.uniform(0.5, 0.99, (n, 2)).astype(f)
    deltas = [rng.integers(0, 3, n).astype(f), (rng.random(n) < 0.4).astype(f),
              rng.normal(size=(n, 1)).astype(f), rng.normal(size=(n, dim)).astype(f)]
    return st, deltas


def _jax(st, deltas, embed_rule, embedx_rule, create_applies_grad):
    out = jax_ctr_sparse_rows(
        tuple(jnp.asarray(a) for a in st), *[jnp.asarray(a) for a in deltas],
        embed_rule=embed_rule, embedx_rule=embedx_rule,
        create_applies_grad=create_applies_grad, block=128, interpret=True,
        **HYPER)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("create_applies_grad", [True, False])
@pytest.mark.parametrize("embedx_rule", RULES)
@pytest.mark.parametrize("embed_rule", RULES)
def test_ctr_sparse_rows_bitwise_vs_jax(embed_rule, embedx_rule, create_applies_grad):
    rng = np.random.default_rng(RULES.index(embed_rule) * 8
                                + RULES.index(embedx_rule) * 2 + create_applies_grad)
    n, dim = 203, 4  # unaligned with the JAX kernel's 128-row blocks
    st, deltas = _rows(rng, n, dim, embed_rule, embedx_rule)
    want = _jax(st, deltas, embed_rule, embedx_rule, create_applies_grad)

    t_st = tuple(torch.from_numpy(a) for a in st)
    t_d = [torch.from_numpy(a) for a in deltas]
    got = tso.ctr_sparse_rows(t_st, *t_d, embed_rule=embed_rule,
                              embedx_rule=embedx_rule,
                              create_applies_grad=create_applies_grad, **HYPER)
    plain = tso.fused_row_update(
        *t_st, *t_d, embed_rule=embed_rule, embedx_rule=embedx_rule, dim=dim,
        lr=HYPER["lr"], initial_g2sum=HYPER["initial_g2sum"],
        wmin=HYPER["weight_bounds"][0], wmax=HYPER["weight_bounds"][1],
        beta1=HYPER["beta1"], beta2=HYPER["beta2"], eps=HYPER["eps"],
        nonclk_coeff=HYPER["nonclk_coeff"], click_coeff=HYPER["click_coeff"],
        embedx_threshold=HYPER["embedx_threshold"],
        create_applies_grad=create_applies_grad)
    names = ("show", "click", "embed_w", "embed_state", "embedx_w",
             "embedx_state", "has_embedx")
    for name, w, g, p in zip(names, want, got, plain):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        np.testing.assert_array_equal(p.numpy(), w, err_msg=name)
    # the matrix must exercise creation on both sides of the threshold
    created = (want[6] > 0) & (st[6] == 0)
    assert created.any() and ((st[6] == 0) & ~created).any()


def test_m32_turns_inf_product_into_nan():
    """``t + 0*t`` maps a ±inf product to NaN in both packages."""
    a = torch.tensor([3e38, 2.0], dtype=torch.float32)
    b = torch.tensor([10.0, 3.0], dtype=torch.float32)
    out = tso._m32(a, b)
    assert torch.isnan(out[0]) and out[1] == 6.0


def test_ctr_sparse_rows_rejects_bad_state_width():
    n, dim = 8, 4
    st, deltas = _rows(np.random.default_rng(0), n, dim, "adagrad", "adagrad")
    st[5] = np.zeros((n, 3), np.float32)  # adagrad embedx needs width 1
    with pytest.raises(Exception, match="state width"):
        tso.ctr_sparse_rows(tuple(torch.from_numpy(a) for a in st),
                            *[torch.from_numpy(a) for a in deltas],
                            embed_rule="adagrad", embedx_rule="adagrad", **HYPER)


def test_ctr_sparse_rows_cpu_does_not_count_launches():
    n, dim = 16, 4
    st, deltas = _rows(np.random.default_rng(1), n, dim, "adagrad", "adagrad")
    before = tso.ctr_sparse_rows.launches
    tso.ctr_sparse_rows(tuple(torch.from_numpy(a) for a in st),
                        *[torch.from_numpy(a) for a in deltas],
                        embed_rule="adagrad", embedx_rule="adagrad", **HYPER)
    assert tso.ctr_sparse_rows.launches == before


# the configurations chip_smoke.py holds the kernel to on the card
RULE_PAIRS = [("naive", "naive"), ("adagrad", "adagrad"), ("std_adagrad", "std_adagrad"),
              ("adam", "adam"), ("adagrad", "adam"), ("naive", "std_adagrad")]
COLS = ("show", "click", "embed_w", "embed_state", "embedx_w", "embedx_state", "has_embedx")


def _jax_push(cfg):
    """JAX's ``cache_push_sparse`` with its Pallas kernel (interpret mode),
    jitted with the algebraic simplifier off."""
    compiled = {}

    def call(*args):
        if not compiled:
            fn = lambda st, r, g, s, c: jec.cache_push_sparse(st, r, g, s, c, cfg)
            compiled["f"] = jax.jit(fn).lower(*args).compile(
                {"xla_disable_hlo_passes": "algsimp"})
        return compiled["f"](*args)

    return call


@pytest.mark.parametrize("create_applies_grad", [True, False])
@pytest.mark.parametrize("pair", RULE_PAIRS, ids=lambda p: "/".join(p))
def test_ctr_sparse_rows_at_bitwise_vs_jax_cache_push(pair, create_applies_grad):
    """merge → ``ctr_sparse_rows_at`` in the port equals JAX's merge →
    gather → Pallas ``ctr_sparse_rows`` → ``.at[uniq].set(mode="drop")``,
    bitwise: duplicate rows, sentinel rows (C, dropped) and the merge's
    padding, rows created on the threshold, untouched rows unchanged."""
    embed_rule, embedx_rule = pair
    rng = np.random.default_rng(RULE_PAIRS.index(pair) * 2 + create_applies_grad)
    C, n, dim = 160, 203, 4
    st, _ = _rows(rng, C, dim, embed_rule, embedx_rule)
    rows = rng.integers(0, C // 2, n)  # duplicates
    rows[rng.random(n) < 0.1] = C      # missing keys / padding
    grads = rng.normal(size=(n, 1 + dim)).astype(np.float32)
    shows = (rng.random(n) < 0.8).astype(np.float32)
    clicks = ((rng.random(n) < 0.4) * shows).astype(np.float32)
    sgd = dict(learning_rate=HYPER["lr"], initial_g2sum=HYPER["initial_g2sum"],
               weight_bounds=HYPER["weight_bounds"], beta1=HYPER["beta1"],
               beta2=HYPER["beta2"], ada_epsilon=HYPER["eps"])
    jcfg = jec.CacheConfig(capacity=C, embedx_dim=dim, sgd=JaxSGDRuleConfig(**sgd),
                           nonclk_coeff=HYPER["nonclk_coeff"], click_coeff=HYPER["click_coeff"],
                           embedx_threshold=HYPER["embedx_threshold"], embed_rule=embed_rule,
                           embedx_rule=embedx_rule, create_applies_grad=create_applies_grad,
                           pallas_update=True)
    want = _jax_push(jcfg)({k: jnp.asarray(v) for k, v in zip(COLS, st)},
                           jnp.asarray(rows, jnp.int32), jnp.asarray(grads),
                           jnp.asarray(shows), jnp.asarray(clicks))

    state = tuple(torch.from_numpy(a.copy()) for a in st)
    merged = thk.merge_sparse_grads(*(torch.from_numpy(a) for a in (rows, grads, shows,
                                                                    clicks)), C)
    before = tso.ctr_sparse_rows.launches
    got = tso.ctr_sparse_rows_at(state, *merged, capacity=C, embed_rule=embed_rule,
                                 embedx_rule=embedx_rule,
                                 create_applies_grad=create_applies_grad, **HYPER)
    assert got is state and tso.ctr_sparse_rows.launches == before  # CPU: no launch
    for name, g in zip(COLS, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want[name]), err_msg=name)
    created = (np.asarray(want["has_embedx"]) > 0) & (st[6] == 0)
    assert created.any()
    untouched = np.setdiff1d(np.arange(C), rows)
    np.testing.assert_array_equal(got[4].numpy()[untouched], st[4][untouched])


def test_ctr_sparse_rows_at_rejects_bad_inputs():
    """Mismatched state widths, a float uniq and a capacity past the cache
    fail loudly; an empty batch leaves the state as it was."""
    C, n, dim = 16, 8, 4
    st, _ = _rows(np.random.default_rng(2), C, dim, "adagrad", "adagrad")
    state = tuple(torch.from_numpy(a) for a in st)
    uniq = torch.arange(n)
    ds, dc, g = torch.ones(n), torch.zeros(n), torch.ones(n, 1 + dim)
    kw = dict(embed_rule="adagrad", embedx_rule="adagrad", **HYPER)
    with pytest.raises(Exception, match="state width"):
        tso.ctr_sparse_rows_at(state, uniq, ds, dc, g, capacity=C, embed_rule="adam",
                               embedx_rule="adagrad",
                               **{k: v for k, v in kw.items() if "rule" not in k})
    with pytest.raises(Exception, match="int32 or int64"):
        tso.ctr_sparse_rows_at(state, uniq.float(), ds, dc, g, capacity=C, **kw)
    with pytest.raises(Exception, match="capacity"):
        tso.ctr_sparse_rows_at(state, uniq, ds, dc, g, capacity=C + 1, **kw)
    with pytest.raises(Exception, match="float32"):
        tso.ctr_sparse_rows_at(state, uniq, ds, dc, g[:, :dim], capacity=C, **kw)
    before = [c.clone() for c in state]
    tso.ctr_sparse_rows_at(state, uniq[:0], ds[:0], dc[:0], g[:0], capacity=C, **kw)
    assert all(torch.equal(a, b) for a, b in zip(state, before))
