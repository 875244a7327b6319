"""DCN and xDeepFM, the pooled (multi-valued slot) step, the from-keys
step and the pass trainer's ``amp``/``prefetch_depth`` against the JAX
package, on the CPU.

Both packages start from the same weights (``ctr_params_from_jax``,
``adam_state_from_jax``), the same pass over the same host tables and
the same batches (``test_torch_ctr.Pair``'s setup with the family's
model). Tolerances are ``test_torch_ctr.py``'s: forward rtol 1e-5 /
atol 1e-6, gradients rtol 1e-5 / atol 1e-7; after 3 steps losses rtol
1e-5, dense params and every cache column rtol 1e-4 / atol 1e-6 (the
towers' matmuls run through different BLAS, and XLA contracts the dense
update into FMAs). Under ``amp`` each param and cache column within 1e-2
of that tensor's largest value (the port rounds the tower's cotangent to
bf16, ROADMAP Queue C; ``test_torch_ctr.py`` measured 4e-3), show, click
and has_embedx exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.data.dataset import InMemoryDataset as JaxDataset
from paddle_tpu.data.dataset import SlotDesc as JaxSlotDesc
from paddle_tpu.models import ctr as jctr
from paddle_tpu.nn import functional as jF
from paddle_tpu.nn.layer import functional_call as jcall
from paddle_tpu.ps import embedding_cache as jec
from paddle_tpu.ps import ps_trainer as jtrainer
from paddle_tpu.ps.accessor import AccessorConfig as JaxAccessorConfig
from paddle_tpu.ps.table import MemorySparseTable as JaxTable
from paddle_tpu.ps.table import TableConfig as JaxTableConfig
from paddle_tpu_torch.convert import adam_state_from_jax, ctr_params_from_jax
from paddle_tpu_torch.data.dataset import InMemoryDataset, SlotDesc
from paddle_tpu_torch.models import ctr as tctr
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.ps import embedding_cache as tec
from paddle_tpu_torch.ps import ps_trainer as ttrainer
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig
from test_torch_ctr import B, D, DIM, HIDDEN, S, Pair, _amp_gap
from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)
from test_torch_widedeep import day_lines

pytestmark = pytest.mark.usefixtures("jax_native")

FAMILIES = ["DCN", "XDeepFM"]


class FamilyPair(Pair):
    """``Pair`` with the family's model in both packages."""

    def __init__(self, family):
        super().__init__()
        pt.seed(0)
        self.jmodel = getattr(jctr, family)(jctr.CtrConfig(S, D, DIM, HIDDEN))
        self.jparams = {"params": dict(self.jmodel.named_parameters()), "buffers": {}}
        self.jopt_state = self.jopt.init(self.jparams)
        self.tmodel = getattr(tctr, family)(tctr.CtrConfig(S, D, DIM, HIDDEN))
        self.tparams = ctr_params_from_jax(
            {k: np.asarray(v) for k, v in self.jparams["params"].items()})
        self.topt_state = adam_state_from_jax(self.jopt_state)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_forward_and_grads_match_jax(family):
    p = FamilyPair(family)
    assert sorted(p.tparams) == sorted(dict(p.tmodel.named_parameters()))
    p.tmodel.load_state_dict(p.tparams)
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(B, S, 1 + DIM)).astype(np.float32)
    dense = rng.normal(size=(B, D)).astype(np.float32)
    labels = (rng.random(B) < 0.4).astype(np.float32)

    def jloss(params, e):
        out, _ = jcall(p.jmodel, params, e, jnp.asarray(dense), training=True)
        return jnp.mean(jF.binary_cross_entropy_with_logits(out, jnp.asarray(labels),
                                                            reduction="none")), out

    (jl, jout), (jg, jge) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        p.jparams, jnp.asarray(emb))
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.tparams.items()}
    te = torch.from_numpy(emb).requires_grad_(True)
    tout = torch.func.functional_call(p.tmodel, leaves, (te, torch.from_numpy(dense)))
    tl = tF.binary_cross_entropy_with_logits(tout, torch.from_numpy(labels),
                                             reduction="none").mean()
    *tg, tge = torch.autograd.grad(tl, [*leaves.values(), te])
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tge.numpy(), np.asarray(jge), rtol=1e-5, atol=1e-7)
    for k, g in zip(leaves, tg):
        want = np.asarray(jg["params"][k])
        np.testing.assert_allclose(g.numpy(), want.T if want.ndim == 2 else want,
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def _keys_batch(p, seed):
    rng = np.random.default_rng(seed)
    keys = p.pool[rng.integers(0, len(p.pool), B)]
    dense = rng.normal(size=(B, D)).astype(np.float32)
    labels = (rng.random(B) < 0.4).astype(np.int32)
    return keys, dense, labels


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("kind", ["row", "packed", "slab", "from_keys", "from_keys_wide"])
def test_family_three_steps_match_jax(family, kind):
    """3 steps of each step form: losses, dense params and the seven cache
    columns after each step's push."""
    p = FamilyPair(family)
    jmap, tmap = p.jcache.device_map.state, p.tcache.device_map.state
    jp, js, jst = p.jparams, p.jopt_state, p.jcache.state
    tp, ts, tst = p.tparams, p.topt_state, p.tcache.state
    if kind in ("packed", "slab"):
        packs = p.packs(3, seed=5)
        if kind == "packed":
            jstep = jctr.make_ctr_train_step_packed(p.jmodel, p.jopt, p.jccfg, np.arange(S),
                                                    B, D, donate=False)
            tstep = tctr.make_ctr_train_step_packed(p.tmodel, p.topt, p.tccfg, np.arange(S),
                                                    B, D, device="cpu")
            feeds = packs
        else:
            jstep = jctr.make_ctr_train_step_slab(p.jmodel, p.jopt, p.jccfg, np.arange(S),
                                                  B, D, slab=3, donate=False)
            tstep = tctr.make_ctr_train_step_slab(p.tmodel, p.topt, p.tccfg, np.arange(S),
                                                  B, D, slab=3, device="cpu")
            feeds = [np.stack(packs)]
        for pk in feeds:
            jp, js, jst, jl = jstep(jp, js, jst, jmap, jnp.asarray(pk))
            tp, ts, tst, tl = tstep(tp, ts, tst, tmap, torch.from_numpy(pk))
            p.assert_close(jl, tl, tp, jp, tst, jst)
        return
    for seed in (11, 12, 13):
        keys, dense, labels = _keys_batch(p, seed)
        if kind == "row":
            jstep = jctr.make_ctr_train_step(p.jmodel, p.jopt, p.jccfg, donate=False)
            tstep = tctr.make_ctr_train_step(p.tmodel, p.topt, p.tccfg, device="cpu")
            rows = p.tcache.lookup(keys.reshape(-1)).reshape(B, S)
            jargs = (jnp.asarray(p.jcache.lookup(keys.reshape(-1)).reshape(B, S)),)
            targs = (torch.from_numpy(rows.astype(np.int64)),)
            jpre, tpre = (), ()
        else:
            wide = kind == "from_keys_wide"
            sid = None if wide else np.arange(S)
            jstep = jctr.make_ctr_train_step_from_keys(p.jmodel, p.jopt, p.jccfg, sid,
                                                       donate=False)
            tstep = tctr.make_ctr_train_step_from_keys(p.tmodel, p.topt, p.tccfg, sid,
                                                       device="cpu")
            lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            hi = (keys >> np.uint64(32)).astype(np.uint32)
            jargs = ((jnp.asarray(hi),) if wide else ()) + (jnp.asarray(lo),)
            targs = ((torch.from_numpy(hi.astype(np.int64)),) if wide else ()) + (
                torch.from_numpy(lo.astype(np.int64)),)
            jpre, tpre = (jmap,), (tmap,)
        jp, js, jst, jl = jstep(jp, js, jst, *jpre, *jargs, jnp.asarray(dense),
                                jnp.asarray(labels))
        tp, ts, tst, tl = tstep(tp, ts, tst, *tpre, *targs, torch.from_numpy(dense),
                                torch.from_numpy(labels))
        p.assert_close(jl, tl, tp, jp, tst, jst)


# -- the pooled step: multi-valued slots ------------------------------------------------

SLOT_OF_COLUMN = np.array([0, 0, 1, 2, 2, 2])   # slot 0: 2 values, slot 1: 1, slot 2: 3


def _pooled_rows(p, cache, seed):
    """[B, T] rows: each slot's values drawn from its column of the pool;
    a random share of the positions past a slot's first is padding (the
    capacity sentinel)."""
    rng = np.random.default_rng(seed)
    T = len(SLOT_OF_COLUMN)
    keys = p.pool[rng.integers(0, len(p.pool), (B, T)), SLOT_OF_COLUMN[None, :]]
    rows = cache.lookup(keys.reshape(-1)).reshape(B, T).astype(np.int64)
    first = np.r_[True, SLOT_OF_COLUMN[1:] != SLOT_OF_COLUMN[:-1]]
    pad = (rng.random((B, T)) < 0.4) & ~first[None, :]
    rows[pad] = cache.config.capacity
    dense = rng.normal(size=(B, D)).astype(np.float32)
    labels = (rng.random(B) < 0.4).astype(np.int32)
    weights = (rng.random(B) < 0.9).astype(np.float32)
    return rows, dense, labels, weights


@pytest.mark.parametrize("amp", [False, True])
def test_pooled_step_matches_jax(amp):
    """3 pooled steps (a [B, 6]-column batch over 3 slots, ~40 % of the
    extra positions padding, a 0/1 tail mask): losses, params and cache
    columns; the padding positions push nothing (their sentinel row is
    dropped and their show is 0). f32 runs DCN at the f32 tolerances.
    amp runs DeepFM: the port rounds the tower's cotangent to bf16 (the
    kept divergence), and the pooled push hands each slot's gradient to
    up to 3 positions, whose squares the AdaGrad state sums, so the gap
    grows faster than the packed step's 4e-3: after the first step every
    param and cache column within 2e-2 of its largest value (seen 9.9e-3,
    ``embedx_state``, against a JAX amp-vs-f32 effect of 5.9e-3), after
    the third within 0.15 (seen 0.083). DCN's DNN biases, with gradients
    near 0 at init, read 0.07-0.13 after 3 amp Adam steps: Adam moves
    them by ~lr whatever the sign of the rounding."""
    p = FamilyPair("DCN") if not amp else Pair()
    jstep = jctr.make_ctr_pooled_train_step(p.jmodel, p.jopt, p.jccfg, SLOT_OF_COLUMN,
                                            donate=False, amp=amp)
    tstep = tctr.make_ctr_pooled_train_step(p.tmodel, p.topt, p.tccfg, SLOT_OF_COLUMN,
                                            device="cpu", amp=amp)
    jp, js, jst = p.jparams, p.jopt_state, p.jcache.state
    tp, ts, tst = p.tparams, p.topt_state, p.tcache.state
    for seed in (21, 22, 23):
        rows, dense, labels, w = _pooled_rows(p, p.tcache, seed)
        np.testing.assert_array_equal(
            rows, _pooled_rows(p, p.jcache, seed)[0])  # the same pass layout
        jp, js, jst, jl = jstep(jp, js, jst, jnp.asarray(rows.astype(np.int32)),
                                jnp.asarray(dense), jnp.asarray(labels), jnp.asarray(w))
        tp, ts, tst, tl = tstep(tp, ts, tst, torch.from_numpy(rows), torch.from_numpy(dense),
                                torch.from_numpy(labels), torch.from_numpy(w))
        if not amp:
            p.assert_close(jl, tl, tp, jp, tst, jst)
            continue
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
        gap = _amp_gap(tp, jp, tst, jst)
        assert max(gap.values()) <= (2e-2 if seed == 21 else 0.15), (seed, gap)
        assert gap["show"] == gap["click"] == gap["has_embedx"] == 0.0


def test_push_stats_real_mask_matches_jax():
    rng = np.random.default_rng(4)
    labels = (rng.random(6) < 0.5).astype(np.int32)
    w = (rng.random(6) < 0.7).astype(np.float32)
    real = (rng.random(18) < 0.6).astype(np.float32)
    for args in ((None, None), (w, None), (None, real), (w, real)):
        js, jc = jctr._push_stats(jnp.asarray(labels), *(None if a is None else jnp.asarray(a)
                                                         for a in args[:1]), 3,
                                  real=None if args[1] is None else jnp.asarray(args[1]))
        ts, tc = tctr._push_stats(torch.from_numpy(labels),
                                  None if args[0] is None else torch.from_numpy(args[0]), 3,
                                  real=None if args[1] is None else torch.from_numpy(args[1]))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


# -- CtrPassTrainer's amp and prefetch_depth ----------------------------------------------

NAMES = dict(sparse_slots=[f"s{i}" for i in range(S)],
             dense_slots=[f"d{i}" for i in range(D)], label_slot="label")
PASS_B, RECORDS = 128, 600


def _day(cls, slot_cls):
    slots = ([slot_cls(f"s{i}", is_float=False, max_len=1) for i in range(S)]
             + [slot_cls(f"d{i}", is_float=True, max_len=1) for i in range(D)]
             + [slot_cls("label", is_float=True, max_len=1)])
    ds = cls(slots, seed=0)
    ds.load_from_lines(day_lines(77, RECORDS))
    return ds


def _trainers(amp, prefetch_depth):
    pt.seed(0)
    jtr = jtrainer.CtrPassTrainer(
        jctr.XDeepFM(jctr.CtrConfig(S, D, DIM, HIDDEN)), jax_optimizer.Adam(1e-2),
        JaxTable(JaxTableConfig(shard_num=2, backend="python",
                                accessor_config=JaxAccessorConfig(embedx_dim=DIM,
                                                                  embedx_threshold=0.0))),
        jec.CacheConfig(capacity=1 << 12, embedx_dim=DIM, embedx_threshold=0.0),
        amp=amp, prefetch_depth=prefetch_depth, **NAMES)
    tr = ttrainer.CtrPassTrainer(
        tctr.XDeepFM(tctr.CtrConfig(S, D, DIM, HIDDEN)), Adam(1e-2),
        MemorySparseTable(TableConfig(shard_num=2, accessor_config=AccessorConfig(
            embedx_dim=DIM, embedx_threshold=0.0))),
        tec.CacheConfig(capacity=1 << 12, embedx_dim=DIM, embedx_threshold=0.0),
        device="cpu", amp=amp, prefetch_depth=prefetch_depth, **NAMES)
    tr.params = ctr_params_from_jax({k: np.asarray(v)
                                     for k, v in jtr.params["params"].items()})
    tr.opt_state = adam_state_from_jax(jtr.opt_state)
    return jtr, tr


@pytest.mark.parametrize("amp,prefetch_depth", [(False, 1), (True, 3), (True, 6)])
def test_pass_trainer_amp_and_prefetch_depth_match_jax(amp, prefetch_depth):
    """One pass of XDeepFM (5 steps, the last a padded tail) in both
    packages with the same knobs: the pass loss, dense params and the
    flushed rows at the f32 tolerances, or under ``amp`` at the amp gap;
    the prefetch depth changes no bit of the port's result."""
    jtr, tr = _trainers(amp, prefetch_depth)
    j = jtr.train_from_dataset(_day(JaxDataset, JaxSlotDesc), batch_size=PASS_B,
                               drop_last=False)
    t = tr.train_from_dataset(_day(InMemoryDataset, SlotDesc), batch_size=PASS_B,
                              drop_last=False)
    assert t["steps"] == j["steps"] == 5 and tr.amp == amp
    assert tr.prefetch_depth == prefetch_depth
    if amp:
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
        gap = _amp_gap(tr.params, jtr.params, {}, {})
        assert max(gap.values()) <= 1e-2, gap
    else:
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
        for k, v in jtr.params["params"].items():
            v = np.asarray(v)
            np.testing.assert_allclose(tr.params[k].numpy(), v.T if v.ndim == 2 else v,
                                       rtol=1e-4, atol=1e-6, err_msg=k)
    # the same knobs with the default depth: bit for bit
    _, again = _trainers(amp, 3)
    again.train_from_dataset(_day(InMemoryDataset, SlotDesc), batch_size=PASS_B,
                             drop_last=False)
    for k in tr.params:
        assert torch.equal(tr.params[k], again.params[k]), k
