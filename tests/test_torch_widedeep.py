"""Wide&Deep and the pass trainer against the JAX package, on the CPU.

``WideDeep`` on converted weights (``ctr_params_from_jax``), and
``CtrPassTrainer`` over each package's ``SsdSparseTable``: the JAX tool's
daily loop (``tools/widedeep_daily.py``) at a small size — 20,000 cold
rows, 2 days of 1,200 records (4 batches of 256 and a padded tail),
slab 1 and slab 4 (one slab, then the tail as a single step).
Tolerances, those of ``tests/test_torch_ctr.py`` for f32 (the towers'
matmuls run through different BLAS, and XLA contracts the dense Adam
update into FMAs, so trajectories differ in the last bits):

- forward rtol 1e-5 / atol 1e-6, gradients rtol 1e-5 / atol 1e-7;
- per-day losses rtol 1e-5; dense params and the table's exported rows
  (both tiers) rtol 1e-4 / atol 1e-6;
- ``evaluate``'s AUC and ``wuauc`` within 1e-3: the predictions differ
  by the tower's rounding, and AUC buckets them into 4096 bins. The
  readings here are equal in both packages: AUC 0.2362 and 0.2368 on the
  two days (a model 10 steps from its random start; the full-width run
  of ``chip_smoke.py`` reaches ~0.82);
- exact where no float arithmetic differs: the padding, ``train_passes``
  against sequential ``train_from_dataset`` in the port (bit for bit),
  and trainer checkpoints carried across the packages.
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
from paddle_tpu.ps import ps_trainer as jtrainer
from paddle_tpu.ps.accessor import AccessorConfig as JaxAccessorConfig
from paddle_tpu.ps.embedding_cache import CacheConfig as JaxCacheConfig
from paddle_tpu.ps.table import SsdSparseTable as JaxSsdTable
from paddle_tpu.ps.table import TableConfig as JaxTableConfig
from paddle_tpu_torch.convert import adam_state_from_jax, ctr_params_from_jax
from paddle_tpu_torch.data.dataset import InMemoryDataset, SlotDesc
from paddle_tpu_torch.models import ctr as tctr
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.ps import ps_trainer as ttrainer
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.embedding_cache import CacheConfig
from paddle_tpu_torch.ps.table import SsdSparseTable, TableConfig
from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

# the JAX SSD table and pass build need the JAX package's native library
pytestmark = pytest.mark.usefixtures("jax_native")

S, D, DIM, HIDDEN = 3, 4, 4, (16, 16)
B, POP, RECORDS, DAYS, SHARDS = 256, 20_000, 1_200, 2, 4
LOSS_RTOL = 1e-5
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
AUC_TOL = 1e-3
NAMES = dict(sparse_slots=[f"s{i}" for i in range(S)],
             dense_slots=[f"d{i}" for i in range(D)], label_slot="label")


def _jax_params(jmodel):
    return {k: np.asarray(v) for k, v in jmodel.named_parameters()}


def test_widedeep_forward_and_grads_match_jax():
    pt.seed(0)
    jmodel = jctr.WideDeep(jctr.CtrConfig(S, D, DIM, HIDDEN))
    tmodel = tctr.WideDeep(tctr.CtrConfig(S, D, DIM, HIDDEN))
    jparams = _jax_params(jmodel)
    tparams = ctr_params_from_jax(jparams)
    assert sorted(tparams) == sorted(k for k, _ in tmodel.named_parameters())
    for k, v in tmodel.named_parameters():
        assert tuple(v.shape) == tuple(tparams[k].shape), k
    rng = np.random.default_rng(5)
    emb = rng.normal(size=(48, S, 1 + DIM)).astype(np.float32)
    dense = rng.normal(size=(48, D)).astype(np.float32)
    labels = (rng.random(48) < 0.4).astype(np.float32)

    def jloss(params, e):
        out, _ = pt.nn.functional_call(jmodel, {"params": params, "buffers": {}}, e,
                                       jnp.asarray(dense))
        return jnp.mean(jF.binary_cross_entropy_with_logits(out, jnp.asarray(labels),
                                                            reduction="none"))

    jout = jmodel.forward(jnp.asarray(emb), jnp.asarray(dense))
    jl, (jg, jge) = jax.value_and_grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in jparams.items()}, jnp.asarray(emb))

    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    temb = torch.from_numpy(emb).requires_grad_(True)
    tout = torch.func.functional_call(tmodel, leaves, (temb, torch.from_numpy(dense)))
    tl = tF.binary_cross_entropy_with_logits(tout, torch.from_numpy(labels),
                                             reduction="none").mean()
    *tg, tge = torch.autograd.grad(tl, [*leaves.values(), temb])
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tge.numpy(), np.asarray(jge), rtol=1e-5, atol=1e-7)
    for k, g in zip(leaves, tg):
        want = np.asarray(jg[k])
        np.testing.assert_allclose(g.numpy(), want.T if want.ndim == 2 else want,
                                   rtol=1e-5, atol=1e-7, err_msg=k)


# -- the daily loop ---------------------------------------------------------------

def day_lines(seed, n=RECORDS):
    """The JAX tool's synthetic day (``_day_lines``): ids from a pool of
    2,000 (repeats), a clicky-id and dense-feature label."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(np.arange(1, 2_000, dtype=np.uint64), size=(n, S))
    dense = rng.normal(size=(n, D))
    label = ((ids % 7 == 0).sum(axis=1) + dense[:, 0]
             + rng.normal(scale=0.5, size=n) > 1.0).astype(int)
    return [" ".join([f"1 {v}" for v in ids[i]] + [f"1 {v:.4f}" for v in dense[i]]
                     + [f"1 {label[i]}"]) for i in range(n)]


def _dataset(cls, slot_cls, day):
    slots = ([slot_cls(f"s{i}", is_float=False, max_len=1) for i in range(S)]
             + [slot_cls(f"d{i}", is_float=True, max_len=1) for i in range(D)]
             + [slot_cls("label", is_float=True, max_len=1)])
    ds = cls(slots, seed=day)
    ds.load_from_lines(day_lines(1000 + day))
    ds.local_shuffle()
    return ds


def port_days():
    return [_dataset(InMemoryDataset, SlotDesc, d) for d in range(DAYS)]


def jax_days():
    return [_dataset(JaxDataset, JaxSlotDesc, d) for d in range(DAYS)]


def _population(full_dim):
    keys = np.arange(1, POP + 1, dtype=np.uint64)
    vals = np.zeros((POP, full_dim), np.float32)
    vals[:, 3] = 10.0  # previously seen: the shrink's decay keeps them
    return keys, vals


def port_trainer(path, jparams, jopt_state, slab=1):
    table = SsdSparseTable(path, TableConfig(
        shard_num=SHARDS, accessor_config=AccessorConfig(embedx_dim=DIM, embedx_threshold=0.0)))
    table.load_cold(*_population(table.full_dim))
    tr = ttrainer.CtrPassTrainer(
        tctr.WideDeep(tctr.CtrConfig(S, D, DIM, HIDDEN)), Adam(1e-3), table,
        CacheConfig(capacity=1 << 14, embedx_dim=DIM, embedx_threshold=0.0),
        slab=slab, device="cpu", **NAMES)
    tr.params = ctr_params_from_jax(jparams)
    tr.opt_state = adam_state_from_jax(jopt_state)
    return tr


def jax_trainer(path, slab=1):
    pt.seed(0)
    table = JaxSsdTable(path, JaxTableConfig(
        shard_num=SHARDS,
        accessor_config=JaxAccessorConfig(embedx_dim=DIM, embedx_threshold=0.0)))
    table.load_cold(*_population(table.full_dim))
    return jtrainer.CtrPassTrainer(
        jctr.WideDeep(jctr.CtrConfig(S, D, DIM, HIDDEN)), jax_optimizer.Adam(1e-3), table,
        JaxCacheConfig(capacity=1 << 14, embedx_dim=DIM, embedx_threshold=0.0),
        slab=slab, **NAMES)


def _params_close(tparams, jparams):
    for k, v in jparams["params"].items():
        v = np.asarray(v)
        np.testing.assert_allclose(tparams[k].numpy(), v.T if v.ndim == 2 else v,
                                   err_msg=k, **STATE_TOL)


def _pass_keys(days):
    keys = set()
    for ds in days:
        for b in ds.batch_iter(4096, drop_last=False):
            keys.update(ttrainer._slot_tagged_keys(b, NAMES["sparse_slots"]).reshape(-1).tolist())
    return np.asarray(sorted(keys), np.uint64)


@pytest.mark.parametrize("slab", [1, 4])
def test_pass_trainer_days_match_jax(tmp_path, slab):
    """Two days through ``train_passes`` in both packages over their SSD
    tables: per-day losses, dense params, the pass keys' rows, the tiers'
    counts, and ``evaluate``'s AUC of the final model on each day."""
    jtr = jax_trainer(str(tmp_path / "j"), slab)
    tr = port_trainer(str(tmp_path / "t"), _jax_params(jtr.model), jtr.opt_state, slab)
    try:
        jres = jtr.train_passes(jax_days(), batch_size=B, drop_last=False)
        tres = tr.train_passes(port_days(), batch_size=B, drop_last=False)
        for j, t in zip(jres, tres):
            assert t["steps"] == j["steps"] == 5 and t["samples"] == j["samples"] == RECORDS
            np.testing.assert_allclose(t["loss"], j["loss"], rtol=LOSS_RTOL)
        _params_close(tr.params, jtr.params)
        keys = _pass_keys(port_days())
        got, gf = tr.table.export_full(keys)
        want, wf = jtr.table.export_full(keys)
        assert gf.all() and wf.all()
        np.testing.assert_allclose(got, want, **STATE_TOL)
        ts, js = tr.table.stats(), jtr.table.stats()
        assert (ts["hot_rows"], ts["cold_rows"]) == (js["hot_rows"], js["cold_rows"])
        assert ts["hot_rows"] + ts["cold_rows"] == tr.table.size() == jtr.table.size()
        for d, (tds, jds) in enumerate(zip(port_days(), jax_days())):
            kw = dict(batch_size=B, user_slot="s0" if d == 0 else None)
            te, je = tr.evaluate(tds, **kw), jtr.evaluate(jds, **kw)
            assert abs(te["auc"] - je["auc"]) <= AUC_TOL, (d, te["auc"], je["auc"])
            np.testing.assert_array_equal(te["auc_buckets"].sum(axis=1),
                                          je["auc_buckets"].sum(axis=1))
            if d == 0:
                assert abs(te["wuauc"] - je["wuauc"]) <= AUC_TOL, (te["wuauc"], je["wuauc"])
                assert np.array_equal(te["wuauc_state"]["uid"], je["wuauc_state"]["uid"])
    finally:
        tr.table.close()
        jtr.table.close()


def test_train_passes_is_sequential_passes_bit_for_bit(tmp_path):
    """The overlapped next-day build gives the bits of one
    ``train_from_dataset`` per day (params, optimizer state, losses and
    the table's digest)."""
    pt.seed(0)
    jmodel = jctr.WideDeep(jctr.CtrConfig(S, D, DIM, HIDDEN))
    jparams = _jax_params(jmodel)
    jopt = jax_optimizer.Adam(1e-3).init({"params": dict(jmodel.named_parameters()),
                                          "buffers": {}})
    a = port_trainer(str(tmp_path / "a"), jparams, jopt, slab=4)
    b = port_trainer(str(tmp_path / "b"), jparams, jopt, slab=4)
    try:
        ra = a.train_passes(port_days(), batch_size=B, drop_last=False)
        rb = [b.train_from_dataset(ds, batch_size=B, drop_last=False) for ds in port_days()]
        assert [r["loss"] for r in ra] == [r["loss"] for r in rb]
        for k in a.params:
            assert torch.equal(a.params[k], b.params[k]), k
            assert torch.equal(a.opt_state["m"][k], b.opt_state["m"][k]), k
        assert a.table.digest() == b.table.digest()
    finally:
        a.table.close()
        b.table.close()


def test_tail_padding_reaches_the_sentinel_row():
    lo = np.arange(6, dtype=np.uint32).reshape(2, 3)
    lo32, dense, labels, w = ttrainer._pad_tail(lo, np.ones((2, 4), np.float32),
                                                np.ones(2, np.int32), 5)
    j = jtrainer._pad_tail(lo, np.ones((2, 4), np.float32), np.ones(2, np.int32), 5)
    for x, y in zip((lo32, dense, labels, w), j):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert (lo32[2:] == 0xFFFFFFFF).all() and w.tolist() == [1, 1, 0, 0, 0]


def test_trainer_checkpoints_cross_load(tmp_path):
    """One day trained in each package, then ``save(mode=0)``: the port
    loads the JAX trainer's directory and the JAX trainer the port's, each
    giving the saver's dense params and optimizer state exactly and its
    table rows (the text format's %.8g rendering: equal to what the saver's
    own package reads back)."""
    jtr = jax_trainer(str(tmp_path / "j"))
    start = _jax_params(jtr.model), jax.tree_util.tree_map(np.asarray, jtr.opt_state)
    tr = port_trainer(str(tmp_path / "t"), *start)
    try:
        jtr.train_from_dataset(jax_days()[0], batch_size=B, drop_last=False)
        tr.train_from_dataset(port_days()[0], batch_size=B, drop_last=False)
        jtr.save(str(tmp_path / "jsave"))
        tr.save(str(tmp_path / "tsave"))
        # the port reads the JAX directory, the JAX trainer the port's
        t2 = port_trainer(str(tmp_path / "t2"), *start)
        j2 = jax_trainer(str(tmp_path / "j2"))
        j3 = jax_trainer(str(tmp_path / "j3"))
        t3 = port_trainer(str(tmp_path / "t3"), *start)
        try:
            t2.load(str(tmp_path / "jsave"))
            j2.load(str(tmp_path / "tsave"))
            j3.load(str(tmp_path / "jsave"))
            t3.load(str(tmp_path / "tsave"))
            for k, v in jtr.params["params"].items():
                v = np.asarray(v)
                assert np.array_equal(t2.params[k].numpy(), v.T if v.ndim == 2 else v), k
                w = np.asarray(j2.params["params"][k])
                assert np.array_equal(w.T if w.ndim == 2 else w, tr.params[k].numpy()), k
                for slot in ("m", "v"):
                    jm = np.asarray(jtr.opt_state["slots"][slot]["params"][k])
                    assert np.array_equal(t2.opt_state[slot][k].numpy(),
                                          jm.T if jm.ndim == 2 else jm), (slot, k)
                    jm = np.asarray(j2.opt_state["slots"][slot]["params"][k])
                    assert np.array_equal(jm.T if jm.ndim == 2 else jm,
                                          tr.opt_state[slot][k].numpy()), (slot, k)
            assert int(t2.opt_state["step"]) == int(jtr.opt_state["step"])
            assert int(np.asarray(j2.opt_state["step"])) == int(tr.opt_state["step"])
            keys = _pass_keys(port_days()[:1])
            assert np.array_equal(t2.table.export_full(keys)[0], j3.table.export_full(keys)[0])
            assert t2.table.digest() == j3.table.digest()
            assert np.array_equal(j2.table.export_full(keys)[0], t3.table.export_full(keys)[0])
            assert j2.table.digest() == t3.table.digest()
        finally:
            for t in (t2.table, j2.table, j3.table, t3.table):
                t.close()
    finally:
        tr.table.close()
        jtr.table.close()
