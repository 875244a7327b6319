"""The default RAM table in the port against the JAX package's, on the CPU.

Both packages' ``TableConfig.backend`` defaults to ``"auto"``, and both
then run the native RAM engine (the port's copy of ``csrc/sparse_table.cc``
and the JAX package's): ``MemorySparseTable(TableConfig())``,
``make_sparse_table``, ``PsServerHandle``'s tables and a fleet's local
tables. New rows come from a per-key draw, so with a nonzero
``initial_range`` the two packages' rows are equal by key, bit for bit:

- the table operations (pull with create and slots, pushes under each of
  the four rules, shrink, the save filter of modes 0–3 with its
  ``update_stat_after_save``, the table files): rows sorted by key, the
  digest and the shard sizes are equal after every step;
- one ``CtrPassTrainer`` pass over a default table in each package: the
  pass builds its rows from the engine and flushes them back through it.
  The sparse rule is ``naive`` at learning rate 0, so the flushed rows
  (show, click, the scores, embedx created past its threshold with its
  own per-key draw) do not carry the DNN's last-bit differences between
  XLA's and PyTorch's BLAS: they are held bitwise by key; the loss to
  rtol 1e-5 (``test_torch_ps_job.py``'s tolerance).
"""

import os

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import distributed as jdist
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.data import dataset as jds
from paddle_tpu.models import ctr as jctr
from paddle_tpu.ps import ps_trainer as jtrainer
from paddle_tpu.ps.accessor import AccessorConfig as JaxAccessorConfig
from paddle_tpu.ps.client import PsServerHandle as JaxPsServerHandle
from paddle_tpu.ps.embedding_cache import CacheConfig as JaxCacheConfig
from paddle_tpu.ps.sgd_rule import SGDRuleConfig as JaxSGDRuleConfig
from paddle_tpu.ps.table import MemorySparseTable as JaxTable
from paddle_tpu.ps.table import TableConfig as JaxTableConfig
from paddle_tpu.ps.table import make_sparse_table as jax_make_sparse_table
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.convert import ctr_params_from_jax
from paddle_tpu_torch.data import dataset as tds
from paddle_tpu_torch.models import ctr as tctr
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.ps import ps_trainer as ttrainer
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.client import PsServerHandle
from paddle_tpu_torch.ps.embedding_cache import CacheConfig
from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig
from paddle_tpu_torch.ps.table import (MemorySparseTable, NativeMemorySparseTable, TableConfig,
                                       make_sparse_table)
from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

# the JAX default table is native only when its library loaded
pytestmark = pytest.mark.usefixtures("jax_native")

DIM = 4
RULES = ("naive", "adagrad", "std_adagrad", "adam")


def _sorted(keys, values):
    order = np.argsort(keys, kind="stable")
    return keys[order], values[order]


def _same(t, j, what):
    assert t.backend == j.backend == "native", what
    assert t.digest() == j.digest(), what
    assert np.array_equal(t.shard_sizes(), j.shard_sizes()), what
    tk, tv = _sorted(*t.snapshot_items(0))
    jk, jv = _sorted(*j.snapshot_items(0))
    assert np.array_equal(tk, jk) and np.array_equal(tv, jv), what


def test_default_tables_run_the_native_engine():
    """Every way a user gets a RAM table with the default config gives the
    native engine, in both packages; "python" stays on request."""
    made = [MemorySparseTable(TableConfig()), MemorySparseTable(),
            make_sparse_table(TableConfig())]
    server = PsServerHandle()
    made.append(server.create_sparse_table(0))
    fleet = tdist.Fleet().init(tdist.UserDefinedRoleMaker(role=tdist.Role.WORKER),
                               strategy=tdist.DistributedStrategy())
    made.append(fleet.register_sparse_table(1))
    jserver = JaxPsServerHandle()
    jfleet = jdist.Fleet().init(jdist.UserDefinedRoleMaker(role=jdist.Role.WORKER),
                                strategy=jdist.DistributedStrategy())
    jmade = [JaxTable(JaxTableConfig()), jax_make_sparse_table(JaxTableConfig()),
             jserver.create_sparse_table(0), jfleet.register_sparse_table(1)]
    try:
        assert all(isinstance(t, NativeMemorySparseTable) for t in made)
        assert {t.backend for t in made} == {j.backend for j in jmade} == {"native"}
        assert TableConfig().backend == JaxTableConfig().backend == "auto"
        py = MemorySparseTable(TableConfig(backend="python"))
        assert type(py) is MemorySparseTable and py.backend == "python"
        assert py.print_table_stat() == JaxTable(JaxTableConfig(backend="python")) \
            .print_table_stat()
        py.close()
        assert made[0].print_table_stat() == jmade[0].print_table_stat()
    finally:
        for t in made:
            t.close()


def _push(rng, keys, slots):
    n = len(keys)
    pv = np.zeros((n, 4 + DIM), np.float32)
    pv[:, 0] = slots
    pv[:, 1] = rng.integers(1, 6, n)
    pv[:, 2] = rng.integers(0, 3, n).clip(max=pv[:, 1])
    pv[:, 3:] = rng.normal(scale=0.5, size=(n, 1 + DIM)).astype(np.float32)
    return pv


@pytest.mark.parametrize("rule", RULES)
def test_default_table_ops_match_jax_default(tmp_path, rule):
    """Pull with create (slots, ``initial_range`` 0.1), three rounds of
    pushes with duplicate keys, shrink, and each save mode: the port's
    default table holds the JAX default table's rows bitwise by key."""
    acc = dict(embedx_dim=DIM, embedx_threshold=3.0, embed_sgd_rule=rule, embedx_sgd_rule=rule)
    t = MemorySparseTable(TableConfig(shard_num=3, accessor_config=AccessorConfig(
        sgd=SGDRuleConfig(initial_range=0.1), **acc)))
    j = JaxTable(JaxTableConfig(shard_num=3, accessor_config=JaxAccessorConfig(
        sgd=JaxSGDRuleConfig(initial_range=0.1), **acc)))
    try:
        rng = np.random.default_rng(11)
        keys = np.unique(rng.integers(1, 1 << 40, 400).astype(np.uint64))
        slots = (keys % 7).astype(np.int32)
        assert np.array_equal(t.pull_sparse(keys, slots), j.pull_sparse(keys, slots))
        _same(t, j, "created")
        for r in range(3):
            sel = rng.choice(len(keys), 300)  # duplicates: the tables merge them
            pv = _push(rng, keys[sel], slots[sel])
            t.push_sparse(keys[sel], pv)
            j.push_sparse(keys[sel], pv)
            _same(t, j, f"push {r}")
            assert np.array_equal(t.pull_sparse(keys, create=False),
                                  j.pull_sparse(keys, create=False))
        erased = t.shrink()
        assert erased == j.shrink() and 0 < erased < len(keys)
        _same(t, j, "shrunk")
        for mode in (1, 2, 3, 0):
            out = {}
            for name, table in (("port", t), ("jax", j)):
                d = str(tmp_path / f"{name}_{mode}")
                n = table.save(d, mode=mode)
                out[name] = n, {f: sorted(open(os.path.join(d, f)).read().splitlines())
                                for f in sorted(os.listdir(d)) if f.startswith("part-")}
            assert out["port"] == out["jax"], mode
            _same(t, j, f"after the save of mode {mode}")
    finally:
        t.close()


S, D = 3, 2
NAMES = dict(sparse_slots=[f"s{i}" for i in range(S)], dense_slots=[f"d{i}" for i in range(D)],
             label_slot="label")


def _lines(n, seed, nid=48):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, nid, S)
        dense = rng.normal(size=D)
        label = int((ids % 5 == 0).sum() + dense[0] > 1.0)
        out.append(" ".join([f"1 {v}" for v in ids] + [f"1 {v:.4f}" for v in dense]
                            + [f"1 {label}"]))
    return out


def _dataset(mod, lines):
    schema = ([mod.SlotDesc(f"s{i}", is_float=False, max_len=1) for i in range(S)]
              + [mod.SlotDesc(f"d{i}", is_float=True, max_len=1) for i in range(D)]
              + [mod.SlotDesc("label", is_float=True, max_len=1)])
    ds = mod.InMemoryDataset(schema, seed=0)
    ds.load_from_lines(lines)
    return ds


def test_pass_trainer_over_default_tables_matches_jax_by_key():
    """One ``CtrPassTrainer`` pass (3 steps of 128) over each package's
    default table, from the same weights: the flushed rows bitwise by key
    (the sparse rule at learning rate 0, module docstring), the loss rtol
    1e-5."""
    acc = dict(embedx_dim=DIM, embedx_threshold=2.0, embed_sgd_rule="naive",
               embedx_sgd_rule="naive")
    ttable = MemorySparseTable(TableConfig(shard_num=4, accessor_config=AccessorConfig(
        sgd=SGDRuleConfig(learning_rate=0.0, initial_range=0.1), **acc)))
    jtable = JaxTable(JaxTableConfig(shard_num=4, accessor_config=JaxAccessorConfig(
        sgd=JaxSGDRuleConfig(learning_rate=0.0, initial_range=0.1), **acc)))
    lines = _lines(384, seed=4)
    try:
        assert ttable.backend == jtable.backend == "native"
        pt.seed(0)
        ccfg = dict(capacity=1 << 10, embedx_dim=DIM, embedx_threshold=2.0)
        jtr = jtrainer.CtrPassTrainer(
            jctr.DeepFM(jctr.CtrConfig(S, D, DIM, (8,))), jax_optimizer.Adam(1e-2), jtable,
            JaxCacheConfig(sgd=JaxSGDRuleConfig(learning_rate=0.0), embed_rule="naive",
                           embedx_rule="naive", **ccfg), **NAMES)
        start = {k: np.asarray(v) for k, v in jtr.model.named_parameters()}
        jloss = jtr.train_from_dataset(_dataset(jds, lines), batch_size=128)["loss"]
        ttr = ttrainer.CtrPassTrainer(
            tctr.DeepFM(tctr.CtrConfig(S, D, DIM, (8,))), Adam(1e-2), ttable,
            CacheConfig(sgd=SGDRuleConfig(learning_rate=0.0), embed_rule="naive",
                        embedx_rule="naive", **ccfg), device="cpu", **NAMES)
        ttr.params = ctr_params_from_jax(start)
        ttr.opt_state = ttr.optimizer.init(ttr.params)
        r = ttr.train_from_dataset(_dataset(tds, lines), batch_size=128)
        assert r["steps"] == 3
        np.testing.assert_allclose(r["loss"], jloss, rtol=1e-5)
        assert ttable.size() == jtable.size() == 3 * 48
        _same(ttable, jtable, "after the pass")
        keys, rows = ttable.snapshot_items(0)
        assert (rows[:, 6] != 0).any()  # has_embedx (naive keeps no state): created in the pass
    finally:
        ttable.close()
