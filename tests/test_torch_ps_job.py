"""The trainers of a PaddleRec job against the JAX package's, on the CPU.

- ``Trainer.train_from_dataset`` (the dense executor, the reference
  test's 2-layer MLP over the dense slots, ``tests/test_ps_trainer.py``)
  over an ``InMemoryDataset`` and over a ``QueueDataset`` of part files,
  4 epochs from the JAX model's weights (``convert``): per-epoch mean
  losses rtol 1e-5 and the final weights rtol 1e-4 / atol 1e-6 (XLA's and
  PyTorch's CPU BLAS sum the products in another order), one float per
  epoch;
- ``CtrStreamTrainer`` over a ``QueueDataset`` (its ``batch_iter`` has no
  ``drop_last``; the trainer passes only the keywords it takes) against
  JAX's over a local table: losses rtol 1e-5, dense params rtol 1e-4 /
  atol 1e-6, table rows rtol 1e-4 / atol 1e-5 (``test_torch_stream_rpc.py``'s
  tolerances); a resume cursor on a dataset without one raises;
- ``CtrPassTrainer`` over ``RemoteSparseTable`` (two port servers) against
  JAX's over its own servers (``tests/test_ps_rpc.py:573``'s harness):
  losses rtol 1e-5, rows rtol 1e-4 / atol 1e-5, the same ``size()``; and
  against the port's trainer over a local ``MemorySparseTable`` (the
  native engine, the default): losses, pulled rows and ``size()``
  bit-equal (rows created with ``initial_range=0``);
- a tiny ``load_ps_config`` job in ``gpubox`` mode runs one pass in both
  packages (losses rtol 1e-5).
The card's test of ``Trainer.train_from_dataset`` is in
``test_torch_ps_job_cuda.py`` (jax-free, so it runs on the card's machine).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.data import dataset as jds
from paddle_tpu.executor import Trainer as JaxTrainer
from paddle_tpu.models import ctr as jctr
from paddle_tpu.ps import config as jconfig
from paddle_tpu.ps import ps_trainer as jtrainer
from paddle_tpu.ps import rpc as jrpc
from paddle_tpu.ps.accessor import AccessorConfig as JaxAccessorConfig
from paddle_tpu.ps.embedding_cache import CacheConfig as JaxCacheConfig
from paddle_tpu.ps.sgd_rule import SGDRuleConfig as JaxSGDRuleConfig
from paddle_tpu.ps.table import MemorySparseTable as JaxTable
from paddle_tpu.ps.table import TableConfig as JaxTableConfig
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import (adam_state_from_jax, ctr_params_from_jax,
                                      vision_params_from_jax)
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.data import dataset as tds
from paddle_tpu_torch.executor import Trainer
from paddle_tpu_torch.models import ctr as tctr
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.ps import config as tconfig
from paddle_tpu_torch.ps import ps_trainer as ttrainer
from paddle_tpu_torch.ps import rpc
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.embedding_cache import CacheConfig
from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig
from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

pytestmark = pytest.mark.usefixtures("jax_native")

S, D = 3, 2
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
ROW_TOL = dict(rtol=1e-4, atol=1e-5)
NAMES = dict(sparse_slots=[f"s{i}" for i in range(S)],
             dense_slots=[f"d{i}" for i in range(D)], label_slot="label")


def _lines(n, seed=0, nid=48):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, nid, S)
        dense = rng.normal(size=D)
        label = int((ids % 5 == 0).sum() + dense[0] > 1.0)
        out.append(" ".join([f"1 {v}" for v in ids] + [f"1 {v:.4f}" for v in dense]
                            + [f"1 {label}"]))
    return out


def _schema(mod):
    return ([mod.SlotDesc(f"s{i}", is_float=False, max_len=1) for i in range(S)]
            + [mod.SlotDesc(f"d{i}", is_float=True, max_len=1) for i in range(D)]
            + [mod.SlotDesc("label", is_float=True, max_len=1)])


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    """1024 lines in 4 part files."""
    d = tmp_path_factory.mktemp("ps_job")
    lines = _lines(1024)
    files = []
    for f in range(4):
        p = d / f"part-{f}"
        p.write_text("".join(l + "\n" for l in lines[f * 256:(f + 1) * 256]))
        files.append(str(p))
    return files


def _dataset(mod, files, queue):
    ds = mod.QueueDataset(_schema(mod)) if queue else mod.InMemoryDataset(_schema(mod), seed=0)
    ds.set_filelist(files)
    if not queue:
        ds.load_into_memory(num_threads=1)
    return ds


def _feed(batch):
    dense = np.concatenate([batch[f"d{i}"][0] for i in range(D)], axis=1)
    return dense.astype(np.float32), batch["label"][0][:, 0].astype(np.float32)


class _JaxMLP(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.l1 = jnn.Linear(D, 16)
        self.l2 = jnn.Linear(16, 1)

    def forward(self, x):
        return self.l2(jnn.functional.relu(self.l1(x)))[..., 0]


class _MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.l1 = tnn.Linear(D, 16)
        self.l2 = tnn.Linear(16, 1)

    def forward(self, x):
        return self.l2(tnn.functional.relu(self.l1(x)))[..., 0]


def _dense_trainers(device="cpu"):
    pt.seed(0)
    j = JaxTrainer(_JaxMLP(), jax_optimizer.Adam(1e-2),
                   jnn.functional.binary_cross_entropy_with_logits)
    model = _MLP()
    model.load_state_dict(vision_params_from_jax(
        {"params": {k: np.asarray(v) for k, v in j.state["params"].items()}}))
    t = Trainer(model, Adam(1e-2), tnn.functional.binary_cross_entropy_with_logits,
                device=device)
    return j, t


@pytest.mark.parametrize("queue", [False, True], ids=["in_memory", "queue"])
def test_trainer_train_from_dataset_matches_jax(parts, queue):
    j, t = _dense_trainers()
    jl = j.train_from_dataset(_dataset(jds, parts, queue), _feed, batch_size=128, epochs=4)
    tl = t.train_from_dataset(_dataset(tds, parts, queue), _feed, batch_size=128, epochs=4)
    assert len(tl) == 4 and all(type(x) is float for x in tl)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0]
    assert t.global_step == 4 * 8
    want = vision_params_from_jax({"params": {k: np.asarray(v)
                                              for k, v in j.state["params"].items()}})
    for k, w in want.items():
        np.testing.assert_allclose(t.state["params"][k].numpy(), w.numpy(), err_msg=k,
                                   **PARAM_TOL)


def test_trainer_train_from_dataset_passes_drop_last_where_taken(parts):
    _, t = _dense_trainers()
    ds = _dataset(tds, parts, False)
    assert len(t.train_from_dataset(ds, _feed, batch_size=300, drop_last=True)) == 1
    assert t.global_step == 3
    t.train_from_dataset(ds, _feed, batch_size=300, drop_last=False)
    assert t.global_step == 3 + 4
    empty = tds.QueueDataset(_schema(tds))
    assert np.isnan(t.train_from_dataset(empty, _feed, batch_size=300)[0])


# -- CtrStreamTrainer over a QueueDataset ----------------------------------------

def test_stream_trainer_over_a_queue_dataset_matches_jax(parts):
    pt.seed(0)
    jtable = JaxTable(JaxTableConfig(shard_num=2, backend="python"))
    ttable = MemorySparseTable(TableConfig(shard_num=2, backend="python"))
    try:
        j = jtrainer.CtrStreamTrainer(
            jctr.DeepFM(jctr.CtrConfig(num_sparse_slots=S, num_dense=D, embedx_dim=8,
                                       dnn_hidden=(8,))),
            jax_optimizer.Adam(1e-2), jtable, embedx_dim=8, **NAMES)
        t = ttrainer.CtrStreamTrainer(tctr.DeepFM(tctr.CtrConfig(S, D, 8, (8,))), Adam(1e-2),
                                      ttable, embedx_dim=8, device="cpu", **NAMES)
        t.params = ctr_params_from_jax(jax.tree_util.tree_map(np.asarray, j.params))
        t.opt_state = adam_state_from_jax(jax.tree_util.tree_map(np.asarray, j.opt_state))
        for epoch in range(2):
            jr = j.train_from_dataset(_dataset(jds, parts, True), batch_size=100)
            tr = t.train_from_dataset(_dataset(tds, parts, True), batch_size=100)
            assert tr["steps"] == jr["steps"] == 10  # the 24-line tail is not a batch
            np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=LOSS_RTOL)
        want = ctr_params_from_jax(jax.tree_util.tree_map(np.asarray, j.params))
        for k, w in want.items():
            np.testing.assert_allclose(t.params[k].numpy(), w.numpy(), err_msg=k, **PARAM_TOL)
        keys = np.unique(np.concatenate([
            ttrainer._slot_tagged_keys(b, NAMES["sparse_slots"]).reshape(-1)
            for b in _dataset(tds, parts, False).batch_iter(1024, drop_last=False)]))
        np.testing.assert_allclose(ttable.pull_sparse(keys, create=False),
                                   jtable.pull_sparse(keys, create=False), **ROW_TOL)
        # a resume cursor goes to a batch_iter that takes one, and only there
        r = t.train_from_dataset(_dataset(tds, parts, True), batch_size=100, start_batch=7)
        assert r["steps"] == 3

        class NoCursor:
            def batch_iter(self, batch_size):
                return iter(())

        with pytest.raises(EnforceNotMet, match="start_batch"):
            t.train_from_dataset(NoCursor(), batch_size=100, start_batch=1)
        assert t.train_from_dataset(NoCursor(), batch_size=100)["steps"] == 0
    finally:
        ttable.close()


# -- CtrPassTrainer over RemoteSparseTable -----------------------------------------

_PASS_DIM = 4


def _pass_cfg(mod_table, mod_acc, mod_sgd, **kw):
    acc = mod_acc(embedx_dim=_PASS_DIM, embedx_threshold=0.0,
                  sgd=mod_sgd(initial_range=0.0))
    return mod_table(shard_num=4, accessor_config=acc, **kw)


def _jax_pass(table, lines):
    pt.seed(0)
    ds = jds.InMemoryDataset(_schema(jds), seed=0)
    ds.load_from_lines(lines)
    tr = jtrainer.CtrPassTrainer(
        jctr.DeepFM(jctr.CtrConfig(num_sparse_slots=S, num_dense=D, embedx_dim=_PASS_DIM,
                                   dnn_hidden=(8,))),
        jax_optimizer.Adam(1e-2), table,
        JaxCacheConfig(capacity=1 << 9, embedx_dim=_PASS_DIM, embedx_threshold=0.0), **NAMES)
    start = {k: np.asarray(v) for k, v in tr.model.named_parameters()}
    return tr, start, tr.train_from_dataset(ds, batch_size=128)["loss"]


def _port_pass(table, lines, start):
    ds = tds.InMemoryDataset(_schema(tds), seed=0)
    ds.load_from_lines(lines)
    tr = ttrainer.CtrPassTrainer(
        tctr.DeepFM(tctr.CtrConfig(S, D, _PASS_DIM, (8,))), Adam(1e-2), table,
        CacheConfig(capacity=1 << 9, embedx_dim=_PASS_DIM, embedx_threshold=0.0),
        device="cpu", **NAMES)
    tr.params = ctr_params_from_jax(start)
    tr.opt_state = Adam(1e-2).init(tr.params)
    r = tr.train_from_dataset(ds, batch_size=128)
    assert tr.cache.state is None  # end_pass flushed and released the pass
    return r["loss"]


class _Servers:
    def __init__(self, rpc_mod, cfg):
        self.servers = [rpc_mod.NativePsServer(n_trainers=1) for _ in range(2)]
        self.client = rpc_mod.RpcPsClient([f"127.0.0.1:{s.port}" for s in self.servers])
        self.client.create_sparse_table(0, cfg)
        self.table = rpc_mod.RemoteSparseTable(self.client, 0, cfg)

    def close(self):
        self.client.close()
        for s in self.servers:
            s.close()


def test_pass_trainer_over_remote_table_matches_jax_and_the_local_table():
    lines = _lines(512)
    jcfg = _pass_cfg(JaxTableConfig, JaxAccessorConfig, JaxSGDRuleConfig)
    tcfg = _pass_cfg(TableConfig, AccessorConfig, SGDRuleConfig)
    jc, tc = _Servers(jrpc, jcfg), _Servers(rpc, tcfg)
    local = MemorySparseTable(tcfg)
    try:
        tc.client.reset_op_counts()
        _, start, jloss = _jax_pass(jc.table, lines)
        tloss = _port_pass(tc.table, lines, start)
        ops = tc.client.reset_op_counts()
        assert ops.get("export_full") and ops.get("import_full"), ops  # build and flush
        lloss = _port_pass(local, lines, start)
        np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
        assert tloss == lloss
        rng = np.random.default_rng(1)
        probe = np.unique(rng.integers(0, 48, 400).astype(np.uint64)
                          + (rng.integers(0, S, 400).astype(np.uint64) << np.uint64(32)))
        got = tc.client.pull_sparse(0, probe, create=False)
        np.testing.assert_array_equal(got, local.pull_sparse(probe, create=False))
        np.testing.assert_allclose(got, jc.client.pull_sparse(0, probe, create=False),
                                   **ROW_TOL)
        assert tc.table.size() == local.size() == jc.table.size() == 3 * 48
    finally:
        local.close()
        jc.close()
        tc.close()


def test_gpubox_job_from_load_ps_config_runs_one_pass():
    cfg = {"hyper_parameters": {"optimizer": {"class": "Adam", "learning_rate": 0.01},
                                "sparse_inputs_slots": S + 1, "sparse_feature_dim": 5,
                                "dense_input_dim": D, "fc_sizes": [8]},
           "runner": {"sync_mode": "gpubox", "thread_num": 4}}
    tjob, jjob = tconfig.load_ps_config(cfg), jconfig.load_ps_config(cfg)
    assert tjob.trainer == jjob.trainer == "CtrPassTrainer"
    lines = _lines(384, seed=4)
    jtable = JaxTable(JaxTableConfig(shard_num=4, backend="python",
                                     accessor_config=jjob.table.accessor_config))
    ttable = MemorySparseTable(dataclasses.replace(tjob.table, backend="python"))
    try:
        pt.seed(0)
        jds_ = jds.InMemoryDataset(_schema(jds), seed=0)
        jds_.load_from_lines(lines)
        jtr = jtrainer.CtrPassTrainer(
            jctr.DeepFM(jjob.make_model_config()), jjob.make_optimizer(), jtable,
            JaxCacheConfig(capacity=1 << 10, embedx_dim=4), **NAMES)
        start = {k: np.asarray(v) for k, v in jtr.model.named_parameters()}
        jloss = jtr.train_from_dataset(jds_, batch_size=128)["loss"]
        tds_ = tds.InMemoryDataset(_schema(tds), seed=0)
        tds_.load_from_lines(lines)
        opt = tjob.make_optimizer()
        ttr = ttrainer.CtrPassTrainer(tctr.DeepFM(tjob.make_model_config()), opt, ttable,
                                      CacheConfig(capacity=1 << 10, embedx_dim=4),
                                      device="cpu", **NAMES)
        ttr.params = ctr_params_from_jax(start)
        ttr.opt_state = opt.init(ttr.params)
        r = ttr.train_from_dataset(tds_, batch_size=128)
        assert r["steps"] == 3 and np.isfinite(r["loss"])
        np.testing.assert_allclose(r["loss"], jloss, rtol=LOSS_RTOL)
        assert ttable.size() == jtable.size() == 3 * 48
    finally:
        ttable.close()
