"""The job checkpoint's hot-tier resume on the card (``cuda``; jax-free, so
it runs on the card's machine).

At the CPU tests' size (3 slots, 2 dense, dim 8, DNN (8,), batch 128, 640
records, ids from 120 a slot through a 256-row tier: eviction churn), a
run that checkpoints every 2 batches, restored from its newest checkpoint
into a fresh table and trainer, ends bit-identical on the card to the
card's uninterrupted run at the same cadence (rows, digest, dense params,
Adam state; B2 and B4 launch once a step), and within the card-vs-CPU
tolerances of ``chip_smoke.py`` (params rtol 1e-4 / atol 1e-6, rows rtol
1e-4 / atol 1e-5: cuBLAS and the CPU BLAS sum the dense products in
another order; TF32 off) of the same resume on the CPU."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.data.dataset import InMemoryDataset, SlotDesc
from paddle_tpu_torch.io.job_checkpoint import JobCheckpointManager
from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
from paddle_tpu_torch.ops import hot_kernels
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.hot_tier import HotTierConfig
from paddle_tpu_torch.ps.ps_trainer import CtrStreamTrainer
from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig
from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

S, D, DIM, BATCH, ROWS, EVERY = 3, 2, 8, 128, 640, 2


def _dataset():
    rng = np.random.default_rng(0)
    lines = []
    for _ in range(ROWS):
        ids = rng.integers(0, 120, S)
        dense = rng.normal(size=D)
        label = int((ids % 5 == 0).sum() + dense[0] > 1.0)
        lines.append(" ".join([f"1 {v}" for v in ids] + [f"1 {v:.4f}" for v in dense]
                              + [f"1 {label}"]))
    ds = InMemoryDataset([SlotDesc(f"s{i}") for i in range(S)]
                         + [SlotDesc(f"d{i}", is_float=True) for i in range(D)]
                         + [SlotDesc("label", is_float=True)], seed=0)
    ds.load_from_lines(lines)
    return ds


def _job(device, root=None):
    table = MemorySparseTable(TableConfig(shard_num=4, accessor_config=AccessorConfig(
        sgd=SGDRuleConfig(initial_range=0.0))))
    model = DeepFM(CtrConfig(S, D, DIM, (8,)), generator=torch.Generator().manual_seed(0))
    tr = CtrStreamTrainer(model, Adam(1e-2), table, hot_tier=HotTierConfig(capacity=256),
                          device=device, sparse_slots=[f"s{i}" for i in range(S)],
                          dense_slots=[f"d{i}" for i in range(D)], label_slot="label")
    mgr = None
    if root is not None:
        mgr = JobCheckpointManager(str(root), max_keep=8)
        mgr.register_sparse("ctr", table)
    return table, tr, mgr


def _final(table, tr):
    tr.hot_tier.flush()
    k, v = table.snapshot_items()
    i = np.argsort(k)
    return k[i], v[i], table.digest(), tr.train_state()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


def _resume(device, tmp):
    table, tr, mgr = _job(device, tmp / f"job_{device}")
    tr.train_from_dataset(_dataset(), batch_size=BATCH, checkpoint=mgr,
                          checkpoint_every=EVERY)
    mgr.stop()
    restored = mgr.load_latest()
    assert restored.cursor == {"batch": 4, "batch_size": BATCH}
    table, tr, _ = _job(device)
    restored.restore_sparse("ctr", table)
    tr.restore_train_state(restored.dense)
    assert all(p.device.type == device for p in tr.params.values())
    tr.train_from_dataset(_dataset(), batch_size=BATCH, start_batch=restored.cursor,
                          checkpoint=mgr.__class__(str(tmp / f"tail_{device}"), max_keep=8),
                          checkpoint_every=EVERY)
    return _final(table, tr)


@pytest.mark.cuda
def test_hot_tier_resume_on_the_card_is_bitwise_and_near_the_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        table, tr, mgr = _job("cuda", tmp_path / "oracle")
        for fn in (hot_kernels.hot_probe_gather, hot_kernels.hot_scatter_apply):
            fn.launches = 0
        out = tr.train_from_dataset(_dataset(), batch_size=BATCH, checkpoint=mgr,
                                    checkpoint_every=EVERY)
        mgr.stop()
        steps = int(out["steps"])
        assert hot_kernels.hot_probe_gather.launches == steps == \
            hot_kernels.hot_scatter_apply.launches
        want = _final(table, tr)
        got = _resume("cuda", tmp_path)
        cpu = _resume("cpu", tmp_path)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    for a, b in zip(_leaves(got[3]), _leaves(want[3])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], cpu[0])
    np.testing.assert_allclose(got[1], cpu[1], rtol=1e-4, atol=1e-5)
    for a, b in zip(_leaves(got[3]), _leaves(cpu[3])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
