"""``parallel.heter_pipeline`` (``HeterPipelineTrainer``, ``SectionConfig``)
against the JAX package, on the CPU.

The same sections run through both packages' trainers and give the same
outputs in the same order (exact). Concurrency is proven by a barrier,
not by time: two sections' calls must be inside their functions at once.
The HeterPS workload (host pull → dense step → host push, with keys that
recur across micro-batches) leaves the table and the dense layer bitwise
equal to a serial run of the same three functions in one thread that
replays the pipeline's recorded order of table operations (a pull may
run before an earlier item's push: the reference's asynchronous
semantics, which the replay keeps).
"""

import threading

import numpy as np
import pytest
import torch

from paddle_tpu.parallel.heter_pipeline import HeterPipelineTrainer as JHeterPipelineTrainer
from paddle_tpu.parallel.heter_pipeline import SectionConfig as JSectionConfig
from paddle_tpu_torch.parallel.heter_pipeline import HeterPipelineTrainer, SectionConfig

WAIT = 60.0   # seconds an event may take before the test fails (never reached when right)


def test_single_thread_sections_preserve_order_as_jax():
    fns = (lambda x: x * 2, lambda x: x + 1, lambda x: (x, x % 3))
    got = HeterPipelineTrainer([SectionConfig(f) for f in fns]).run(range(40))
    want = JHeterPipelineTrainer([JSectionConfig(f) for f in fns]).run(range(40))
    assert got == want == [(x * 2 + 1, (x * 2 + 1) % 3) for x in range(40)]


def test_thread_pool_section_processes_every_item():
    seen, lock = [], threading.Lock()

    def double(x):
        with lock:
            seen.append(x)
        return x * 2

    tr = HeterPipelineTrainer([SectionConfig(double, num_threads=4)], channel_capacity=2)
    out = tr.run(range(50))
    assert sorted(out) == [x * 2 for x in range(50)]
    assert sorted(seen) == list(range(50))
    assert len(tr.spans[0]) == 50


def test_sections_overlap_proven_by_events():
    """Section 0's call on item 1 and section 1's call on item 0 meet at a
    barrier of two: only sections that run side by side get through it
    (a serial trainer would break it). Their recorded spans overlap."""
    meet = threading.Barrier(2, timeout=WAIT)

    def head(x):
        if x == 1:
            meet.wait()
        return x

    def tail(x):
        if x == 0:
            meet.wait()
        return x

    tr = HeterPipelineTrainer([SectionConfig(head), SectionConfig(tail)])
    assert tr.run(range(6)) == list(range(6))
    (h1_start, h1_end), (t0_start, t0_end) = tr.spans[0][1], tr.spans[1][0]
    assert max(h1_start, t0_start) <= min(h1_end, t0_end)


def test_error_propagates_without_hanging():
    def boom(x):
        if x == 3:
            raise ValueError("section exploded")
        return x

    for cls, cfg in ((HeterPipelineTrainer, SectionConfig), (JHeterPipelineTrainer,
                                                             JSectionConfig)):
        tr = cls([cfg(lambda x: x), cfg(boom), cfg(lambda x: x)], channel_capacity=2)
        with pytest.raises(ValueError, match="section exploded"):
            tr.run(range(100))


def _ctr_workload(seed=0, n_batches=12):
    """(batches, the three section fns, the table, the losses list): the
    JAX test's HeterPS shape at a small size — host pull, a dense step of
    the port (a Linear under SGD, on the CPU), host push."""
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

    torch.manual_seed(seed)
    table = MemorySparseTable(TableConfig(shard_num=4,
                                          accessor_config=AccessorConfig(embedx_dim=4)))
    dense = Linear(5 * 5, 1, generator=torch.Generator().manual_seed(seed))
    losses, order, lock = [], [], threading.Lock()

    def cpu_pull(batch):
        i, keys, label = batch
        with lock:   # the table op and its place in the order, as one step
            pulled = table.pull_sparse(keys.ravel())
            order.append(("pull", i))
        return i, keys, torch.from_numpy(pulled[:, 2:].reshape(keys.shape[0], 25)), label

    def dev_train(item):
        i, keys, emb, label = item
        emb = emb.requires_grad_(True)
        out = dense(emb)[:, 0]
        loss = ((out - torch.from_numpy(label)) ** 2).mean()
        grads = torch.autograd.grad(loss, [emb, *dense.parameters()])
        with torch.no_grad():
            for p, g in zip(dense.parameters(), grads[1:]):
                p -= 0.1 * g
        losses.append(float(loss.detach()))
        return i, keys, grads[0].numpy()

    def cpu_push(item):
        i, keys, ge = item
        n = keys.size
        push = np.zeros((n, 8), np.float32)
        push[:, 1] = 1.0
        push[:, 3:] = ge.reshape(n, 5)
        with lock:
            table.push_sparse(keys.ravel(), push)
            order.append(("push", i))
        return keys.shape[0]

    rng = np.random.default_rng(seed)
    batches = []
    for i in range(n_batches):
        keys = rng.integers(1, 500, (16, 5)).astype(np.uint64)
        batches.append((i, keys, (keys.sum(axis=1) % 2).astype(np.float32)))
    return batches, (cpu_pull, dev_train, cpu_push), table, losses, dense, order


def replay(batches, fns, order):
    """The three functions in one thread, table ops in ``order``: a push
    first runs the dense steps up to its item (in item order)."""
    pulled, trained = {}, 0
    for op, i in order:
        if op == "pull":
            pulled[i] = fns[0](batches[i])
            continue
        while trained <= i:
            pulled[trained] = fns[1](pulled[trained])
            trained += 1
        fns[2](pulled[i])


def test_heter_ctr_workload_equals_a_serial_run_bitwise():
    batches, fns, table, losses, dense, order = _ctr_workload()
    tr = HeterPipelineTrainer([SectionConfig(fns[0], "cpu"), SectionConfig(fns[1], "gpu"),
                               SectionConfig(fns[2], "cpu")], channel_capacity=2)
    assert tr.run(batches) == [16] * 12
    assert [i for op, i in order if op == "pull"] == list(range(12))
    s_batches, s_fns, s_table, s_losses, s_dense, s_order = _ctr_workload()
    replay(s_batches, s_fns, order)
    assert s_order == order
    keys = np.unique(np.concatenate([k.ravel() for _, k, _ in batches]))
    np.testing.assert_array_equal(table.export_full(keys)[0], s_table.export_full(keys)[0])
    assert losses == s_losses and losses[-1] < losses[0]
    for p, q in zip(dense.parameters(), s_dense.parameters()):
        assert torch.equal(p, q)
