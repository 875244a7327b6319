"""Phase 12 leg B of ``chip_smoke.py`` at a small size, on the card
(``cuda``; jax-free, so it runs on the card's machine).

A Wide&Deep ``CtrPassTrainer`` (4 slots, 2 dense, dim 8, DNN 16) trains
two passes over the SSD tier's scale surface as ``load_ps_config`` builds
it (fp16 values, block-compressed logs, admission after 2 observations,
the background compactor under a 64 MB/s budget), 4,000 cold rows loaded
through a raw ``save_file``/``load_file`` round trip, with a tail of ids
above the population offered to admission. Held on the card and on the
CPU: one B1 and one merge launch a step on the card (none on the CPU),
rejects > 0 and 0 < admitted < the offered new keys, at least every new
key of both passes admitted (the counting sketch never counts low; what it
admits beyond them are collisions in a sketch salted per instance, so the
two runs' counts are not compared), the table grown by exactly the
admitted, a forced compaction drained with the digest unchanged. Both
runs are offered the same keys, and the CPU's losses are within rtol 1e-5
of the card's (cuBLAS and the CPU BLAS sum in another order; TF32 off).
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.data.dataset import InMemoryDataset, SlotDesc
from paddle_tpu_torch.models.ctr import CtrConfig, WideDeep
from paddle_tpu_torch.ops import hot_kernels as hk
from paddle_tpu_torch.ops.sparse_optimizer import ctr_sparse_rows
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.config import load_ps_config
from paddle_tpu_torch.ps.embedding_cache import CacheConfig
from paddle_tpu_torch.ps.ps_trainer import CtrPassTrainer, _slot_tagged_keys
from paddle_tpu_torch.ps.table import SsdSparseTable, TableConfig, make_sparse_table

S, D, DIM, POP, POOL, TAIL, RECORDS, BATCH = 4, 2, 8, 4_000, 500, 4_000, 2_048, 256
KNOBS = {"ssd_value_dtype": "fp16", "ssd_block_compress": True, "ssd_admission_threshold": 2,
         "ssd_admission_sketch_kb": 1024, "ssd_bg_compact": True, "ssd_io_budget_mbps": 64}
NAMES = dict(sparse_slots=[f"s{i}" for i in range(S)], dense_slots=[f"d{i}" for i in range(D)],
             label_slot="label")


def _passes():
    out = []
    for p in range(2):
        rng = np.random.default_rng(70 + p)
        ids = rng.integers(1, POOL, size=(RECORDS, S))
        far = POP + 1 + rng.integers(0, TAIL, size=(RECORDS, S))
        ids = np.where(rng.random((RECORDS, S)) < 0.5, ids, far)
        dense = rng.normal(size=(RECORDS, D))
        label = ((ids % 7 == 0).sum(axis=1) + dense[:, 0] > 1.0).astype(int)
        lines = [" ".join([f"1 {v}" for v in i] + [f"1 {v:.4f}" for v in x] + [f"1 {y}"])
                 for i, x, y in zip(ids, dense, label)]
        ds = InMemoryDataset([SlotDesc(f"s{i}") for i in range(S)]
                             + [SlotDesc(f"d{i}", is_float=True) for i in range(D)]
                             + [SlotDesc("label", is_float=True)], seed=p)
        ds.load_from_lines(lines)
        out.append(ds)
    return out


def _run(device, tmp_path):
    acc = AccessorConfig(embedx_dim=DIM, embedx_threshold=0.0)
    src = SsdSparseTable(str(tmp_path / f"src_{device}"),
                         TableConfig(shard_num=4, accessor_config=acc))
    vals = np.zeros((POP, src.full_dim), np.float32)
    vals[:, 3] = 10.0
    src.load_cold(np.arange(1, POP + 1, dtype=np.uint64), vals)
    raw = str(tmp_path / f"src_{device}.raw")
    assert src.save_file(raw, fmt="raw") == POP
    job = load_ps_config({"hyper_parameters": {"sparse_feature_dim": DIM + 1},
                          "runner": {"sync_mode": "gpubox", "thread_num": 4},
                          "table_parameters": {"storage": "ssd", **KNOBS}})
    table = make_sparse_table(dataclasses.replace(
        job.table, storage="ssd", ssd_path=str(tmp_path / f"cold_{device}"), accessor_config=acc))
    src.close()
    try:
        assert table.load_file(raw, fmt="raw") == POP
        tr = CtrPassTrainer(WideDeep(CtrConfig(S, D, DIM, (16,)),
                                     generator=torch.Generator().manual_seed(0)),
                            Adam(1e-3), table,
                            CacheConfig(capacity=1 << 14, embedx_dim=DIM, embedx_threshold=0.0),
                            device=device, **NAMES)
        passes = _passes()
        per_pass = [np.unique(np.concatenate([_slot_tagged_keys(b, tr.sparse_slots).reshape(-1)
                                              for b in ds.batch_iter(1 << 16, False)]))
                    for ds in passes]
        keys = np.union1d(*per_pass)
        new = keys[~table.export_full(keys)[1]]
        offered, twice = len(new), len(np.intersect1d(np.intersect1d(*per_pass), new))
        st0 = table.stats()
        b1, merge = ctr_sparse_rows.launches, hk.merge_sparse_grads.launches
        res = tr.train_passes(passes, batch_size=BATCH, drop_last=False)
        steps = sum(int(r["steps"]) for r in res)
        st = table.stats()
        admitted = st["admit_admitted"] - st0["admit_admitted"]
        out = {"losses": [r["loss"] for r in res], "steps": steps, "offered": offered,
               "twice": twice,
               "admitted": admitted, "rejects": st["admit_rejects"] - st0["admit_rejects"],
               "grown": table.size() - POP, "b1": ctr_sparse_rows.launches - b1,
               "merge": hk.merge_sparse_grads.launches - merge}
        table.spill(0)
        before = table.digest()
        table.compact_async()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            st = table.stats()
            if st["bg_backlog"] == 0 and st["bg_compactions"] > 0:
                break
            time.sleep(0.05)
        out.update(drained=st["bg_backlog"] == 0 and st["bg_compactions"] > 0,
                   digest_kept=table.digest() == before)
        return out
    finally:
        table.close()


@pytest.mark.cuda
def test_cold_tier_day_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = _run("cuda", tmp_path)
        cpu = _run("cpu", tmp_path)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert card["b1"] == card["merge"] == card["steps"] == 2 * -(-RECORDS // BATCH), card
    assert cpu["b1"] == cpu["merge"] == 0  # the CPU runs the plain versions
    for run in (card, cpu):
        assert run["rejects"] > 0 and 0 < run["admitted"] < run["offered"], run
        assert run["twice"] > 0 and run["admitted"] >= run["twice"], run
        assert run["grown"] == run["admitted"], run
        assert run["drained"] and run["digest_kept"], run
    assert (card["offered"], card["twice"]) == (cpu["offered"], cpu["twice"]), (card, cpu)
    np.testing.assert_allclose(card["losses"], cpu["losses"], rtol=1e-5)
