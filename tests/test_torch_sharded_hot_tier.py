"""The port's sharded hot tier: ``hot_probe`` (B3) and streaming CTR
training over a K-shard mesh (``CtrStreamTrainer`` with
``HotTierConfig(mesh=...)``), on the CPU.

- ``hot_probe``'s plain version against the JAX kernel in interpret
  mode: bitwise (a hash, a compare and a select).
- The sharded trainer against the JAX package's on an 8-device mesh
  (the ``tests/test_hot_tier.py`` mesh harness: 512 records, ids from 60
  per slot, capacity 512, batch 128), both with their kernels (JAX:
  ``"pallas"`` in interpret mode; the port: ``"auto"``, plain versions
  on the CPU): losses to rtol 1e-5, dense params and table rows to the
  ``PARAM_TOL``/``ROW_TOL`` of ``test_torch_hot_tier.py`` — different
  BLAS for the dense tower, XLA's FMA contraction of Adam and its own
  all-reduce order.
- Inside the port, bitwise: ``kernels="auto"`` ≡ ``"unfused"`` through
  eviction churn; and the sharded tier against the single-card tier
  within atol 1e-6, the bound the JAX package holds its own sharded tier
  to (averaging the dense grads over the ranks associates the batch mean
  differently from the single card's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.core import mesh as jax_mesh
from paddle_tpu.data.dataset import InMemoryDataset as JaxDataset
from paddle_tpu.data.dataset import SlotDesc as JaxSlotDesc
from paddle_tpu.models.ctr import CtrConfig as JaxCtrConfig
from paddle_tpu.models.ctr import DeepFM as JaxDeepFM
from paddle_tpu.ops.hot_kernels import hot_probe as jax_hot_probe
from paddle_tpu.ps.device_hash import split_keys as jax_split_keys
from paddle_tpu.ps.hot_tier import HotTierConfig as JaxHotTierConfig
from paddle_tpu.ps.ps_trainer import CtrStreamTrainer as JaxTrainer
from paddle_tpu.ps.table import MemorySparseTable as JaxTable
from paddle_tpu.ps.table import TableConfig as JaxTableConfig
from paddle_tpu_torch.convert import (adam_state_from_jax, deepfm_params_from_jax,
                                      dynamic_map_state_from_jax)
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.core.mesh import make_mesh
from paddle_tpu_torch.data.dataset import InMemoryDataset, SlotDesc
from paddle_tpu_torch.ops import hot_kernels as hk
from paddle_tpu_torch.ps.hot_tier import HotTierConfig
from test_torch_hot_kernels import _banked_map, _map_arrays, _port_keys
from test_torch_hot_tier import (_NAMES, DIM, LOSS_RTOL, PARAM_TOL, ROW_TOL, D, S,
                                 _assert_dense_equal, _assert_rows_equal_mod_delta,
                                 _dataset, _lines, _rows, _table, _trainer)


@pytest.mark.parametrize("stage", ["fresh", "removed"])
@pytest.mark.parametrize("banks", [1, 4, 8])
def test_hot_probe_plain_matches_jax_kernel(banks, stage):
    """B3: rows bitwise, n = 157 (resident and absent keys, not a block
    multiple), before and after removals (tombstones)."""
    rng = np.random.default_rng(banks)
    C = 256
    keys = np.unique(rng.integers(1, 2**63, 300).astype(np.uint64))[:120]
    m, _ = _banked_map(C, banks, keys)
    if stage == "removed":
        m.remove(keys[::3])
    probe = np.concatenate([keys, rng.integers(1, 2**63, 37).astype(np.uint64)])
    hi, lo = jax_split_keys(probe)
    want = jax_hot_probe(m.device_state(), jnp.asarray(hi), jnp.asarray(lo),
                         probe_buckets=m.probe_buckets, banks=banks, block=64,
                         interpret=True)
    before = hk.hot_probe.launches
    got = hk.hot_probe(dynamic_map_state_from_jax(_map_arrays(m), "cpu"), *_port_keys(probe),
                       probe_buckets=m.probe_buckets, banks=banks)
    assert hk.hot_probe.launches == before  # the plain version launches nothing
    assert got.dtype == torch.int32 and got.shape == (157,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), m.lookup_host(probe))
    assert (got.numpy()[len(keys):] == -1).all() and (got.numpy() >= 0).sum() > 60


def _mesh(K):
    return make_mesh({"ps": K}, device="cpu")


def test_sharded_trainer_matches_jax():
    """Two epochs of the JAX sharded hot-tier trainer (8 devices, Pallas
    kernels in interpret mode) and the port's (8 shards), from the same
    weights, on the same lines (tolerances: module docstring)."""
    lines = _lines(n=512, nid=60)
    jtable = JaxTable(JaxTableConfig(shard_num=4, backend="python"))
    pt.seed(0)
    jmesh = jax_mesh.make_mesh({"ps": 8}, devices=jax.devices()[:8])
    j = JaxTrainer(JaxDeepFM(JaxCtrConfig(num_sparse_slots=S, num_dense=D, embedx_dim=DIM,
                                          dnn_hidden=(8,))),
                   jax_optimizer.Adam(1e-2), jtable, embedx_dim=DIM,
                   hot_tier=JaxHotTierConfig(capacity=512, mesh=jmesh, axis="ps",
                                             kernels="pallas"), **_NAMES)
    ttable = _table()
    t = _trainer(ttable, HotTierConfig(capacity=512, mesh=_mesh(8)))
    t.params = deepfm_params_from_jax(jax.tree_util.tree_map(np.asarray, j.params))
    t.opt_state = adam_state_from_jax(jax.tree_util.tree_map(np.asarray, j.opt_state))
    jds = _dataset(JaxDataset, JaxSlotDesc, lines)
    tds = _dataset(InMemoryDataset, SlotDesc, lines)
    before = (hk.hot_probe.launches, hk.hot_scatter_apply.launches)
    for _ in range(2):
        jr = j.train_from_dataset(jds, batch_size=128)
        tr = t.train_from_dataset(tds, batch_size=128)
        np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=LOSS_RTOL)
        assert tr["steps"] == jr["steps"] == 4
        for key in ("hits", "misses", "cold_fetches", "occupancy", "evictions", "shards",
                    "banks"):
            assert tr["hot_tier"][key] == jr["hot_tier"][key], key
    assert tr["hot_tier"]["shards"] == 8 and tr["hot_tier"]["banks"] == 8
    assert (hk.hot_probe.launches, hk.hot_scatter_apply.launches) == before  # CPU: plain
    j.hot_tier.flush()
    t.hot_tier.flush()
    want = deepfm_params_from_jax(jax.tree_util.tree_map(np.asarray, j.params))
    for k, w in want.items():
        np.testing.assert_allclose(t.params[k].numpy(), w.numpy(), err_msg=k, **PARAM_TOL)
    jk, jv = jtable.snapshot_items()
    tk, tv = _rows(ttable)
    np.testing.assert_array_equal(tk, np.sort(jk))
    np.testing.assert_allclose(tv, jv[np.argsort(jk)], **ROW_TOL)


@pytest.mark.parametrize("K,routing", [(2, "auto"), (4, "auto"), (4, "allgather")])
def test_sharded_fused_equals_unfused(K, routing):
    """``kernels="auto"`` (hot_probe + hot_scatter_apply on the owner's
    block) and ``"unfused"`` (dynamic_map_lookup + cache_push) train the
    sharded tier bit-identically through eviction churn; "auto" routing
    is allgather at K = 2 and alltoall at K = 4."""
    lines = _lines(nid=400)
    ta, tb = _table(), _table()
    cfg = dict(capacity=512, mesh=_mesh(K), routing=routing)
    a = _trainer(ta, HotTierConfig(kernels="auto", **cfg))
    b = _trainer(tb, HotTierConfig(kernels="unfused", **cfg))
    for _ in range(2):
        ra = a.train_from_dataset(_dataset(InMemoryDataset, SlotDesc, lines), batch_size=64)
        rb = b.train_from_dataset(_dataset(InMemoryDataset, SlotDesc, lines), batch_size=64)
        assert ra["loss"] == rb["loss"]
    assert ra["hot_tier"]["evictions"] > 0 and ra["hot_tier"]["shards"] == K
    for k in a.hot_tier.state:
        assert torch.equal(a.hot_tier.state[k], b.hot_tier.state[k]), k
    _assert_dense_equal(a, b)
    a.hot_tier.flush()
    b.hot_tier.flush()
    _assert_rows_equal_mod_delta(ta, tb)


@pytest.mark.parametrize("K", [2, 8])
def test_sharded_equals_single_card_tier(K):
    """The sharded tier against the single-card tier (the JAX package's
    ``test_hot_tier_sharded_mesh_step_matches_single_chip``): loss, dense
    params and every table row within atol 1e-6."""
    lines = _lines(n=512, nid=60)
    ta, tb = _table(), _table()
    a = _trainer(ta, HotTierConfig(capacity=512))
    b = _trainer(tb, HotTierConfig(capacity=512, mesh=_mesh(K)))
    ra = a.train_from_dataset(_dataset(InMemoryDataset, SlotDesc, lines), batch_size=128)
    rb = b.train_from_dataset(_dataset(InMemoryDataset, SlotDesc, lines), batch_size=128)
    a.hot_tier.flush()
    b.hot_tier.flush()
    assert rb["hot_tier"]["shards"] == K
    assert abs(ra["loss"] - rb["loss"]) < 1e-6
    for k in a.params:
        np.testing.assert_allclose(b.params[k].numpy(), a.params[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    ka, va = _rows(ta)
    kb, vb = _rows(tb)
    np.testing.assert_array_equal(ka, kb)
    np.testing.assert_allclose(vb, va, rtol=0, atol=1e-6)


def test_sharded_tier_layout_checks():
    """One bank per shard by default; banks must be a multiple of the
    shard count, the capacity must divide over the shards, and a batch
    must split into K equal slices."""
    t = _trainer(_table(), HotTierConfig(capacity=512, mesh=_mesh(4), banks=8))
    assert t.hot_tier.stats()["banks"] == 8
    with pytest.raises(EnforceNotMet, match="multiple"):
        _trainer(_table(), HotTierConfig(capacity=512, mesh=_mesh(4), banks=2))
    with pytest.raises(EnforceNotMet, match="divide"):
        _trainer(_table(), HotTierConfig(capacity=510, mesh=_mesh(4)))
    t = _trainer(_table(), HotTierConfig(capacity=512, mesh=_mesh(4)))
    with pytest.raises(EnforceNotMet, match="split"):
        t.train_from_dataset(_dataset(InMemoryDataset, SlotDesc, _lines(n=66)),
                             batch_size=66)
