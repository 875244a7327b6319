"""The port's host tables, their files and checkpoint files, against the JAX
package's, on the CPU.

- ``SsdSparseTable`` (the port's copy of ``csrc/ssd_table.cc``) and JAX's,
  driven through the same operations in the same order: a cold
  population (``load_cold``), ``export_full(create=True)``, pulls,
  pushes, ``import_full``, ``spill``, ``shrink`` and ``save`` in modes 0, 1
  and 2, with fp32 and fp16 value columns on disk. ``digest()`` (both
  tiers) and ``stats()`` (but the bytes read to serve requests: see
  ``_stats``) are equal after every step; the rows, sorted by key, are
  bit-equal. Which rows a spill moves can depend on how the
  engine breaks ties (its hash salt is per instance), so the tiers are
  held by their counts and the digest, rows only through sorted
  snapshots.
- ``MemorySparseTable``'s Python shards: shrink and the save filter
  against JAX's Python backend, bitwise.
- Table files (``save``/``load``, plain and gzip) and ``io.checkpoint``
  files (bf16 included) load in the other package: rows sorted by key
  are compared, not file bytes (the native engines salt their hashes, so
  the order within a file differs).
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.io import checkpoint as jckpt
from paddle_tpu.ps.accessor import AccessorConfig as JaxAccessorConfig
from paddle_tpu.ps.table import MemorySparseTable as JaxTable
from paddle_tpu.ps.table import SsdSparseTable as JaxSsdTable
from paddle_tpu.ps.table import TableConfig as JaxTableConfig
from paddle_tpu_torch.core.enforce import InvalidArgumentError
from paddle_tpu_torch.io import checkpoint as tckpt
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.table import (MemorySparseTable, NativeMemorySparseTable,
                                       SsdSparseTable, TableConfig, make_sparse_table)
from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

# the JAX SSD table is native only
pytestmark = pytest.mark.usefixtures("jax_native")

DIM, SHARDS, POP = 8, 4, 20_000
ACC = dict(embedx_dim=DIM, embedx_threshold=2.0, delete_threshold=0.8)


def _tables(tmp_path, value_dtype="fp32"):
    t = SsdSparseTable(str(tmp_path / "port"), TableConfig(
        shard_num=SHARDS, accessor_config=AccessorConfig(**ACC), ssd_value_dtype=value_dtype))
    j = JaxSsdTable(str(tmp_path / "jax"), JaxTableConfig(
        shard_num=SHARDS, accessor_config=JaxAccessorConfig(**ACC),
        ssd_value_dtype=value_dtype))
    return t, j


def _sorted(keys, values):
    order = np.argsort(keys, kind="stable")
    return keys[order], values[order]


def _stats(table):
    """``stats()`` but the bytes read to serve requests: the cold index
    keeps 12-bit fingerprints of salted hashes and verifies a match by
    reading the record, so how many records a lookup reads depends on the
    instance's salt."""
    st = table.stats()
    del st["io_serve_bytes"]
    return st


def _same(t, j, what):
    """Digest, stats and every row (mode-0 snapshot, sorted by key)."""
    assert t.digest() == j.digest(), what
    assert _stats(t) == _stats(j), what
    assert t.size() == j.size(), what
    tk, tv = _sorted(*t.snapshot_items(0))
    jk, jv = _sorted(*j.snapshot_items(0))
    assert np.array_equal(tk, jk), what
    assert np.array_equal(tv.view(np.int32), jv.view(np.int32)), what


def _population(full_dim, rng):
    keys = np.arange(1, POP + 1, dtype=np.uint64)
    vals = np.zeros((POP, full_dim), np.float32)
    vals[:, 3] = rng.uniform(0, 20, POP).astype(np.float32)   # show: distinct scores
    vals[:, 4] = np.minimum(vals[:, 3], rng.uniform(0, 3, POP).astype(np.float32))
    vals[:, 1] = rng.integers(0, 40, POP)                    # unseen days
    vals[:, 5] = rng.normal(size=POP).astype(np.float32)     # embed_w
    has = rng.random(POP) < 0.5
    vals[:, 7] = has                                         # has_embedx (adagrad: es = 1)
    vals[has, 8:8 + DIM] = rng.normal(size=(int(has.sum()), DIM)).astype(np.float32)
    return keys, vals


@pytest.mark.parametrize("value_dtype", ["fp32", "fp16"])
def test_ssd_table_operations_match_jax(tmp_path, value_dtype):
    t, j = _tables(tmp_path, value_dtype)
    try:
        assert t.full_dim == j.full_dim
        rng = np.random.default_rng(0)
        keys, vals = _population(t.full_dim, rng)
        for tb in (t, j):
            tb.load_cold(keys, vals)
        _same(t, j, "load_cold")

        # a pass build: cold hits promote, new keys are created per (key, seed)
        pass_keys = np.unique(np.concatenate([
            rng.choice(keys, 3000, replace=False),
            rng.integers(POP + 1, 3 * POP, 2000).astype(np.uint64)]))
        slots = (pass_keys % np.uint64(5)).astype(np.int32)
        (tv, tf), (jv, jf) = (tb.export_full(pass_keys, create=True, slots=slots)
                              for tb in (t, j))
        assert tf.all() and np.array_equal(tf, jf)
        assert np.array_equal(tv.view(np.int32), jv.view(np.int32))
        _same(t, j, "export_full(create=True)")

        pulls = rng.integers(1, 3 * POP, 4000).astype(np.uint64)
        for create in (False, True):
            a, b = t.pull_sparse(pulls, create=create), j.pull_sparse(pulls, create=create)
            assert np.array_equal(a.view(np.int32), b.view(np.int32)), create
        push_keys = rng.choice(pass_keys, 2500)                     # duplicates merge
        push = np.zeros((len(push_keys), 4 + DIM), np.float32)
        push[:, 0] = (push_keys % np.uint64(5)).astype(np.float32)
        push[:, 1] = 1.0
        push[:, 2] = (rng.random(len(push_keys)) < 0.3).astype(np.float32)
        push[:, 3:] = rng.normal(size=(len(push_keys), 1 + DIM)).astype(np.float32)
        for tb in (t, j):
            tb.push_sparse(push_keys, push)
        _same(t, j, "pull/push")

        upd = tv.copy()
        upd[:, 5] += 0.5
        for tb in (t, j):
            tb.import_full(pass_keys[::3], upd[::3])
        _same(t, j, "import_full")

        # distinct scores for every hot row, so the spill's order does not
        # rest on ties (with fp16 values a spilled row is rounded, so which
        # rows move shows in the digest)
        hot = np.unique(np.concatenate([pass_keys, pulls]))
        rows, found = t.export_full(hot)
        assert found.all()
        rows[:, 1], rows[:, 4] = 0.0, 0.0
        rows[:, 3] = 100.0 + 0.01 * rng.permutation(len(hot)).astype(np.float32)
        for tb in (t, j):
            tb.import_full(hot, rows)
        _same(t, j, "distinct scores")
        assert t.spill(1000) == j.spill(1000)
        assert t.stats()["hot_rows"] <= 1000
        _same(t, j, "spill")
        assert t.shrink() == j.shrink() > 0
        _same(t, j, "shrink")
        for mode in (0, 1, 2):
            (tk, trow), (jk, jrow) = (_sorted(*tb.snapshot_items(mode)) for tb in (t, j))
            assert np.array_equal(tk, jk) and np.array_equal(trow.view(np.int32),
                                                              jrow.view(np.int32)), mode
            _same(t, j, f"save mode {mode}")
        assert t.compact() == j.compact()
        _same(t, j, "compact")
    finally:
        t.close()
        j.close()


def test_ssd_table_reopens_from_its_logs(tmp_path):
    """Close, reopen the same path: the logs replay to the same rows."""
    t, j = _tables(tmp_path)
    keys, vals = _population(t.full_dim, np.random.default_rng(1))
    t.load_cold(keys, vals)
    t.export_full(keys[:500], create=True)
    t.spill(100)
    before = t.digest()
    t.close()
    j.close()
    t2 = SsdSparseTable(str(tmp_path / "port"), TableConfig(
        shard_num=SHARDS, accessor_config=AccessorConfig(**ACC)))
    try:
        assert t2.digest() == before and t2.size() == POP
    finally:
        t2.close()


def _rows_of_dir(table):
    return _sorted(*table.snapshot_items(0))


@pytest.mark.parametrize("converter", [None, "gzip"])
@pytest.mark.parametrize("mode", [0, 2])
def test_table_files_cross_load_both_ways(tmp_path, converter, mode):
    """Each package saves; a fresh table of the other loads the directory
    (into its disk tier) and holds the same rows as a fresh table of the
    saver's own package loading it."""
    t, j = _tables(tmp_path)
    try:
        keys, vals = _population(t.full_dim, np.random.default_rng(2))
        for tb in (t, j):
            tb.load_cold(keys, vals)
            tb.export_full(keys[:3000], create=True)
        n_t = t.save(str(tmp_path / "tsave"), mode=mode, converter=converter)
        n_j = j.save(str(tmp_path / "jsave"), mode=mode, converter=converter)
        assert n_t == n_j > 0
        suffix = ".gz" if converter else ""
        assert sorted(os.listdir(tmp_path / "tsave")) == sorted(os.listdir(tmp_path / "jsave"))
        assert f"part-00000.shard{suffix}" in os.listdir(tmp_path / "tsave")
        loaded = {}
        for who, src in (("port", "jsave"), ("jax", "tsave"), ("port_own", "tsave"),
                         ("jax_own", "jsave")):
            cls, cfg_cls, acc_cls = ((SsdSparseTable, TableConfig, AccessorConfig)
                                     if who.startswith("port") else
                                     (JaxSsdTable, JaxTableConfig, JaxAccessorConfig))
            tb = cls(str(tmp_path / f"load_{who}"),
                     cfg_cls(shard_num=3, accessor_config=acc_cls(**ACC)))
            try:
                assert tb.load(str(tmp_path / src)) == n_t
                loaded[who] = _rows_of_dir(tb)
            finally:
                tb.close()
        for a, b in (("port", "jax_own"), ("jax", "port_own"), ("port_own", "jax_own")):
            assert np.array_equal(loaded[a][0], loaded[b][0]), (a, b)
            assert np.array_equal(loaded[a][1].view(np.int32), loaded[b][1].view(np.int32)), \
                (a, b)
    finally:
        t.close()
        j.close()


def test_python_shards_shrink_and_save_filter_match_jax(tmp_path):
    """The RAM table's Python shards: a trained-looking population, then
    shrink and the save modes (each mutating the stats it should), against
    the JAX package's Python backend; files cross-load."""
    acc = dict(embedx_dim=4, embedx_threshold=2.0)
    t = MemorySparseTable(TableConfig(shard_num=3, backend="python", accessor_config=AccessorConfig(**acc)))
    j = JaxTable(JaxTableConfig(shard_num=3, backend="python",
                                accessor_config=JaxAccessorConfig(**acc)))
    try:
        rng = np.random.default_rng(3)
        keys = np.unique(rng.integers(1, 1 << 40, 3000)).astype(np.uint64)
        n = len(keys)
        vals = np.zeros((n, t.full_dim), np.float32)
        vals[:, 1] = rng.integers(0, 40, n)
        vals[:, 2] = rng.uniform(0, 1, n)
        vals[:, 3] = rng.uniform(0, 5, n)
        vals[:, 4] = np.minimum(vals[:, 3], rng.uniform(0, 1, n))
        vals[:, 5] = rng.normal(size=n)
        for tb in (t, j):
            tb.import_full(keys, vals)
        assert t.shrink() == j.shrink() > 0
        for mode in (1, 2, 0, 3):
            (tk, tv), (jk, jv) = (_sorted(*tb.snapshot_items(mode)) for tb in (t, j))
            assert np.array_equal(tk, jk) and np.array_equal(tv, jv), mode
        assert t.digest() == j.digest()
        assert t.save(str(tmp_path / "t"), mode=0) == j.save(str(tmp_path / "j"), mode=0)
        t2 = MemorySparseTable(TableConfig(shard_num=2, backend="python", accessor_config=AccessorConfig(**acc)))
        try:
            t2.load(str(tmp_path / "j"))
            j.load(str(tmp_path / "t"))
            assert t2.digest() == j.digest()
        finally:
            t2.close()
    finally:
        t.close()


def test_make_sparse_table_picks_the_storage(tmp_path):
    """``storage`` picks the RAM or the SSD table; a RAM table runs the
    native engine by default (``backend="auto"``, as in the JAX package)
    and the Python shards on request; an unknown backend raises."""
    acc = AccessorConfig(embedx_dim=4)
    ram = make_sparse_table(TableConfig(shard_num=2, accessor_config=acc))
    py = make_sparse_table(TableConfig(shard_num=2, accessor_config=acc, backend="python"))
    ssd = make_sparse_table(TableConfig(shard_num=2, accessor_config=acc, storage="ssd",
                                        ssd_path=str(tmp_path / "s")))
    try:
        assert type(ram) is NativeMemorySparseTable and type(ssd) is SsdSparseTable
        assert type(py) is MemorySparseTable
        assert (ram.backend, py.backend, ssd.backend) == ("native", "python", "ssd")
    finally:
        ram.close()
        py.close()
        ssd.close()
    with pytest.raises(InvalidArgumentError):
        make_sparse_table(TableConfig(backend="gpu"))
    with pytest.raises(InvalidArgumentError):
        make_sparse_table(TableConfig(storage="ssd"))
    with pytest.raises(InvalidArgumentError):
        make_sparse_table(TableConfig(storage="tape"))
    with pytest.raises(InvalidArgumentError):
        SsdSparseTable(str(tmp_path / "x"), TableConfig(ssd_value_dtype="int8"))


def test_checkpoint_files_cross_load_both_ways(tmp_path):
    """``io.checkpoint`` trees (nesting, scalars, None, f32/i32 arrays and
    bf16) saved by either package load in the other, leaf for leaf."""
    rng = np.random.default_rng(4)
    w = rng.normal(size=(3, 5)).astype(np.float32)
    b16 = rng.normal(size=(4,)).astype(np.float32)
    t_tree = {"params": {"fc.0.weight": torch.from_numpy(w),
                         "half": torch.from_numpy(b16).to(torch.bfloat16)},
              "list": [np.arange(3, dtype=np.int32), 2.5, None], "tup": (1, "x")}
    tckpt.save_checkpoint(str(tmp_path / "t"), t_tree, {"step": np.int32(7)}, step=3)
    got = jckpt.load_checkpoint(str(tmp_path / "t"))
    assert got["step"] == 3 and int(got["opt"]["step"]) == 7
    assert np.array_equal(got["model"]["params"]["fc.0.weight"], w)
    half = got["model"]["params"]["half"]
    assert half.dtype == ml_dtypes.bfloat16
    assert np.array_equal(half.astype(np.float32),
                          torch.from_numpy(b16).to(torch.bfloat16).float().numpy())
    assert np.array_equal(got["model"]["list"][0], np.arange(3))
    assert got["model"]["list"][1:] == [2.5, None] and got["model"]["tup"] == (1, "x")

    j_tree = {"params": {"fc.0.weight": w, "half": b16.astype(ml_dtypes.bfloat16)},
              "tup": (np.int32(4), [1.0])}
    jckpt.save_checkpoint(str(tmp_path / "j"), j_tree, None, step=9)
    back = tckpt.load_checkpoint(str(tmp_path / "j"), device="cpu")
    assert back["step"] == 9 and back["opt"] is None
    p = back["model"]["params"]
    assert isinstance(p["fc.0.weight"], torch.Tensor)
    assert torch.equal(p["fc.0.weight"], torch.from_numpy(w))
    assert p["half"].dtype == torch.bfloat16
    assert torch.equal(p["half"].float(),
                       torch.from_numpy(b16.astype(ml_dtypes.bfloat16).astype(np.float32)))
    assert int(back["model"]["tup"][0]) == 4 and back["model"]["tup"][1] == [1.0]
    plain = tckpt.load(str(tmp_path / "j"))
    assert isinstance(plain["model"]["params"]["fc.0.weight"], np.ndarray)
