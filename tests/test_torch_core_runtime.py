"""The port's core runtime against the JAX package, on the CPU: flags,
places, the NaN/Inf guard (``core.nan_inf``, ``Trainer`` and
``CtrPassTrainer`` under ``check_nan_inf``), the profiler scopes
(``core.profiler``: host statistics, the chrome timeline, the device
trace window, ``timed``'s gate and retries), the host arena
(``core.allocator``) and ``Trainer``'s dumps.

The cases are ``tests/test_core.py``'s, ``tests/test_allocator.py``'s,
``tests/test_aux_subsystems.py::test_trainer_dump_fields`` and
``tests/test_ps_trainer.py``'s two guard tests, each run on both
packages where both have the piece. Counts, messages and dump text are
compared exactly; the dumped losses to rtol 1e-5 (another BLAS).
"""

import gc
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import nan_inf as jnan
from paddle_tpu.core import profiler as jprof
from paddle_tpu.core.enforce import PreconditionNotMetError as JPrecondition
from paddle_tpu.data.dataset import InMemoryDataset as JDataset
from paddle_tpu.data.dataset import SlotDesc as JSlot
from paddle_tpu.executor import Trainer as JTrainer
from paddle_tpu.models import ctr as jctr
from paddle_tpu.ps import ps_trainer as jtrainer
from paddle_tpu.ps.accessor import AccessorConfig as JAccessorConfig
from paddle_tpu.ps.embedding_cache import CacheConfig as JCacheConfig
from paddle_tpu.ps.table import MemorySparseTable as JTable
from paddle_tpu.ps.table import TableConfig as JTableConfig
from paddle_tpu_torch import core
from paddle_tpu_torch.convert import adam_state_from_jax, ctr_params_from_jax
from paddle_tpu_torch.core import allocator, flags, nan_inf, places, profiler
from paddle_tpu_torch.core.enforce import InvalidArgumentError, PreconditionNotMetError
from paddle_tpu_torch.data.dataset import InMemoryDataset, SlotDesc
from paddle_tpu_torch.executor import Trainer
from paddle_tpu_torch.models import ctr as tctr
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import SGD, Adam
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.embedding_cache import CacheConfig
from paddle_tpu_torch.ps.ps_trainer import CtrPassTrainer, CtrStreamTrainer
from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig
from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

# the JAX pass trainer's build needs its native dedup order and key map
pytestmark = pytest.mark.usefixtures("jax_native")

S, D = 4, 3
NAMES = dict(sparse_slots=[f"s{i}" for i in range(S)],
             dense_slots=[f"d{i}" for i in range(D)], label_slot="label")


# -- flags ----------------------------------------------------------------------------

def test_flags_define_get_set():
    flags.define_flag("torch_test_only_flag", 3, "test")
    assert core.get_flags("torch_test_only_flag")["torch_test_only_flag"] == 3
    core.set_flags({"torch_test_only_flag": 7})
    assert core.get_flags(["torch_test_only_flag"])["torch_test_only_flag"] == 7
    with pytest.raises(KeyError):
        core.set_flags({"nonexistent_flag_xyz": 1})
    flags.define_flag("torch_test_bool_flag", False)
    core.set_flags({"torch_test_bool_flag": "true"})
    assert core.get_flags("torch_test_bool_flag")["torch_test_bool_flag"] is True


def test_core_flags_have_the_jax_names_and_defaults():
    names = ["check_nan_inf", "benchmark", "tpu_allocator_strategy", "eager_delete_tensor_gb",
             "ps_faultpoints"]
    assert core.get_flags(names) == pt.get_flags(names)


# -- places ---------------------------------------------------------------------------

def test_places():
    p = core.CPUPlace()
    assert p == places.Place("cpu", 0) and p.torch_device() == torch.device("cpu")
    assert repr(p) == "Place(cpu:0)" and hash(p) == hash(places.Place("cpu", 0))
    assert core.device_count("cpu") == 1 and not core.is_compiled_with_tpu()
    with pytest.raises(InvalidArgumentError, match="without TPU"):
        core.TPUPlace(0)
    with pytest.raises(InvalidArgumentError, match="unknown device type"):
        places.Place("tpu", 0).torch_device()
    assert core.set_device("cpu") == p and core.get_device() == p
    if torch.cuda.is_available():
        assert core.CUDAPlace(0).torch_device() == torch.device("cuda", 0)
        assert core.set_device("gpu:0") == places.Place("gpu", 0)
        assert core.device_count("gpu") == torch.cuda.device_count()
    else:
        with pytest.raises(InvalidArgumentError):
            core.CUDAPlace(0)
        with pytest.raises(InvalidArgumentError):
            core.set_device("gpu:1")
        assert core.device_count("gpu") == 0
        assert core.get_device() == p
    # as in JAX, the choice is this thread's only
    import threading

    seen = []
    t = threading.Thread(target=lambda: seen.append(places._STATE.place))
    t.start()
    t.join()
    assert seen == [None]


# -- the NaN/Inf guard -----------------------------------------------------------------

def test_nan_inf_checker_matches_jax():
    good = {"a": np.ones(4, np.float32)}
    nan_inf.check_numerics(good)
    bad = {"b": [np.array([1.0, np.nan], np.float32), np.arange(3)],
           "a": (np.array([np.inf, -np.inf, 2.0], np.float32),)}
    with pytest.raises(PreconditionNotMetError) as got:
        nan_inf.check_numerics({k: ([torch.from_numpy(x) for x in v]) for k, v in bad.items()},
                               "step 3")
    with pytest.raises(JPrecondition) as want:
        jnan.check_numerics({k: list(v) for k, v in bad.items()}, "step 3")
    assert str(got.value) == str(want.value)
    assert "['a'][0]: 2/3 non-finite" in str(got.value)
    for tree in (bad, good, {}):
        assert int(nan_inf.count_nonfinite(tree)) == int(jnan.count_nonfinite(tree))
    t = nan_inf.count_nonfinite({"x": torch.tensor([0.0, float("nan")])})
    assert isinstance(t, torch.Tensor) and t.dim() == 0 and int(t) == 1
    assert not nan_inf.nan_inf_enabled()


def _mlp_pair():
    pt.seed(0)
    jm = jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 2))
    tm = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(), torch.nn.Linear(8, 2))
    w = {k: np.array(v) for k, v in jm.named_parameters()}
    with torch.no_grad():
        for k, p in tm.named_parameters():
            p.copy_(torch.from_numpy(w[k].T if w[k].ndim == 2 else w[k]))
    return jm, tm


def test_trainer_dump_fields(tmp_path):
    """``set_dump_config`` in both packages: 3 steps × 3 fields, the same
    file name, steps, fields and text (the losses to rtol 1e-5)."""
    jm, tm = _mlp_pair()
    jt = JTrainer(jm, jopt.SGD(0.1), jnn.functional.cross_entropy)
    tt = Trainer(tm, SGD(0.1), F.cross_entropy, device="cpu")
    for tr, d in ((jt, tmp_path / "j"), (tt, tmp_path / "t")):
        tr.set_dump_config(str(d), fields=("loss", "input:0", "label:0"), trainer_id=3)
    rng = np.random.default_rng(0)
    for _ in range(3):
        x, y = rng.normal(size=(8, 4)).astype(np.float32), rng.integers(0, 2, 8)
        jt.train_step(jnp.asarray(x), jnp.asarray(y))
        tt.train_step(x, y)
    for tr in (jt, tt):
        tr.set_dump_config(None)  # close
    want = (tmp_path / "j" / "trainer-003.dump").read_text().strip().splitlines()
    got = (tmp_path / "t" / "trainer-003.dump").read_text().strip().splitlines()
    assert len(got) == len(want) == 9                    # 3 steps x 3 fields
    assert {int(l.split("\t")[0]) for l in got} == {1, 2, 3}
    for g, w in zip(got, want):
        gs, ws = g.split("\t"), w.split("\t")
        assert gs[:2] == ws[:2]
        if gs[1] == "loss":
            np.testing.assert_allclose(float(gs[2]), float(ws[2]), rtol=1e-5)
        else:
            assert gs[2] == ws[2]
    assert got[1].endswith(" ...")                      # 32 inputs, 16 dumped


def test_trainer_check_nan_inf_raises():
    """A step whose loss is NaN raises under ``check_nan_inf`` in both
    packages, with the same message; without the flag it returns the NaN."""
    jm, tm = _mlp_pair()
    x = np.full((2, 4), np.nan, np.float32)
    y = np.zeros(2, np.int64)
    jt = JTrainer(jm, jopt.SGD(0.1), jnn.functional.cross_entropy)
    tt = Trainer(tm, SGD(0.1), F.cross_entropy, device="cpu")
    assert torch.isnan(tt.train_step(x, y))
    pt.set_flags({"check_nan_inf": True})
    core.set_flags({"check_nan_inf": True})
    try:
        with pytest.raises(JPrecondition) as want:
            jt.train_step(jnp.asarray(x), jnp.asarray(y))
        with pytest.raises(PreconditionNotMetError) as got:
            tt.train_step(x, y)
    finally:
        pt.set_flags({"check_nan_inf": False})
        core.set_flags({"check_nan_inf": False})
    assert str(got.value) == str(want.value).replace("step 1", "step 2")


def _lines(rng, n, vocab=64):
    """MultiSlot text: 4 sparse slots (1 id each), 3 dense, 1 label
    (``tests/test_ps_trainer.py``'s recipe)."""
    lines = []
    for _ in range(n):
        ids = rng.integers(0, vocab, S)
        dense = rng.normal(size=D)
        label = int((ids % 5 == 0).sum() + dense[0] + rng.normal(scale=0.5) > 1.0)
        lines.append(" ".join([f"1 {v}" for v in ids] + [f"1 {v:.4f}" for v in dense]
                              + [f"1 {label}"]))
    return lines


def _dataset(cls, slot, lines):
    slots = ([slot(f"s{i}", is_float=False, max_len=1) for i in range(S)]
             + [slot(f"d{i}", is_float=True, max_len=1) for i in range(D)]
             + [slot("label", is_float=True, max_len=1)])
    ds = cls(slots, seed=0)
    ds.load_from_lines(lines)
    return ds


def _port_pass_trainer(lr):
    table = MemorySparseTable(TableConfig(shard_num=4, backend="python",
                                          accessor_config=AccessorConfig(embedx_dim=4)))
    return CtrPassTrainer(
        tctr.DeepFM(tctr.CtrConfig(S, D, 4, (8,)), generator=torch.Generator().manual_seed(0)),
        Adam(lr), table, CacheConfig(capacity=1 << 10, embedx_dim=4, embedx_threshold=0.0),
        device="cpu", **NAMES)


def test_nan_guard_flags():
    """``FLAGS_check_nan_inf`` surfaces a diverged pass loudly, in both
    packages, with the same message."""
    lines = _lines(np.random.default_rng(0), 256)
    tr = _port_pass_trainer(float("nan"))               # poison lr → NaN
    pt.seed(0)
    jtr = jtrainer.CtrPassTrainer(
        jctr.DeepFM(jctr.CtrConfig(S, D, 4, (8,))), jopt.Adam(float("nan")),
        JTable(JTableConfig(shard_num=4, accessor_config=JAccessorConfig(embedx_dim=4))),
        JCacheConfig(capacity=1 << 10, embedx_dim=4, embedx_threshold=0.0), **NAMES)
    core.set_flags({"check_nan_inf": True})
    pt.set_flags({"check_nan_inf": True})
    try:
        with pytest.raises(PreconditionNotMetError) as got:
            for _ in range(3):
                tr.train_from_dataset(_dataset(InMemoryDataset, SlotDesc, lines), batch_size=128)
        with pytest.raises(JPrecondition) as want:
            for _ in range(3):
                jtr.train_from_dataset(_dataset(JDataset, JSlot, lines), batch_size=128)
    finally:
        core.set_flags({"check_nan_inf": False})
        pt.set_flags({"check_nan_inf": False})
    assert str(got.value) == str(want.value)
    assert "CtrPassTrainer pass" in str(got.value)


def test_nan_guard_discards_pass(tmp_path):
    """A diverged pass is dropped without flushing: the host table keeps
    its last good rows (its digest unchanged) and stays checkpointable."""
    lines = _lines(np.random.default_rng(1), 256)
    ds = _dataset(InMemoryDataset, SlotDesc, lines)
    tr = _port_pass_trainer(float("nan"))
    keys = np.unique(tr._tagged_pass_keys(ds))
    tr.table.pull_sparse(keys, create=True)              # the pass's rows exist already
    before = tr.table.digest()
    core.set_flags({"check_nan_inf": True})
    try:
        with pytest.raises(PreconditionNotMetError):
            tr.train_from_dataset(ds, batch_size=128)
    finally:
        core.set_flags({"check_nan_inf": False})
    assert tr.cache.state is None                        # pass discarded, device rows freed
    assert tr.table.digest() == before                   # nothing flushed
    tr.save(str(tmp_path / "ck"))                        # still checkpointable
    table2 = MemorySparseTable(TableConfig(shard_num=4,
                                           accessor_config=AccessorConfig(embedx_dim=4)))
    table2.load(str(tmp_path / "ck") + "/sparse")
    vals, found = table2.export_full(keys)
    assert found.all() and np.isfinite(vals).all()


# -- the profiler ---------------------------------------------------------------------

def test_profiler_host_events_and_timeline(tmp_path):
    profiler.reset_host_events()
    with profiler.RecordEvent("unit_scope"):
        pass
    with core.record_event("unit_scope"):
        pass
    t = profiler.CostTimer("unit_timer")
    assert t.stop() >= 0
    stats = profiler.host_event_stats()
    assert stats["unit_scope"]["count"] == 2 and stats["unit_timer"]["count"] == 1
    assert set(stats["unit_scope"]) == {"count", "total_s", "avg_s", "max_s"}
    profiler.reset_host_events()
    assert profiler.host_event_stats() == {}

    profiler.start_timeline()
    with profiler.RecordEvent("work_0"):
        pass
    profiler.stop_timeline()
    with profiler.RecordEvent("after_stop"):
        pass
    blob = json.load(open(profiler.export_chrome_tracing(str(tmp_path / "w.json"))))
    from paddle_tpu_torch.obs import trace as ttrace

    assert [e["name"] for e in blob["traceEvents"]] == ["work_0"]
    assert blob["traceEvents"][0]["ph"] == "X" and blob["clockSyncUs"] == ttrace.EPOCH_ANCHOR_US


def test_record_event_opens_an_obs_span_while_tracing():
    from paddle_tpu_torch.obs import trace as ttrace

    ttrace.drain_spans()
    with profiler.RecordEvent("untraced_scope"):
        pass
    ttrace.start_tracing(sample=1.0)
    try:
        with profiler.RecordEvent("traced_root"):
            with profiler.RecordEvent("traced_child"):
                pass
    finally:
        ttrace.stop_tracing()
    spans = {s.name: s for s in ttrace.drain_spans()}
    assert set(spans) == {"traced_root", "traced_child"}
    assert spans["traced_child"].parent_id == spans["traced_root"].span_id


def test_start_profiler_writes_a_chrome_trace(tmp_path):
    assert not profiler.profiler_enabled() and profiler.stop_profiler() is None
    profiler.start_profiler(str(tmp_path / "prof"))
    assert profiler.profiler_enabled()
    with profiler.RecordEvent("profiled_scope"):
        torch.ones(4).sum()
    assert profiler.stop_profiler() == str(tmp_path / "prof")
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    assert any(e.get("name") == "profiled_scope" for e in trace["traceEvents"])


def test_profiler_timed_gate_and_retry(monkeypatch):
    """``timed``: below the fetch-latency noise floor it retries with 5x the
    iterations and finally raises, as the JAX package's does."""
    t, out = profiler.timed(lambda x: x + 1, torch.zeros(64), iters=3)
    assert t > 0 and float(out[0]) == 1.0
    assert profiler.fetch_sync({"b": torch.ones(2), "a": torch.arange(3.0) + 5}).tolist() == [5.0]
    real_fetch = profiler.fetch_sync
    calls = {"n": 0}

    def slow_fetch(x):
        calls["n"] += 1
        import time as _t
        _t.sleep(0.05)
        return real_fetch(x)

    monkeypatch.setattr(profiler, "fetch_sync", slow_fetch)
    with pytest.raises(RuntimeError, match="noise floor"):
        profiler.timed(lambda x: x + 1, torch.zeros(4), iters=1)
    assert calls["n"] >= 3 * 4  # warm-up + 3 latency samples + the final, per try


PASS_SCOPES = ("ctr_pass_prepare", "ctr_pass_build", "ctr_train_step",
               "pserver_sparse_select_all", "pserver_sparse_update_all",
               "pserver_sparse_export_full", "pserver_sparse_import_full")


def test_scope_counts_match_jax_on_a_pass_and_a_stream():
    """The same CtrPassTrainer pass (5 steps, a padded tail) and the same
    CtrStreamTrainer epoch over a local table in both packages: every
    ported scope counts as often as JAX's."""
    lines = _lines(np.random.default_rng(2), 600)
    pt.seed(0)
    jtr = jtrainer.CtrPassTrainer(
        jctr.DeepFM(jctr.CtrConfig(S, D, 4, (8,))), jopt.Adam(1e-2),
        JTable(JTableConfig(shard_num=2, backend="python",
                            accessor_config=JAccessorConfig(embedx_dim=4))),
        JCacheConfig(capacity=1 << 10, embedx_dim=4, embedx_threshold=0.0), **NAMES)
    tr = _port_pass_trainer(1e-2)
    tr.params = ctr_params_from_jax({k: np.asarray(v) for k, v in jtr.params["params"].items()})
    tr.opt_state = adam_state_from_jax(jtr.opt_state)
    counts = []
    for trainer, ds in ((jtr, _dataset(JDataset, JSlot, lines)),
                        (tr, _dataset(InMemoryDataset, SlotDesc, lines))):
        (jprof if trainer is jtr else profiler).reset_host_events()
        trainer.train_from_dataset(ds, batch_size=128, drop_last=False)
        counts.append((jprof if trainer is jtr else profiler).host_event_stats())
    for name in PASS_SCOPES:
        assert _count(counts[1], name) == _count(counts[0], name), name
    assert _count(counts[1], "ctr_train_step") == 5
    assert _count(counts[1], "pserver_sparse_export_full") > 0

    jst = jtrainer.CtrStreamTrainer(
        jctr.DeepFM(jctr.CtrConfig(S, D, 4, (8,))), jopt.Adam(1e-2),
        JTable(JTableConfig(shard_num=2, backend="python",
                            accessor_config=JAccessorConfig(embedx_dim=4))), **NAMES)
    tst = CtrStreamTrainer(
        tctr.DeepFM(tctr.CtrConfig(S, D, 4, (8,))), Adam(1e-2),
        MemorySparseTable(TableConfig(shard_num=2, backend="python",
                                      accessor_config=AccessorConfig(embedx_dim=4))),
        device="cpu", **NAMES)
    counts = []
    for trainer, ds, prof in ((jst, _dataset(JDataset, JSlot, lines), jprof),
                              (tst, _dataset(InMemoryDataset, SlotDesc, lines), profiler)):
        prof.reset_host_events()
        trainer.train_from_dataset(ds, batch_size=128)
        counts.append(prof.host_event_stats())
    for name in ("ctr_stream_step", "pserver_sparse_select_all", "pserver_sparse_update_all"):
        assert _count(counts[1], name) == _count(counts[0], name) > 0, name


def _count(stats, name):
    return stats.get(name, {}).get("count", 0)


# -- the host arena (tests/test_allocator.py's cases) -----------------------------------

def test_arena_alloc_free_reuse():
    a = allocator.HostArena(chunk_size=1 << 20)
    b1 = a.alloc(1000)
    p1 = b1.ptr
    a.free(b1)
    b2 = a.alloc(900)  # best fit hands back the same block
    assert b2.ptr == p1
    a.free(b2)
    s = a.stats()
    assert s["in_use"] == 0 and s["chunks"] == 1


def test_arena_auto_growth_and_peak():
    a = allocator.HostArena(chunk_size=1 << 16)
    blocks = [a.alloc(40 << 10) for _ in range(4)]  # forces 4 chunks
    s = a.stats()
    assert s["chunks"] == 4 and s["in_use"] >= 4 * (40 << 10)
    for b in blocks:
        a.free(b)
    s2 = a.stats()
    assert s2["in_use"] == 0 and s2["peak"] >= s["in_use"]
    assert s2["reserved"] == s["reserved"]  # chunks kept for reuse


def test_arena_coalescing_allows_big_realloc():
    a = allocator.HostArena(chunk_size=1 << 16)
    blocks = [a.alloc(1 << 12) for _ in range(16)]  # one chunk, full
    assert a.stats()["chunks"] == 1
    for b in blocks:
        a.free(b)
    big = a.alloc(1 << 16)  # the freed neighbours coalesced
    assert a.stats()["chunks"] == 1
    a.free(big)


def test_arena_double_free_rejected():
    a = allocator.HostArena()
    b = a.alloc(128)
    a.free(b)
    with pytest.raises(PreconditionNotMetError):
        a.free(b)


def test_arena_ndarray_lifetime_recycles():
    a = allocator.HostArena(chunk_size=1 << 20)
    arr = a.ndarray((256, 4), np.float32)
    arr[:] = 3.5
    assert a.stats()["in_use"] > 0
    view = arr[10:20]
    del arr
    gc.collect()
    assert a.stats()["in_use"] > 0  # the view keeps the block
    np.testing.assert_array_equal(view, np.full((10, 4), 3.5, np.float32))
    del view
    gc.collect()
    assert a.stats()["in_use"] == 0


def test_arena_default_facade_and_no_fallback(monkeypatch):
    x = allocator.arena_ndarray((16,), np.int64)
    x[:] = np.arange(16)
    assert allocator.default_arena().stats()["in_use"] > 0
    np.testing.assert_array_equal(x, np.arange(16))

    def broken():
        raise RuntimeError("host library did not build")

    # the JAX package falls back to np.empty here; the port raises
    monkeypatch.setattr(allocator, "load_arena_lib", broken)
    with pytest.raises(RuntimeError, match="did not build"):
        allocator.HostArena()


def test_core_exports_what_the_jax_core_exports():
    import paddle_tpu.core as jcore

    shared = ["CPUPlace", "CUDAPlace", "CostTimer", "HYBRID_AXES", "Place", "RecordEvent",
              "TPUPlace", "check_numerics", "count_nonfinite", "current_mesh", "define_flag",
              "device_count", "flag", "get_device", "get_flags", "host_event_stats",
              "is_compiled_with_tpu", "make_hybrid_mesh", "make_mesh", "mesh_axis_size",
              "nan_inf_enabled", "named_sharding", "record_event", "replicated",
              "reset_host_events", "set_device", "set_flags", "start_profiler", "stop_profiler",
              "use_mesh"]
    for name in shared:
        assert hasattr(jcore, name) and hasattr(core, name), name
    assert core.HYBRID_AXES == jcore.HYBRID_AXES
    assert os.path.basename(allocator.__file__) == "allocator.py"
