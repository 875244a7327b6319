"""The port's job checkpoint (``paddle_tpu_torch.io.job_checkpoint``) on
the CPU, test for test against ``tests/test_job_checkpoint.py``, and
across the packages.

The harness is the JAX tests' (3 slots, 2 dense, dim 8, DNN (8,), batch
128, 640 records, a 4-shard CTR table created with ``initial_range=0``).

- The protocol, counterpart by counterpart: CRC32C and the durable
  publish, the manifest and its self-checksum, the fallback past torn,
  truncated, flipped and unpublished checkpoints, the save-path
  faultpoints, GC, the latched writer failure, the backpressured save
  that holds no lifecycle lock (here held by events, not by a wall-clock
  budget), table snapshot/restore (RAM and SSD tables) and the gate's
  consistent cut under concurrent pushes, over plain servers and over an
  ``HACluster`` (``cluster.checkpoint_gate()``).
- Across the packages, exact: ``crc32c`` against the JAX function; a
  checkpoint written by the port verifies and loads in the JAX package
  and one written by the JAX package in the port (rows bitwise, the
  dense tree bitwise through ``convert``).
- Stream resume: the port's resumed run equals its own uninterrupted
  oracle BITWISE (dense params, Adam state, every table row, the table
  digest) over a local table, over the hot tier (capacity 256, eviction
  churn; the oracle checkpoints at the same batches, so the tier flushes
  at the same points), over RPC with a ``SyncCommunicator`` and
  ``CheckpointGate(servers=...)``, over the hot tier over RPC, and both
  of these over a 2 x 2 sync ``HACluster`` under
  ``cluster.checkpoint_gate()``. The
  port's resumed run stays within ``test_torch_hot_tier.py``'s
  tolerances of the JAX package's resumed run (dense params rtol 1e-4 /
  atol 1e-6, rows rtol 1e-4 / atol 1e-5: the dense products run in
  another order through XLA's and PyTorch's CPU BLAS).
- A save is a copy: state changed in place after ``save(blocking=False)``
  (a tensor's ``add_``, the trainer's next steps) does not reach the
  written checkpoint.
- The whole job SIGKILLed mid-save in subprocesses (the port only,
  ``OMP_NUM_THREADS=1``, two in-process servers, the hot tier), the
  newest published checkpoint corrupted on top: the restart falls back
  one checkpoint and ends bit-identical to a run that never stopped.
"""

import json
import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

import paddle_tpu as pt
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.data.dataset import InMemoryDataset as JaxDataset
from paddle_tpu.data.dataset import SlotDesc as JaxSlotDesc
from paddle_tpu.io import job_checkpoint as jax_jc
from paddle_tpu.io.fs import crc32c as jax_crc32c
from paddle_tpu.models.ctr import CtrConfig as JaxCtrConfig
from paddle_tpu.models.ctr import DeepFM as JaxDeepFM
from paddle_tpu.ps import communicator as jax_comm
from paddle_tpu.ps import ha as jax_ha
from paddle_tpu.ps import rpc as jax_rpc
from paddle_tpu.ps.accessor import AccessorConfig as JaxAccessorConfig
from paddle_tpu.ps.faultpoints import disarm_faultpoints as jax_disarm_faultpoints
from paddle_tpu.ps.hot_tier import HotTierConfig as JaxHotTierConfig
from paddle_tpu.ps.ps_trainer import CtrStreamTrainer as JaxTrainer
from paddle_tpu.ps.sgd_rule import SGDRuleConfig as JaxSGDRuleConfig
from paddle_tpu.ps.table import MemorySparseTable as JaxTable
from paddle_tpu.ps.table import TableConfig as JaxTableConfig
from paddle_tpu_torch.convert import adam_state_from_jax, ctr_params_from_jax, ctr_params_to_jax
from paddle_tpu_torch.core.enforce import NotFoundError, PreconditionNotMetError
from paddle_tpu_torch.data.dataset import InMemoryDataset, SlotDesc
from paddle_tpu_torch.io import checkpoint as ckpt
from paddle_tpu_torch.io.fs import crc32c, crc32c_file, publish_atomic
from paddle_tpu_torch.io.job_checkpoint import (CorruptCheckpointError, JobCheckpointManager,
                                                combined_digest, verify_checkpoint)
from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.ps import ha, rpc
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.communicator import SyncCommunicator
from paddle_tpu_torch.ps.faultpoints import (FaultInjected, arm_faultpoint,
                                            disarm_faultpoints)
from paddle_tpu_torch.ps.ha import CheckpointGate
from paddle_tpu_torch.ps.hot_tier import HotTierConfig
from paddle_tpu_torch.ps.native import load_ssd
from paddle_tpu_torch.ps.ps_trainer import CtrStreamTrainer
from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig
from paddle_tpu_torch.ps.table import (MemorySparseTable, SsdSparseTable, TableConfig,
                                       row_digest)

pytestmark = pytest.mark.usefixtures("jax_native")

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
S, D, DIM, BATCH, ROWS = 3, 2, 8, 128, 640
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
ROW_TOL = dict(rtol=1e-4, atol=1e-5)
_NAMES = dict(sparse_slots=[f"s{i}" for i in range(S)],
              dense_slots=[f"d{i}" for i in range(D)], label_slot="label")


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield
    disarm_faultpoints()
    jax_disarm_faultpoints()


def _dense(seed=0):
    rng = np.random.default_rng(seed)
    return {"state": {"w": rng.normal(size=32).astype(np.float32),
                      "b": rng.normal(size=4).astype(np.float32)},
            "opt": {"m": rng.normal(size=32).astype(np.float32)}}


def _flip_byte(path, off=None):
    size = os.path.getsize(path)
    off = size // 2 if off is None else off
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


# -- CRC32C + durability primitives ---------------------------------------------


def test_crc32c_known_vectors_and_chaining(tmp_path):
    assert crc32c(b"") == 0
    assert crc32c(b"123456789") == 0xE3069283  # the Castagnoli check word
    assert crc32c(bytes(32)) == 0x8A9136AA     # RFC 3720 B.4: 32 zero bytes
    data = np.random.default_rng(0).integers(0, 256, 200_003, dtype=np.uint8).tobytes()
    one = crc32c(data)
    acc = 0
    for lo in range(0, len(data), 7001):  # chaining == one-shot
        acc = crc32c(data[lo:lo + 7001], acc)
    assert acc == one
    p = tmp_path / "blob"
    p.write_bytes(data)
    assert crc32c_file(str(p), chunk=4096) == one


@pytest.mark.parametrize("n", [0, 1, 7, 1023, 1024, 1025, 4096 + 3, 200_003])
def test_crc32c_equals_jax(n):
    """The same CRC32C as the JAX package's, on random buffers, chained
    from a random start value too (exact)."""
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    start = int(rng.integers(0, 1 << 32))
    assert crc32c(data) == jax_crc32c(data)
    assert crc32c(data, start) == jax_crc32c(data, start)


def test_publish_atomic_directory(tmp_path):
    tmp = tmp_path / "stage.tmp"
    tmp.mkdir()
    (tmp / "a").write_text("payload")
    final = tmp_path / "published"
    publish_atomic(str(tmp), str(final))
    assert not tmp.exists() and (final / "a").read_text() == "payload"


# -- manifest / verify / corruption fallback (dense-only) --------------------------


def _mgr(tmp_path, **kw):
    return JobCheckpointManager(str(tmp_path / "ckpt"), **kw)


def _save_n(mgr, n, start=0):
    for i in range(start, start + n):
        mgr.save(step=i, cursor={"batch": i}, dense=_dense(i), blocking=True)


def test_save_load_roundtrip_and_manifest(tmp_path):
    mgr = _mgr(tmp_path)
    _save_n(mgr, 2)
    r = mgr.load_latest()
    assert r.step == 1 and r.cursor == {"batch": 1}
    want = _dense(1)
    np.testing.assert_array_equal(r.dense["state"]["w"], want["state"]["w"])
    np.testing.assert_array_equal(r.dense["opt"]["m"], want["opt"]["m"])
    man = verify_checkpoint(os.path.join(mgr.root, "ckpt_1"))
    assert man["step"] == 1 and man["dense"] is True
    assert man["format"] == "paddle_tpu.jobckpt.v1"
    assert set(man["artifacts"]) == {"dense.npz", "dense.meta.json"}
    mgr.stop()


def test_async_writer_publishes_and_latches_failures(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(step=0, cursor={"batch": 0}, dense=_dense(0))
    mgr.wait()
    assert mgr.load_latest().step == 0
    # a write failure on the background thread surfaces at the next wait
    arm_faultpoint("ckpt.artifact", "drop-frame")
    mgr.save(step=1, cursor={"batch": 1}, dense=_dense(1))
    with pytest.raises(FaultInjected):
        mgr.wait()
    disarm_faultpoints()
    # the failed snapshot never published; the manager keeps working
    mgr.save(step=2, cursor={"batch": 2}, dense=_dense(2))
    mgr.stop()
    assert mgr.load_latest().step == 2


def test_truncated_artifact_falls_back(tmp_path):
    mgr = _mgr(tmp_path)
    _save_n(mgr, 2)
    path = os.path.join(mgr.root, "ckpt_1", "dense.npz")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    r = mgr.load_latest()
    assert r.step == 0
    assert mgr.fallbacks and "truncated" in mgr.fallbacks[0][1]
    mgr.stop()


def test_bit_flipped_artifact_falls_back(tmp_path):
    mgr = _mgr(tmp_path)
    _save_n(mgr, 2)
    _flip_byte(os.path.join(mgr.root, "ckpt_1", "dense.npz"))
    r = mgr.load_latest()
    assert r.step == 0
    assert mgr.fallbacks and "CRC32C" in mgr.fallbacks[0][1]
    mgr.stop()


def test_missing_and_partial_manifest_fall_back(tmp_path):
    mgr = _mgr(tmp_path, max_keep=5)
    _save_n(mgr, 3)
    os.remove(os.path.join(mgr.root, "ckpt_2", "manifest.json"))
    with open(os.path.join(mgr.root, "ckpt_1", "manifest.json"), "r+") as f:
        f.truncate(20)  # torn mid-write: a valid prefix, invalid JSON
    r = mgr.load_latest()
    assert r.step == 0
    reasons = dict(mgr.fallbacks)
    assert "missing" in reasons[2] and "unreadable" in reasons[1]
    mgr.stop()


def test_parseable_manifest_corruption_falls_back(tmp_path):
    """A changed cursor digit leaves manifest.json parseable and every
    artifact CRC intact; only the manifest's self-checksum catches it,
    and a manifest stripped of it is corruption too."""
    mgr = _mgr(tmp_path, max_keep=5)
    _save_n(mgr, 2)
    mpath = os.path.join(mgr.root, "ckpt_1", "manifest.json")
    with open(mpath) as f:
        text = f.read()
    assert '"batch": 1' in text
    with open(mpath, "w") as f:
        f.write(text.replace('"batch": 1', '"batch": 9'))
    r = mgr.load_latest()
    assert r.step == 0
    assert mgr.fallbacks and "self-CRC32C" in mgr.fallbacks[0][1]
    man = json.loads(text)
    del man["manifest_crc32c"]
    with open(mpath, "w") as f:
        json.dump(man, f)
    with pytest.raises(CorruptCheckpointError, match="self-checksum"):
        verify_checkpoint(os.path.join(mgr.root, "ckpt_1"))
    mgr.stop()


def test_no_verified_checkpoint_raises_notfound(tmp_path):
    mgr = _mgr(tmp_path)
    with pytest.raises(NotFoundError):
        mgr.load_latest()
    _save_n(mgr, 1)
    _flip_byte(os.path.join(mgr.root, "ckpt_0", "dense.npz"))
    with pytest.raises(NotFoundError):
        mgr.load_latest()
    with pytest.raises(CorruptCheckpointError):
        verify_checkpoint(os.path.join(mgr.root, "ckpt_0"))
    mgr.stop()


def test_faultpoint_truncate_and_flip_are_checksum_detected(tmp_path):
    """The armed save-path faults corrupt AFTER the checksum is taken —
    exactly a torn write — so the verifier catches them."""
    mgr = _mgr(tmp_path, max_keep=5)
    _save_n(mgr, 1)
    arm_faultpoint("ckpt.artifact", "truncate-artifact")
    _save_n(mgr, 1, start=1)   # publishes, torn
    disarm_faultpoints()
    arm_faultpoint("ckpt.artifact", "flip-bytes")
    _save_n(mgr, 1, start=2)   # publishes, bit-flipped
    disarm_faultpoints()
    r = mgr.load_latest()
    assert r.step == 0 and len(mgr.fallbacks) == 2
    mgr.stop()


def test_kill_before_publish_leaves_no_published_ckpt(tmp_path):
    """A failure before the os.replace leaves only an unpublished .tmp:
    invisible to load, cleared by the next manager."""
    mgr = _mgr(tmp_path)
    _save_n(mgr, 1)
    arm_faultpoint("ckpt.publish", "drop-frame")
    mgr.save(step=1, cursor={"batch": 1}, dense=_dense(1))
    with pytest.raises(FaultInjected):
        mgr.wait()
    disarm_faultpoints()
    assert mgr._ids() == [0]
    assert os.path.isdir(os.path.join(mgr.root, "ckpt_1.tmp"))
    assert mgr.load_latest().step == 0
    mgr.stop()
    mgr2 = JobCheckpointManager(mgr.root)   # restart: stale tmp cleared
    assert not os.path.exists(os.path.join(mgr.root, "ckpt_1.tmp"))
    assert mgr2._ids() == [0]
    mgr2.stop()


def test_gc_keeps_max_keep_newest(tmp_path):
    mgr = _mgr(tmp_path, max_keep=2)
    _save_n(mgr, 4)
    assert mgr._ids() == [2, 3]
    mgr.stop()


def test_flags_of_the_manager_match_jax():
    from paddle_tpu.core.flags import get_flags as jax_get_flags
    from paddle_tpu_torch.core.flags import get_flags

    names = ["job_ckpt_max_keep", "job_ckpt_queue_depth", "ps_faultpoints"]
    assert get_flags(names) == jax_get_flags(names)


@pytest.mark.parametrize("first_get_delay_s", [0.0, 0.2])
def test_backpressured_save_does_not_hold_lifecycle_lock(tmp_path, first_get_delay_s):
    """A save() parked on a FULL writer queue holds no lifecycle lock, and
    a stop() concurrent with it writes every admitted snapshot in order.
    Each moment is reached by an event, not a wall-clock budget; the
    writer's first ``get`` is delayed by ``first_get_delay_s`` (0.2 s: a
    writer thread slow to start, as under a loaded test run), and the
    producer starts only once the writer holds snap 0."""
    import queue

    mgr = _mgr(tmp_path, queue_depth=1)
    release, parked, stopper_waits, holding = (threading.Event() for _ in range(4))
    wrote = []
    real_write = mgr._write

    def slow_write(snap):
        holding.set()  # the writer has taken this snapshot off the queue
        assert release.wait(120), "the test never released the writer"
        real_write(snap)
        wrote.append(snap.ckpt_id)

    class Parking(queue.Queue):
        gets = 0

        def get(self, *a, **kw):
            if self.gets == 0:
                time.sleep(first_get_delay_s)
            self.gets += 1
            return super().get(*a, **kw)

        def put(self, item, *a, **kw):
            if item is not None and self.full():
                parked.set()   # the producer is about to block on this put
            super().put(item, *a, **kw)

    class Watched(threading.Condition):
        def wait(self, *a, **kw):
            stopper_waits.set()
            return super().wait(*a, **kw)

    mgr._write = slow_write
    mgr._wq = Parking(maxsize=1)
    mgr._quiesced = Watched(mgr._mu)
    # the writer takes snap 0 and blocks; snap 1 fills the queue; snap 2
    # parks on the bounded put
    mgr.save(step=0, dense=_dense(0))
    assert holding.wait(120), "the writer never took snap 0"
    producer = threading.Thread(target=lambda: [mgr.save(step=1, dense=_dense(1)),
                                                mgr.save(step=2, dense=_dense(2))],
                                name="ckpt-producer")
    producer.start()
    assert parked.wait(120), "the producer never reached the full queue"
    # nothing else takes _mu: it is free exactly when the put runs unlocked
    assert mgr._mu.acquire(blocking=False), "_mu held through a backpressured queue put"
    mgr._mu.release()
    stopper = threading.Thread(target=mgr.stop, name="ckpt-stopper")
    stopper.start()
    assert stopper_waits.wait(120), "stop() did not wait for the in-flight save"
    release.set()
    producer.join(timeout=120)
    stopper.join(timeout=120)
    assert not producer.is_alive() and not stopper.is_alive()
    assert wrote == [0, 1, 2]          # FIFO, nothing behind the sentinel
    assert mgr.load_latest().step == 2


def test_save_is_a_copy_of_state_changed_in_place(tmp_path):
    """``save(blocking=False)`` returns while the writer still waits, the
    caller then changes its tensors and arrays IN PLACE (as the port's
    tier, cache and optimizer state can change), and the checkpoint holds
    the values at the save, bitwise."""
    mgr = _mgr(tmp_path)
    release = threading.Event()
    real_write = mgr._write

    def held_write(snap):
        assert release.wait(120)
        real_write(snap)

    mgr._write = held_write
    w = torch.arange(16, dtype=torch.float32)
    m = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    dense = {"state": {"w": w, "rows": [w[:4]]}, "opt": {"m": m}}
    want_w, want_m = w.clone(), m.copy()
    mgr.save(step=3, cursor={"batch": 3}, dense=dense)
    w.add_(1.0)
    m *= 2.0
    release.set()
    mgr.stop()
    got = mgr.load_latest().dense
    np.testing.assert_array_equal(got["state"]["w"], want_w.numpy())
    np.testing.assert_array_equal(got["state"]["rows"][0], want_w[:4].numpy())
    np.testing.assert_array_equal(got["opt"]["m"], want_m)


# -- sparse tables + gate ------------------------------------------------------------


def _cfg(**kw):
    return TableConfig(shard_num=4, accessor_config=AccessorConfig(
        sgd=SGDRuleConfig(initial_range=0.0)), **kw)


def _pushed_table(table, n, hi, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, hi, n).astype(np.uint64)
    table.pull_sparse(keys, create=True)
    push = np.zeros((len(keys), 12), np.float32)
    push[:, 1] = 1.0
    push[:, 3:] = rng.normal(0, 0.1, (len(keys), 9)).astype(np.float32)
    table.push_sparse(keys, push)
    return keys


def test_table_snapshot_restore_bit_exact(tmp_path):
    t = MemorySparseTable(_cfg())
    keys = _pushed_table(t, 700, 4096)
    mgr = _mgr(tmp_path)
    mgr.register_sparse("ctr", t)
    mgr.save(step=1, dense=None, blocking=True)
    r = mgr.load_latest()
    fresh = MemorySparseTable(_cfg())
    assert r.restore_sparse("ctr", fresh) == len(np.unique(keys))
    assert fresh.digest() == t.digest()
    # a restore target that is not fresh is digest-detected
    bad = MemorySparseTable(_cfg())
    bad.pull_sparse(np.asarray([1 << 40], np.uint64), create=True)
    with pytest.raises(CorruptCheckpointError):
        r.restore_sparse("ctr", bad)
    with pytest.raises(NotFoundError):
        r.restore_sparse("nope", fresh)
    mgr.stop()


def test_ssd_table_snapshot_restore_across_tiers(tmp_path):
    """Hot + cold rows of the two-tier table are captured and restored
    through the same surface; the restored digest covers both tiers."""
    cfg = _cfg(storage="ssd")
    t = SsdSparseTable(str(tmp_path / "ssd_a"), cfg)
    fresh = SsdSparseTable(str(tmp_path / "ssd_b"), cfg)
    try:
        keys = _pushed_table(t, 1500, 1 << 30)
        t.spill(300)   # most rows live in the cold tier at capture time
        mgr = _mgr(tmp_path)
        mgr.register_sparse("ssd", t)
        mgr.save(step=1, blocking=True)
        r = mgr.load_latest()
        assert r.restore_sparse("ssd", fresh) == len(np.unique(keys))
        assert fresh.digest() == t.digest()
        mgr.stop()
    finally:
        t.close()
        fresh.close()


def test_register_sparse_refuses_a_table_without_the_snapshot_surface(tmp_path):
    mgr = _mgr(tmp_path)
    with pytest.raises(PreconditionNotMetError, match="snapshot"):
        mgr.register_sparse("x", object())
    mgr.stop()


class _Servers:
    """Two in-process servers on 127.0.0.1 and a client, table 0 created."""

    def __init__(self, config=None):
        self.config = config or _cfg(table_id=0)
        self.servers = [rpc.NativePsServer(n_trainers=1) for _ in range(2)]
        self.endpoints = [f"127.0.0.1:{s.port}" for s in self.servers]
        self.client = rpc.RpcPsClient(self.endpoints)
        self.client.create_sparse_table(0, self.config)

    def table(self):
        return rpc.RemoteSparseTable(self.client, 0, self.config)

    def close(self):
        self.client.close()
        for s in self.servers:
            s.close()


def test_gate_cut_is_consistent_under_concurrent_pushes(tmp_path):
    """Captures taken while another client hammers pushes are
    self-consistent: the digest taken under the gate equals the row digest
    of the arrays captured (a torn cut cannot hash equal)."""
    cl = _Servers()
    stop = threading.Event()
    errors = []

    def hammer():
        cli2 = rpc.RpcPsClient(cl.endpoints)
        r = np.random.default_rng(2)
        try:
            while not stop.is_set():
                ks = r.integers(0, 512, 64).astype(np.uint64)
                push = np.zeros((64, 12), np.float32)
                push[:, 1] = 1.0
                push[:, 3:] = r.normal(0, 0.1, (64, 9)).astype(np.float32)
                cli2.push_sparse(0, ks, push)
        except BaseException as e:  # noqa: BLE001 — reported by the test
            errors.append(e)
        finally:
            cli2.close()

    try:
        cl.client.pull_sparse(0, np.random.default_rng(1).integers(0, 512, 256)
                              .astype(np.uint64), create=True)
        th = threading.Thread(target=hammer, name="hammer")
        th.start()
        try:
            mgr = _mgr(tmp_path, gate=CheckpointGate(servers=cl.servers), max_keep=8)
            mgr.register_sparse("ctr", cl.table())
            for i in range(3):
                mgr.save(step=i, blocking=True)
        finally:
            stop.set()
            th.join(timeout=60)
        assert not th.is_alive() and not errors, errors
        for no in mgr._ids():
            path = os.path.join(mgr.root, f"ckpt_{no}")
            man = verify_checkpoint(path)
            snap = ckpt.load(os.path.join(path, "sparse_ctr"))
            assert row_digest(np.ascontiguousarray(snap["keys"], np.uint64),
                              np.ascontiguousarray(snap["values"], np.float32)) \
                == man["tables"]["ctr"]["digest"]
        assert mgr.stats()["pause_ms_last"] > 0.0
        mgr.stop()
    finally:
        cl.close()


def test_pause_mutations_nests_and_rejects_an_unmatched_resume():
    """Paused, a push waits for the resume; the inner pair's resume leaves
    the outer pause on; an unmatched resume raises and changes nothing."""
    cl = _Servers()
    try:
        srv = cl.servers
        with pytest.raises(PreconditionNotMetError, match="without a matching pause"):
            srv[0].pause_mutations(False)
        keys = np.arange(1, 9, dtype=np.uint64)
        cl.client.pull_sparse(0, keys, create=True)
        push = np.zeros((8, 12), np.float32)
        push[:, 1] = 1.0
        for s in srv:
            s.pause_mutations(True)
            s.pause_mutations(True)   # nested
            s.pause_mutations(False)  # the inner resume: still paused
        landed = threading.Event()
        cli2 = rpc.RpcPsClient(cl.endpoints)

        def push_one():
            cli2.push_sparse(0, keys, push)
            landed.set()

        pusher = threading.Thread(target=push_one, name="pusher")
        pusher.start()
        # reads go on while mutations wait
        before = cl.client.snapshot_items(0)
        assert not landed.is_set()
        for s in srv:
            s.pause_mutations(False)
        pusher.join(timeout=60)
        cli2.close()
        assert landed.is_set() and not pusher.is_alive()
        after = cl.client.snapshot_items(0)
        assert len(before[0]) == len(after[0]) == 8
        assert after[1][:, 3].sum() > before[1][:, 3].sum()  # the shows landed
    finally:
        cl.close()


def test_checkpoint_gate_resumes_on_error_and_refuses_cluster():
    """The gate resumes every server when the capture raises, in both its
    forms; it refuses to be given both a cluster and servers (or
    neither), and its cluster form works: the routed primaries pause under
    the cluster's actuation section (failover scans suspended) and the
    backups hold the cut after its drain."""
    cl = _Servers()
    try:
        gate = CheckpointGate(servers=cl.servers)
        with pytest.raises(RuntimeError, match="capture failed"):
            with gate:
                raise RuntimeError("capture failed")
        # resumed: a push lands at once, and each server's depth is 0 again
        cl.client.pull_sparse(0, np.arange(4, dtype=np.uint64), create=True)
        assert all(s._pause_depth == 0 for s in cl.servers)
        with pytest.raises(PreconditionNotMetError, match="exactly one"):
            CheckpointGate(cluster=object(), servers=cl.servers)
        with pytest.raises(PreconditionNotMetError, match="exactly one"):
            CheckpointGate()
    finally:
        cl.close()
    with ha.HACluster(num_shards=2, replication=2, sync=True) as cluster:
        cli = cluster.client()
        cli.create_sparse_table(0, _cfg(table_id=0))
        keys = np.arange(1, 65, dtype=np.uint64)
        cli.pull_sparse(0, keys, create=True)
        gate = cluster.checkpoint_gate()
        with gate:
            prims = [cluster.primary(s).server for s in range(2)]
            assert all(p._pause_depth == 1 for p in prims)
            assert cluster.coordinator._suspended.is_set()
            for s in range(2):  # drained: the backups hold the cut
                assert len(set(cluster.digests(0, s).values())) == 1
        assert all(p._pause_depth == 0 for p in prims)
        assert not cluster.coordinator._suspended.is_set()
        with pytest.raises(RuntimeError, match="capture failed"):
            with gate:
                raise RuntimeError("capture failed")
        assert all(p._pause_depth == 0 for p in prims)
        assert not cluster.coordinator._suspended.is_set()
        cli.pull_sparse(0, keys + np.uint64(100), create=True)


def test_gate_cut_is_consistent_under_concurrent_pushes_on_a_cluster(tmp_path):
    """``tests/test_job_checkpoint.py``'s cut test on an ``HACluster``:
    captures under ``cluster.checkpoint_gate()`` while another client
    hammers pushes digest equal to the arrays they captured."""
    with ha.HACluster(num_shards=2, replication=2, sync=True) as cluster:
        cli = cluster.client()
        cli.create_sparse_table(0, _cfg(table_id=0))
        remote = rpc.RemoteSparseTable(cli, 0, _cfg(table_id=0))
        stop = threading.Event()
        errors = []

        def hammer():
            cli2 = cluster.client()
            r = np.random.default_rng(2)
            try:
                while not stop.is_set():
                    ks = r.integers(0, 512, 64).astype(np.uint64)
                    push = np.zeros((64, 12), np.float32)
                    push[:, 1] = 1.0
                    push[:, 3:] = r.normal(0, 0.1, (64, 9)).astype(np.float32)
                    cli2.push_sparse(0, ks, push)
            except BaseException as e:  # noqa: BLE001 — reported by the test
                errors.append(e)

        cli.pull_sparse(0, np.random.default_rng(1).integers(0, 512, 256).astype(np.uint64),
                        create=True)
        th = threading.Thread(target=hammer, name="hammer")
        th.start()
        try:
            mgr = _mgr(tmp_path, gate=cluster.checkpoint_gate(), max_keep=8)
            mgr.register_sparse("ctr", remote)
            for i in range(3):
                mgr.save(step=i, blocking=True)
        finally:
            stop.set()
            th.join(timeout=60)
        assert not th.is_alive() and not errors, errors
        for no in mgr._ids():
            path = os.path.join(mgr.root, f"ckpt_{no}")
            man = verify_checkpoint(path)
            snap = ckpt.load(os.path.join(path, "sparse_ctr"))
            assert row_digest(np.ascontiguousarray(snap["keys"], np.uint64),
                              np.ascontiguousarray(snap["values"], np.float32)) \
                == man["tables"]["ctr"]["digest"]
        assert mgr.stats()["pause_ms_last"] > 0.0
        mgr.stop()


# -- across the packages ---------------------------------------------------------


def _lines(n=ROWS, seed=0, nid=48):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        ids = rng.integers(0, nid, S)
        dense = rng.normal(size=D)
        label = int((ids % 5 == 0).sum() + dense[0] > 1.0)
        lines.append(" ".join([f"1 {v}" for v in ids] + [f"1 {v:.4f}" for v in dense]
                              + [f"1 {label}"]))
    return lines


def _dataset(lines, cls=InMemoryDataset, desc=SlotDesc):
    slots = ([desc(f"s{i}", is_float=False, max_len=1) for i in range(S)]
             + [desc(f"d{i}", is_float=True, max_len=1) for i in range(D)]
             + [desc("label", is_float=True, max_len=1)])
    ds = cls(slots, seed=0)
    ds.load_from_lines(lines)
    return ds


def _jax_cfg(**kw):
    return JaxTableConfig(shard_num=4, accessor_config=JaxAccessorConfig(
        sgd=JaxSGDRuleConfig(initial_range=0.0)), **kw)


def _jax_weights():
    """The JAX DeepFM's initial params and Adam state (numpy trees)."""
    pt.seed(0)
    model = JaxDeepFM(JaxCtrConfig(num_sparse_slots=S, num_dense=D, embedx_dim=DIM,
                                   dnn_hidden=(8,)))
    params = {"params": dict(model.named_parameters()), "buffers": {}}
    opt = jax_optimizer.Adam(1e-2).init(params)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return model, to_np(params), to_np(opt)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _sorted_rows(keys, values):
    i = np.argsort(keys)
    return keys[i], values[i]


def test_port_checkpoint_verifies_and_loads_in_jax(tmp_path):
    """A checkpoint the port writes (a trained table and the trainer's
    dense tier) verifies in the JAX package and loads there: keys and
    values bitwise, the JAX digest check of the restore passes, and the
    dense tree is the port trainer's, bitwise, through ``convert``."""
    table = MemorySparseTable(_cfg(backend="python"))
    tr = CtrStreamTrainer(DeepFM(CtrConfig(S, D, DIM, (8,)),
                                 generator=torch.Generator().manual_seed(0)),
                          Adam(1e-2), table, embedx_dim=DIM, device="cpu", **_NAMES)
    tr.train_from_dataset(_dataset(_lines()), batch_size=BATCH)
    mgr = _mgr(tmp_path)
    mgr.register_sparse("ctr", table)
    mgr.save(step=5, cursor={"batch": 5, "batch_size": BATCH}, dense=tr.train_state(),
             blocking=True)
    mgr.stop()
    path = os.path.join(mgr.root, "ckpt_0")
    man = jax_jc.verify_checkpoint(path)
    assert man["tables"]["ctr"]["digest"] == table.digest()
    r = jax_jc.JobCheckpointManager(mgr.root).load_latest()
    assert (r.ckpt_id, r.step, r.cursor) == (0, 5, {"batch": 5, "batch_size": BATCH})
    k, v = table.snapshot_items()
    np.testing.assert_array_equal(r.tables["ctr"][0], k)
    np.testing.assert_array_equal(r.tables["ctr"][1], v)
    fresh = JaxTable(_jax_cfg(backend="python"))
    assert r.restore_sparse("ctr", fresh) == len(k)   # JAX's digest check
    want = ctr_params_to_jax(tr.params)
    for name, a in want["params"].items():
        np.testing.assert_array_equal(np.asarray(r.dense["state"]["params"][name]), a)
    for slot in ("m", "v"):
        for name, a in ctr_params_to_jax(tr.opt_state[slot])["params"].items():
            np.testing.assert_array_equal(
                np.asarray(r.dense["opt"]["slots"][slot]["params"][name]), a)
    assert int(r.dense["opt"]["step"]) == int(tr.opt_state["step"]) == 5
    # and a JAX trainer takes the dense tier as its own
    jtr = JaxTrainer(JaxDeepFM(JaxCtrConfig(num_sparse_slots=S, num_dense=D, embedx_dim=DIM,
                                            dnn_hidden=(8,))),
                     jax_optimizer.Adam(1e-2), fresh, embedx_dim=DIM, **_NAMES)
    jtr.restore_train_state(r.dense)
    got = ctr_params_from_jax(jax.tree_util.tree_map(np.asarray, jtr.params))
    for name, t in tr.params.items():
        assert torch.equal(got[name], t), name


def test_jax_checkpoint_verifies_and_loads_in_port(tmp_path):
    """A checkpoint the JAX package writes verifies and loads in the port:
    rows bitwise, the port's digest check of the restore passes, and the
    port trainer restored from it holds the JAX trainer's params and Adam
    state, bitwise, through ``convert``."""
    model, _, _ = _jax_weights()
    jtable = JaxTable(_jax_cfg(backend="python"))
    jtr = JaxTrainer(model, jax_optimizer.Adam(1e-2), jtable, embedx_dim=DIM, **_NAMES)
    jtr.train_from_dataset(_dataset(_lines(), JaxDataset, JaxSlotDesc), batch_size=BATCH)
    jmgr = jax_jc.JobCheckpointManager(str(tmp_path / "ckpt"))
    jmgr.register_sparse("ctr", jtable)
    jmgr.save(step=5, cursor={"batch": 5, "batch_size": BATCH}, dense=jtr.train_state(),
              blocking=True)
    jmgr.stop()
    man = verify_checkpoint(os.path.join(jmgr.root, "ckpt_0"))
    assert man["format"] == "paddle_tpu.jobckpt.v1"
    r = JobCheckpointManager(jmgr.root).load_latest()
    assert r.cursor == {"batch": 5, "batch_size": BATCH}
    jk, jv = jtable.snapshot_items(0)
    np.testing.assert_array_equal(r.tables["ctr"][0], jk)
    np.testing.assert_array_equal(r.tables["ctr"][1], jv)
    fresh = MemorySparseTable(_cfg(backend="python"))
    assert r.restore_sparse("ctr", fresh) == len(jk)   # the port's digest check
    tr = CtrStreamTrainer(DeepFM(CtrConfig(S, D, DIM, (8,))), Adam(1e-2), fresh,
                          embedx_dim=DIM, device="cpu", **_NAMES)
    tr.restore_train_state(r.dense)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    want = ctr_params_from_jax(np_tree(jtr.params))
    want_opt = adam_state_from_jax(np_tree(jtr.opt_state))
    for name, t in want.items():
        assert torch.equal(tr.params[name], t), name
    assert int(tr.opt_state["step"]) == int(want_opt["step"])
    for slot in ("m", "v"):
        for name, t in want_opt[slot].items():
            assert torch.equal(tr.opt_state[slot][name], t), (slot, name)


def test_train_state_files_cross_load_with_their_rng(tmp_path):
    """``save_train_state``/``load_train_state`` in both directions: the
    trees bitwise (a bf16 leaf too), the step, and the rng as its key's
    raw data (the JAX side wraps it into a key)."""
    from paddle_tpu.io import checkpoint as jax_ckpt

    rng = np.random.default_rng(3)
    state = {"params": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                        "h": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}}
    opt = {"step": np.asarray(7, np.int32), "slots": {"m": {"w": np.ones((3, 4), np.float32)}}}
    key = np.asarray([0, 42], np.uint32)
    ckpt.save_train_state(str(tmp_path / "port"), state, opt, rng=key, step=7)
    got = jax_ckpt.load_train_state(str(tmp_path / "port"))
    assert got["step"] == 7
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(got["rng"])), key)
    np.testing.assert_array_equal(np.asarray(got["state"]["params"]["w"]), state["params"]["w"])
    np.testing.assert_array_equal(np.asarray(got["state"]["params"]["h"], np.float32),
                                  state["params"]["h"].float().numpy())
    np.testing.assert_array_equal(np.asarray(got["opt"]["slots"]["m"]["w"]), 1.0)

    jax_ckpt.save_train_state(str(tmp_path / "jax"), got["state"], got["opt"],
                              rng=jax.random.PRNGKey(42), step=9)
    back = ckpt.load_train_state(str(tmp_path / "jax"))
    assert back["step"] == 9 and int(back["opt"]["step"]) == 7
    np.testing.assert_array_equal(back["rng"], np.asarray(jax.random.key_data(
        jax.random.PRNGKey(42))))
    np.testing.assert_array_equal(back["state"]["params"]["w"], state["params"]["w"])
    assert torch.equal(back["state"]["params"]["h"], state["params"]["h"])
    assert ckpt.load_train_state(str(tmp_path / "port"))["rng"].tolist() == [0, 42]


# -- stream resume: bitwise against the port's own oracle, near JAX's ---------------

_SETTINGS = ["local", "hot_tier", "rpc", "rpc_hot_tier", "rpc_ha", "rpc_ha_hot_tier"]
_EVERY = 2   # checkpoint cadence: batches 2 and 4 of 5


def _nid(setting):
    # the hot-tier settings churn: 3 x 120 keys through a 256-row tier
    return 120 if setting.endswith("hot_tier") else 48


class _Job:
    """One process-equivalent of a job in ``setting`` on package ``pkg``
    ("port" or "jax"): a fresh table (or two fresh servers, or with
    ``rpc_ha`` a fresh 2 x 2 sync ``HACluster``, a client and a
    ``SyncCommunicator``), a trainer from the JAX DeepFM's seeded initial
    weights and, with ``root``, a checkpoint manager (gated over the
    servers, or by ``cluster.checkpoint_gate()``) with the table
    registered."""

    def __init__(self, pkg, setting, root=None):
        self.pkg, self.setting = pkg, setting
        port = pkg == "port"
        rpc_mod = rpc if port else jax_rpc
        cfg = (_cfg(table_id=0, backend="python") if port
               else _jax_cfg(table_id=0, backend="python"))
        hot = None
        if setting.endswith("hot_tier"):
            hot = (HotTierConfig if port else JaxHotTierConfig)(capacity=256)
        self.servers, self.client, self.comm, self.cluster = [], None, None, None
        if setting.startswith("rpc_ha"):
            self.cluster = (ha if port else jax_ha).HACluster(num_shards=2, replication=2,
                                                              sync=True)
            self.client = self.cluster.client()
        elif setting.startswith("rpc"):
            self.servers = [rpc_mod.NativePsServer(n_trainers=1) for _ in range(2)]
            self.client = rpc_mod.RpcPsClient([f"127.0.0.1:{s.port}" for s in self.servers])
        if setting.startswith("rpc"):
            self.client.create_sparse_table(0, cfg)
            self.comm = (SyncCommunicator if port else jax_comm.SyncCommunicator)(self.client)
            self.comm.start()
            self.table = rpc_mod.RemoteSparseTable(self.client, 0, cfg)
            local = None
        else:
            self.table = local = MemorySparseTable(cfg) if port else JaxTable(cfg)
        model, params, opt = _jax_weights()  # a fresh JAX model: its trainer donates
        if port:
            self.trainer = CtrStreamTrainer(
                DeepFM(CtrConfig(S, D, DIM, (8,))), Adam(1e-2), local,
                communicator=self.comm, table_id=0, embedx_dim=DIM, hot_tier=hot,
                device="cpu", **_NAMES)
            self.trainer.params = ctr_params_from_jax(params)
            self.trainer.opt_state = adam_state_from_jax(opt)
        else:
            self.trainer = JaxTrainer(model, jax_optimizer.Adam(1e-2), local,
                                      communicator=self.comm, table_id=0, embedx_dim=DIM,
                                      hot_tier=hot, **_NAMES)
        self.mgr = None
        if root is not None:
            gate = None
            if self.servers:
                gate = (CheckpointGate if port else jax_ha.CheckpointGate)(servers=self.servers)
            elif self.cluster is not None:
                gate = self.cluster.checkpoint_gate()
            self.mgr = (JobCheckpointManager if port else jax_jc.JobCheckpointManager)(
                str(root), max_keep=8, gate=gate)
            self.mgr.register_sparse("ctr", self.table)

    def dataset(self):
        lines = _lines(nid=_nid(self.setting))
        return _dataset(lines) if self.pkg == "port" else \
            _dataset(lines, JaxDataset, JaxSlotDesc)

    def train(self, **kw):
        kw.setdefault("checkpoint", self.mgr)
        kw.setdefault("checkpoint_every", _EVERY if self.mgr is not None else 0)
        return self.trainer.train_from_dataset(self.dataset(), batch_size=BATCH, **kw)

    def final(self):
        """(sorted keys, sorted rows, digest, dense trees) after the tier's
        flush; the dense trees in the JAX layout, as numpy leaves."""
        if self.trainer.hot_tier is not None:
            self.trainer.hot_tier.flush()
        k, v = _sorted_rows(*self.table.snapshot_items())
        if self.pkg == "port":
            dense = self.trainer.train_state()
        else:
            dense = jax.tree_util.tree_map(np.asarray, self.trainer.train_state())
        return k, v, combined_digest(self.table), dense

    def close(self):
        if self.mgr is not None:
            self.mgr.stop()
        if self.comm is not None:
            self.comm.stop()
        if self.client is not None:
            self.client.close()
        for s in self.servers:
            s.close()
        if self.cluster is not None:
            self.cluster.stop()


def _run_job_and_resume(pkg, setting, tmp):
    """The job checkpoints every ``_EVERY`` batches; a fresh job restores
    the newest checkpoint (batch 4) and trains the tail. Returns the
    resumed job's ``final()``."""
    job = _Job(pkg, setting, tmp / f"{pkg}_job")
    try:
        job.train()
        job.mgr.wait()
        restored = job.mgr.load_latest()
    finally:
        job.close()
    assert restored.cursor == {"batch": 4, "batch_size": BATCH}
    resumed = _Job(pkg, setting)
    try:
        restored.restore_sparse("ctr", resumed.table)
        resumed.trainer.restore_train_state(restored.dense)
        if resumed.trainer.hot_tier is not None:
            assert resumed.trainer.hot_tier.stats()["occupancy"] == 0
        if pkg == "port":
            with pytest.raises(Exception, match="record offset"):
                resumed.trainer.train_from_dataset(resumed.dataset(), batch_size=64,
                                                   start_batch=restored.cursor)
        out = resumed.train(start_batch=restored.cursor)
        assert out["steps"] == 1.0   # only the tail replayed
        return resumed.final()
    finally:
        resumed.close()


@pytest.mark.parametrize("setting", _SETTINGS)
def test_stream_resume_equals_uninterrupted_oracle_bitwise(setting, tmp_path):
    """Resume from the newest checkpoint ≡ a run that never stopped, bit
    for bit: every table row (delta_score too), the digest, the dense
    params and the Adam state. The oracle checkpoints at the same batches
    into its own root (the hot tier flushes at the same points)."""
    oracle = _Job("port", setting, tmp_path / "oracle")
    try:
        oracle.train()
        want = oracle.final()
    finally:
        oracle.close()
    got = _run_job_and_resume("port", setting, tmp_path)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    for a, b in zip(_leaves(got[3]), _leaves(want[3])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("setting", _SETTINGS)
def test_stream_resume_matches_jax_resume(setting, tmp_path):
    """The same job, checkpoint and resume in both packages from the same
    weights: the port's resumed rows and dense tier within the tolerances
    of ``test_torch_hot_tier.py`` of the JAX package's."""
    got = _run_job_and_resume("port", setting, tmp_path)
    want = _run_job_and_resume("jax", setting, tmp_path)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], **ROW_TOL)
    assert len(_leaves(got[3])) == len(_leaves(want[3]))
    for a, b in zip(_leaves(got[3]), _leaves(want[3])):
        np.testing.assert_allclose(a, b, **PARAM_TOL)


def test_trainer_checkpoint_is_not_changed_by_later_steps(tmp_path):
    """Non-blocking saves from the hot-tier trainer, training going on
    behind them: each published dense tier equals the trainer's state at
    its save, bitwise (the rows of the tier change in place on every
    step, the params on every update)."""
    job = _Job("port", "hot_tier", tmp_path / "job")
    at_save = {}
    real_save = job.mgr.save

    def recording_save(step, cursor=None, dense=None, blocking=False):
        at_save[step] = job.trainer.train_state()
        assert not blocking
        return real_save(step, cursor, dense, blocking)

    job.mgr.save = recording_save
    try:
        job.train()
        job.mgr.wait()
        assert sorted(at_save) == [2, 4]
        for no, step in enumerate((2, 4)):
            dense = ckpt.load_train_state(os.path.join(job.mgr.root, f"ckpt_{no}", "dense"))
            assert dense["step"] == step
            for a, b in zip(_leaves({"state": dense["state"], "opt": dense["opt"]}),
                            _leaves(at_save[step])):
                np.testing.assert_array_equal(a, b)
        assert not np.array_equal(_leaves(at_save[2])[0], _leaves(at_save[4])[0])
    finally:
        job.close()


def test_restore_train_state_drops_the_resident_set_and_round_trips():
    """Restoring into a trainer whose tier holds rows empties the tier (the
    cold table was rebuilt from the checkpoint), and a train_state round
    trip leaves params and Adam state bitwise as they were."""
    job = _Job("port", "hot_tier")
    try:
        job.train()
        assert job.trainer.hot_tier.stats()["occupancy"] > 0
        state = job.trainer.train_state()
        params = {k: v.clone() for k, v in job.trainer.params.items()}
        job.trainer.hot_tier.flush()
        job.trainer.restore_train_state(state)
        assert job.trainer.hot_tier.stats()["occupancy"] == 0
        for k, v in params.items():
            assert torch.equal(job.trainer.params[k], v), k
        assert int(job.trainer.opt_state["step"]) == 5
        with pytest.raises(PreconditionNotMetError, match="record offset"):
            job.trainer.train_from_dataset(job.dataset(), batch_size=64,
                                           start_batch={"batch": 1, "batch_size": BATCH})
        out = job.trainer.train_from_dataset(job.dataset(), batch_size=BATCH,
                                             start_batch={"batch": 4, "batch_size": BATCH})
        assert out["steps"] == 1.0 and out["hot_tier"]["misses"] > 0   # refilled on miss
    finally:
        job.close()


@pytest.mark.parametrize("setting", ["hot_tier", "rpc_hot_tier"])
def test_on_reshard_flushes_and_keeps_the_resident_set(setting):
    """``on_reshard()`` at a batch boundary: the tier's dirty rows reach
    the cold table (its rows then equal the tier's), the resident set
    stays, and the tier counts the reshard."""
    job = _Job("port", setting)
    try:
        job.train(checkpoint=None, checkpoint_every=0)
        tier = job.trainer.hot_tier
        before = tier.stats()
        assert before["dirty"] > 0
        job.trainer.on_reshard()
        after = tier.stats()
        assert after["dirty"] == 0 and after["occupancy"] == before["occupancy"]
        assert after["reshards"] == before["reshards"] + 1
        keys, values = job.table.snapshot_items()
        assert tier.flush() == 0   # nothing left to write
        np.testing.assert_array_equal(job.table.snapshot_items()[1], values)
    finally:
        job.close()


# -- THE acceptance run: SIGKILL the whole job mid-save, restart, resume -----------

_JOB_SCRIPT = r"""
import os, sys
import numpy as np
import torch
from paddle_tpu_torch.data.dataset import InMemoryDataset, SlotDesc
from paddle_tpu_torch.io import checkpoint as ckpt
from paddle_tpu_torch.io.job_checkpoint import JobCheckpointManager
from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.ps import ha, rpc
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.communicator import SyncCommunicator
from paddle_tpu_torch.ps.faultpoints import arm_faultpoint
from paddle_tpu_torch.ps.ha import CheckpointGate
from paddle_tpu_torch.ps.hot_tier import HotTierConfig
from paddle_tpu_torch.ps.ps_trainer import CtrStreamTrainer
from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig
from paddle_tpu_torch.ps.table import TableConfig

phase, root, out = sys.argv[1], sys.argv[2], sys.argv[3]
S, D, B, ROWS = 3, 2, 128, 640
rng = np.random.default_rng(0)
lines = []
for _ in range(ROWS):
    ids = rng.integers(0, 120, S)
    dense = rng.normal(size=D)
    label = int((ids % 5 == 0).sum() + dense[0] > 1.0)
    lines.append(" ".join([f"1 {v}" for v in ids] + [f"1 {v:.4f}" for v in dense]
                          + [f"1 {label}"]))
slots = ([SlotDesc(f"s{i}", is_float=False, max_len=1) for i in range(S)]
         + [SlotDesc(f"d{i}", is_float=True, max_len=1) for i in range(D)]
         + [SlotDesc("label", is_float=True, max_len=1)])
ds = InMemoryDataset(slots, seed=0)
ds.load_from_lines(lines)
cfg = TableConfig(table_id=0, shard_num=4, accessor_config=AccessorConfig(
    sgd=SGDRuleConfig(initial_range=0.0)))
servers = [rpc.NativePsServer(n_trainers=1) for _ in range(2)]
cli = rpc.RpcPsClient([f"127.0.0.1:{s.port}" for s in servers])
cli.create_sparse_table(0, cfg)
comm = SyncCommunicator(cli)
comm.start()
tr = CtrStreamTrainer(
    DeepFM(CtrConfig(S, D, 8, (8,)), generator=torch.Generator().manual_seed(0)),
    Adam(1e-2), None, communicator=comm, table_id=0, embedx_dim=8,
    hot_tier=HotTierConfig(capacity=256), device="cpu",
    sparse_slots=[f"s{i}" for i in range(S)], dense_slots=[f"d{i}" for i in range(D)],
    label_slot="label")
mgr = JobCheckpointManager(root, gate=CheckpointGate(servers=servers), max_keep=10)
mgr.register_sparse("ctr", rpc.RemoteSparseTable(cli, 0, cfg))
if phase == "victim":
    # SIGKILL in the third checkpoint's manifest write: ckpt 0 and 1
    # publish, ckpt 2 dies unpublished, and the servers die with the job
    arm_faultpoint("ckpt.manifest", "kill-job", after=3)
    tr.train_from_dataset(ds, batch_size=B, checkpoint=mgr, checkpoint_every=1)
    mgr.stop()   # drains the writer: the armed kill must have fired
    print("SURVIVED", flush=True)
    sys.exit(3)
start = 0
if phase == "resume":
    r = mgr.load_latest()
    r.restore_sparse("ctr", mgr._tables["ctr"])
    tr.restore_train_state(r.dense)
    start = r.cursor
    print("META", r.ckpt_id, r.cursor["batch"], len(mgr.fallbacks), flush=True)
# the oracle checkpoints at the victim's cadence too: the hot tier then
# flushes at the same batches
tr.train_from_dataset(ds, batch_size=B, start_batch=start, checkpoint=mgr,
                      checkpoint_every=1)
mgr.stop()
tr.hot_tier.flush()
comm.stop()
keys = np.unique((np.arange(120, dtype=np.uint64)[None, :]
                  + (np.arange(S, dtype=np.uint64)[:, None] << np.uint64(32))).reshape(-1))
ckpt.save({"pulled": cli.pull_sparse(0, keys, create=False), "dense": tr.train_state()}, out)
cli.close()
for s in servers:
    s.close()
print("DONE", flush=True)
"""


def _run_job(phase, root, out):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", _JOB_SCRIPT, phase, str(root), str(out)],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=300)


def test_job_sigkill_mid_save_resume_bit_identical(tmp_path):
    """The whole job (trainer, hot tier over two in-process servers, the
    checkpoint writer) is SIGKILLed in its third save; the newest PUBLISHED
    checkpoint is then corrupted too. The restart detects it by checksum,
    falls back to ckpt_0 and ends bit-identical to the oracle: the rows
    pulled for every key of the data, the dense params and Adam state."""
    load_ssd()   # build the PS library here once, not inside the children's timeouts
    root = tmp_path / "jobckpt"
    p = _run_job("oracle", tmp_path / "oracle_root", tmp_path / "oracle")
    assert p.returncode == 0 and "DONE" in p.stdout, p.stdout + p.stderr
    p = _run_job("victim", root, tmp_path / "victim")
    assert p.returncode == -9, (p.returncode, p.stdout, p.stderr)  # SIGKILL
    assert "SURVIVED" not in p.stdout
    ids = sorted(int(d.split("_")[1]) for d in os.listdir(root)
                 if d.startswith("ckpt_") and not d.endswith(".tmp"))
    assert ids == [0, 1]   # ckpt 2 died unpublished
    _flip_byte(os.path.join(root, "ckpt_1", "sparse_ctr.npz"))
    p = _run_job("resume", root, tmp_path / "resume")
    assert p.returncode == 0 and "DONE" in p.stdout, p.stdout + p.stderr
    meta = [line for line in p.stdout.splitlines() if line.startswith("META")][0]
    _, ckpt_id, cursor, fallbacks = meta.split()
    assert (int(ckpt_id), int(cursor), int(fallbacks)) == (0, 1, 1)
    want = ckpt.load(str(tmp_path / "oracle"))
    got = ckpt.load(str(tmp_path / "resume"))
    np.testing.assert_array_equal(got["pulled"], want["pulled"])
    for a, b in zip(_leaves(got["dense"]), _leaves(want["dense"])):
        np.testing.assert_array_equal(a, b)


def test_chip_smoke_phase_15_on_the_cpu(monkeypatch):
    """``chip_smoke.py`` phase 15 (the job restarts) end to end on the CPU
    at a small size (2,048 lines, 400 ids a slot, batch 128, a 2^14-row
    tier: 16 batches, checkpoints every 4): the victim dies with -9 in its
    third save, the flipped ckpt_1 sends the resume back to ckpt_0, and
    the resumed run equals the oracle bitwise (the phase's own checks;
    the launch counts are the card's only)."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    load_ssd()
    for name, v in (("JOBCKPT_LINES", 2048), ("JOBCKPT_IDS", 400), ("JOBCKPT_BATCH", 128),
                    ("JOBCKPT_CAP", 1 << 14)):
        monkeypatch.setattr(chip_smoke, name, v)
    chip_smoke.phase_job_checkpoint(torch.device("cpu"), "cpu")
