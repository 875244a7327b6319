"""The explorer's harness models over the port's real classes and
miniatures (``paddle_tpu_torch.testing.models``: the serving fleet's
drain against its watcher tick, the SSD tier's two-phase compactor, the
checkpoint writer against ``stop()``) against the JAX repo's models over
the JAX package, on the CPU: cases of ``tests/test_sched.py`` (the
explorer itself and the three-way harness are in
``tests/test_torch_sched.py``, the reconciler's miniature in
``tests/test_torch_sched_reconciler.py``).

The records compared with ``==`` are those of ``test_torch_sched.py``:
failures, shrunk and pinned schedules, sweep sizes, exhaustion, observed
lock edges and seeded decision logs.

Tolerance: exact.
"""

import os

from test_torch_sched import both, decls, dfs, replay, walk

#: the fleet tick that re-admitted a fully drained member before the raced
#: re-check: 34 choices as found (unshrunk — the window needs the whole
#: drain inside it)
FLEET_READMIT_SCHEDULE = ["drain"] * 3 + ["tick"] * 9 + ["drain"] * 10 + ["tick"] * 12

#: the naive compaction publisher losing a push-path rewrite: five choices
SSD_STALE_PUBLISH_SCHEDULE = ["bg", "bg", "bg", "bg", "save"]


def _fleet(p):
    ex, rec = dfs(p, p.models.fleet_drain_tick_model(), 2, max_schedules=20000)
    rec["pinned"] = replay(ex, choices=FLEET_READMIT_SCHEDULE)
    rec["traces"] = [replay(ex, seed=s)["log"] for s in (1, 2, 3)]
    return rec


def test_fleet_drain_tick_pb2_exhausts_clean():
    got = both(_fleet)
    assert got["failure"] is None and got["exhausted"]
    assert got["pinned"]["failure"] is None


def _ssd_naive(p):
    ex, rec = dfs(p, p.models.ssd_compact_model(two_phase=False, with_shrink=False), 2,
                  max_schedules=5000)
    rec["pinned"] = replay(ex, choices=SSD_STALE_PUBLISH_SCHEDULE)
    return rec


def test_ssd_compact_naive_publisher_found_and_pins():
    got = both(_ssd_naive)
    assert got["failure"]["kind"] == "invariant"
    assert any(s in got["failure"]["message"] for s in ("lost", "BOTH tiers", "resurrected"))
    assert "rewrite lost" in got["pinned"]["failure"]["message"]


def _ssd_pb1(p):
    ex, rec = dfs(p, p.models.ssd_compact_model(with_shrink=False), 1, max_schedules=10000)
    rec["pinned"] = replay(ex, choices=SSD_STALE_PUBLISH_SCHEDULE)
    return rec


def test_ssd_compact_fixed_pb1_exhausts_clean():
    got = both(_ssd_pb1)
    assert got["failure"] is None and got["exhausted"]
    assert got["pinned"]["failure"] is None


def _ssd_walk(p):
    ex, rec = walk(p, p.models.ssd_compact_model(), 300, 20260807)
    rec["traces"] = [replay(ex, seed=s)["log"] for s in (1, 2)]
    return rec


def test_ssd_compact_random_walk_with_shrink_clean():
    got = both(_ssd_walk)
    assert got["failure"] is None and got["schedules"] == 300


def _ssd_decls(p):
    edges, leaves = decls(p)
    return (sorted(edges.get("disk_mu", ())), sorted(edges.get("shard_mu", ())),
            sorted(edges.get("ssd_save_mu", ())), "io_mu" in leaves)


def test_ssd_csrc_lock_decls_loaded():
    disk, shard, save, io_leaf = both(_ssd_decls)
    assert "bg_mu" in disk and "disk_mu" in shard and "mem_save_mu" in save and io_leaf


def _ckpt(p, root):
    return dfs(p, p.models.ckpt_writer_model(root=os.path.join(root, p.name)), 1,
               max_schedules=10000)[1]


def test_ckpt_writer_pb1_exhausts_clean(tmp_path):
    got = both(_ckpt, str(tmp_path))
    assert got["failure"] is None and got["exhausted"]
