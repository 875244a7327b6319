"""The SSD tier's scale surface in the port against the JAX package's, on
the CPU: the port's counterparts of ``tests/test_ssd_cold_tier.py`` (but
its ``slow`` endurance case) and of the streaming-file cases of
``tests/test_ssd_table.py``.

Each case feeds the same numpy-seeded keys, rows and pushes into both
packages' ``SsdSparseTable`` (the port's copy of ``csrc/ssd_table.cc`` and
the JAX package's) and holds pulls and ``digest()`` bitwise, and the stat
counters that the per-instance hash salt does not move (``_stats``):

- ``io_serve_bytes`` is left out everywhere: the cold index keeps 12-bit
  fingerprints of salted hashes and reads a record to verify a match, so
  the bytes a lookup reads depend on the salt;
- ``disk_bytes`` is left out for block-compressed logs: which records
  share a 128-record block follows the order in which a spill walks the
  salted hash index, and a block's deflated size depends on its records;
- the background compactor's counters (``bg_compactions``,
  ``bg_backlog``, ``io_bg_bytes``, ``io_bg_wait_ms``) follow the
  thread's timing, not the data, so the cases that run it hold each
  package to the same properties instead of to each other;
- the admission counters depend on the salt only through collisions in
  the counting sketch; the cases size it (``SKETCH_KB`` a shard for at
  most 75 keys a shard) so that a key's two counters both colliding has
  odds below 1e-7 a case, and compare them.

Both packages' tables run one engine, so every comparison is exact.
"""

import dataclasses
import glob
import gzip
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from paddle_tpu.obs import registry as jax_registry
from paddle_tpu.ps import native as jax_native_mod
from paddle_tpu.ps.accessor import AccessorConfig as JaxAccessorConfig
from paddle_tpu.ps.client import LocalPsClient as JaxLocalPsClient
from paddle_tpu.ps.client import PsServerHandle as JaxPsServerHandle
from paddle_tpu.ps.config import load_ps_config as jax_load_ps_config
from paddle_tpu.ps.sgd_rule import SGDRuleConfig as JaxSGDRuleConfig
from paddle_tpu.ps.table import SsdSparseTable as JaxSsdTable
from paddle_tpu.ps.table import TableConfig as JaxTableConfig
from paddle_tpu_torch.obs import registry as port_registry
from paddle_tpu_torch.obs.slo import cold_tier_rules
from paddle_tpu_torch.ps import native as port_native
from paddle_tpu_torch.ps import table as port_table
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.client import LocalPsClient, PsServerHandle
from paddle_tpu_torch.ps.config import load_ps_config
from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig
from paddle_tpu_torch.ps.table import SsdSparseTable, TableConfig
from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

# the JAX SSD table is native only
pytestmark = pytest.mark.usefixtures("jax_native")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKETCH_KB = 1024
_TIMING = ("bg_compactions", "bg_backlog", "io_bg_bytes", "io_bg_wait_ms")

PORT = dict(table=SsdSparseTable, cfg=TableConfig, acc=AccessorConfig, sgd=SGDRuleConfig)
JAX = dict(table=JaxSsdTable, cfg=JaxTableConfig, acc=JaxAccessorConfig, sgd=JaxSGDRuleConfig)


def _cfg(pkg, acc=None, initial_range=0.0, **kw):
    """The JAX test's table: 4 shards, embedx dim 4, embedx from the
    first push; ``acc`` adds accessor fields."""
    kw.setdefault("shard_num", 4)
    kw.setdefault("storage", "ssd")
    kw.setdefault("ssd_admission_sketch_kb", SKETCH_KB)
    a = pkg["acc"](**{"sgd": pkg["sgd"](initial_range=initial_range), "embedx_dim": 4,
                      "embedx_threshold": 0.0, **(acc or {})})
    return pkg["cfg"](accessor_config=a, **kw)


def _comp(**kw):
    """fp16 values, block-compressed logs, and a shrink that ages rows
    without deleting them."""
    kw.setdefault("ssd_value_dtype", "fp16")
    kw.setdefault("ssd_block_compress", True)
    kw.setdefault("acc", {"delete_threshold": 0.0})
    return kw


def _pair(tmp_path, name, **kw):
    """(port table, JAX table) at ``tmp_path/name/{port,jax}``."""
    return tuple(pkg["table"](str(tmp_path / name / side), _cfg(pkg, **kw))
                 for side, pkg in (("port", PORT), ("jax", JAX)))


def _grad(table, keys, seed):
    rng = np.random.default_rng(seed)
    push = np.zeros((len(keys), 4 + table.accessor.config.embedx_dim), np.float32)
    push[:, 0] = (keys % 8).astype(np.float32)
    push[:, 1] = 1.0
    push[:, 3:] = rng.normal(size=(len(keys), push.shape[1] - 3)).astype(np.float32)
    return push


def _cold_rows(full_dim, n, seed, scale=1.0):
    """The JAX test's cold population: show 1, a random embed_w, zero
    optimizer state (so block compression has something to find)."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, 1 << 40, n).astype(np.uint64))
    vals = np.zeros((len(keys), full_dim), np.float32)
    vals[:, 3] = 1.0
    vals[:, 5] = scale * rng.normal(size=len(keys)).astype(np.float32)
    return keys, vals


def _stats(table, compressed=False):
    st = table.stats()
    drop = ("io_serve_bytes",) + _TIMING + (("disk_bytes",) if compressed else ())
    return {k: v for k, v in st.items() if k not in drop}


def _same(t, j, what, compressed=False, keys=None):
    assert t.digest() == j.digest(), what
    assert _stats(t, compressed) == _stats(j, compressed), what
    if keys is not None:
        assert np.array_equal(t.pull_sparse(keys, create=False),
                              j.pull_sparse(keys, create=False)), what


def _both(tables, fn):
    for t in tables:
        fn(t)


def _close(*tables):
    for t in tables:
        t.close()


# -- admission --------------------------------------------------------------------


def test_admission_defers_row_creation(tmp_path):
    """Threshold 2: a pull never admits, the first push only counts the
    key (its gradient dropped), the second creates the row and applies its
    own gradient: one push on an ungated table, in both packages."""
    gated = _pair(tmp_path, "g", ssd_admission_threshold=2)
    plain = _pair(tmp_path, "p")
    keys = np.arange(1, 201, dtype=np.uint64)
    g1, g2 = _grad(gated[0], keys, 1), _grad(gated[0], keys, 2)
    for t in gated:
        t.pull_sparse(keys, create=True)
        assert t.size() == 0
        t.push_sparse(keys, g1)
        assert t.size() == 0
        t.push_sparse(keys, g2)
        assert t.size() == len(keys)
    _same(*gated, "gated", keys=keys)
    st = gated[0].stats()
    assert st["admit_admitted"] == len(keys) and st["admit_rejects"] >= len(keys)
    assert st["admit_checks"] >= 2 * len(keys) and st["sketch_bytes"] > 0
    _both(plain, lambda t: t.push_sparse(keys, g2))
    _same(*plain, "plain", keys=keys)
    assert np.array_equal(gated[0].pull_sparse(keys, create=False),
                          plain[0].pull_sparse(keys, create=False))
    _close(*gated, *plain)


def test_unadmitted_pull_serves_the_init_row(tmp_path):
    """Below the threshold a pull serves the row create would have made
    (a per-key draw, ``initial_range`` 0.1), and creates nothing."""
    gated = _pair(tmp_path, "g", initial_range=0.1, ssd_admission_threshold=3)
    plain = _pair(tmp_path, "p", initial_range=0.1)
    keys = np.arange(1, 301, dtype=np.uint64)
    pulls = [t.pull_sparse(keys, create=True) for t in (*gated, *plain)]
    for p in pulls[1:]:
        assert np.array_equal(p, pulls[0])
    assert [t.size() for t in (*gated, *plain)] == [0, 0, len(keys), len(keys)]
    _same(*gated, "gated")
    _close(*gated, *plain)


def test_admission_sketch_decays_with_shrink(tmp_path):
    """shrink() halves every sketch counter: a count of 1 falls to 0, so
    one more push does not admit, the next does."""
    pair = _pair(tmp_path, "t", ssd_admission_threshold=2)
    keys = np.arange(1, 101, dtype=np.uint64)
    g = _grad(pair[0], keys, 0)
    for t in pair:
        t.push_sparse(keys, g)
        t.shrink()
        t.push_sparse(keys, g)
        assert t.size() == 0
    _same(*pair, "after the decay")
    _both(pair, lambda t: t.push_sparse(keys, g))
    assert pair[0].size() == len(keys)
    _same(*pair, "admitted", keys=keys)
    _close(*pair)


def test_accessor_admission_threshold_is_the_default(tmp_path):
    """``AccessorConfig.admission_threshold`` applies when the table's knob
    is 0, and ``TableConfig.ssd_admission_threshold`` wins when set."""
    by_acc = _pair(tmp_path, "a", acc={"admission_threshold": 2})
    table_wins = _pair(tmp_path, "b", acc={"admission_threshold": 2},
                       ssd_admission_threshold=3)
    keys = np.arange(1, 51, dtype=np.uint64)
    g = _grad(by_acc[0], keys, 0)
    for n_push, want in ((1, (0, 0)), (2, (len(keys), 0)), (3, (len(keys), len(keys)))):
        for t in (*by_acc, *table_wins):
            t.push_sparse(keys, g)
        assert (by_acc[0].size(), table_wins[0].size()) == want, n_push
        _same(*by_acc, f"accessor threshold, push {n_push}", keys=keys)
        _same(*table_wins, f"table threshold, push {n_push}", keys=keys)
    _close(*by_acc, *table_wins)


# -- the compact index --------------------------------------------------------------


def test_index_bytes_per_row_within_16(tmp_path):
    """60,000 cold rows: the cold index takes at most 16 bytes a row, the
    same count in both packages."""
    pair = _pair(tmp_path, "t")
    keys, vals = _cold_rows(pair[0].full_dim, 60_000, 0)
    for t in pair:
        t.import_full(keys, vals)
        t.spill(0)
    st = pair[0].stats()
    assert st["cold_rows"] > 50_000 and st["index_bytes"] > 0
    assert 0 < st["index_bytes_per_row"] <= 16.0, st["index_bytes_per_row"]
    _same(*pair, "spilled")
    _close(*pair)


# -- block-compressed fp16 logs -----------------------------------------------------


def test_block_compress_round_trips_digest_exact(tmp_path):
    """Write, spill, shrink (ages every cold row), compact, reopen (log
    replay), raw ``save_file`` and ``load_file``: the digest holds at every
    hop and equals the JAX table's."""
    pair = _pair(tmp_path, "a", **_comp())
    keys, vals = _cold_rows(pair[0].full_dim, 3000, 1)
    for t in pair:
        t.import_full(keys, vals)
        t.spill(0)
        t.shrink()
        assert t.size() == len(keys)
    _same(*pair, "shrunk", compressed=True)
    dg = pair[0].digest()
    want = pair[0].pull_sparse(keys[:64], create=False)
    for t in pair:
        t.spill(0)
        assert t.digest() == dg
        t.compact()
        assert t.digest() == dg
        t.flush()
        t.close()
    back = tuple(pkg["table"](str(tmp_path / "a" / side), _cfg(pkg, **_comp()))
                 for side, pkg in (("port", PORT), ("jax", JAX)))
    for t in back:
        assert t.digest() == dg
        assert np.array_equal(t.pull_sparse(keys[:64], create=False), want)
    assert back[0].save_file(str(tmp_path / "ck.raw"), fmt="raw") == len(keys)
    loaded = _pair(tmp_path, "b", **_comp())
    for t in loaded:
        assert t.load_file(str(tmp_path / "ck.raw"), fmt="raw") == len(keys)
        assert t.digest() == dg
    _close(*back, *loaded)


def test_block_compress_shrinks_disk_bytes(tmp_path):
    """Sparse CTR rows (zero optimizer state) pack below 0.7 of the plain
    fp16 log, in both packages; the plain logs' bytes are equal."""
    sizes = {}
    for name, kw in (("raw", {"ssd_value_dtype": "fp16"}), ("comp", _comp())):
        pair = _pair(tmp_path, name, **kw)
        keys, vals = _cold_rows(pair[0].full_dim, 4000, 2)
        for t in pair:
            t.import_full(keys, vals)
            t.spill(0)
            t.flush()
        _same(*pair, name, compressed=name == "comp")
        sizes[name] = [t.stats()["disk_bytes"] for t in pair]
        _close(*pair)
    assert sizes["raw"][0] == sizes["raw"][1]
    for side in (0, 1):
        assert sizes["comp"][side] < 0.7 * sizes["raw"][side], sizes


def test_block_compress_torn_tail_recovers_its_prefix(tmp_path):
    """A write torn mid-block: replay keeps every sealed block before the
    tear (at most one 128-record block lost), in the port as in JAX, and
    each package reads the other's torn log the same."""
    pair = _pair(tmp_path, "t", **_comp(shard_num=1))
    keys, vals = _cold_rows(pair[0].full_dim, 2000, 3)
    for t in pair:
        t.import_full(keys, vals)
        t.spill(0)
        t.flush()
        t.close()
    for side in ("port", "jax"):
        logs = [f for f in glob.glob(str(tmp_path / "t" / side / "*"))
                if not f.endswith(".compact")]
        assert len(logs) == 1
        with open(logs[0], "r+b") as f:
            f.truncate(os.path.getsize(logs[0]) - 37)
    got = {}
    for side in ("port", "jax"):
        for reader, pkg in (("port", PORT), ("jax", JAX)):
            t = pkg["table"](str(tmp_path / "t" / side), _cfg(pkg, **_comp(shard_num=1)))
            st = t.stats()
            assert len(keys) - 128 <= st["cold_rows"] < len(keys)
            rows = t.pull_sparse(keys, create=False)
            assert np.isfinite(rows).all()
            got[side, reader] = (t.digest(), st["cold_rows"], rows)
            t.close()
        (pd, pc, pr), (jd, jc, jr) = got[side, "port"], got[side, "jax"]
        assert (pd, pc) == (jd, jc) and np.array_equal(pr, jr), side


# -- the pass cache over an admission-gated table -----------------------------------


def test_pass_flush_offers_unadmitted_keys_to_admission(tmp_path):
    """The port's pass cache over a gated table (threshold 2): the pass
    build serves the init rows of the keys the table lacks without creating
    them, and the flush offers each as one observation (a push of the
    pass's show and click, no gradient), so a key in two passes gets its row
    at the second flush. (The JAX package's pass cache raises at that flush:
    it has no admission on the pass path.) The table equals the JAX SSD
    table fed the same observations. A row that goes missing mid-pass
    still fails the flush, on a gated table as on one without admission:
    only the keys the build was served init rows for are offered."""
    import torch

    from paddle_tpu_torch.core.enforce import EnforceNotMet
    from paddle_tpu_torch.ps import embedding_cache as tec

    t, j = _pair(tmp_path, "g", ssd_admission_threshold=2, acc={"embedx_threshold": 1.0})
    cache = tec.HbmEmbeddingCache(t, tec.CacheConfig(capacity=512, embedx_dim=4,
                                                     embedx_threshold=1.0), device="cpu")
    rng = np.random.default_rng(3)
    held = np.arange(1, 101, dtype=np.uint64)
    tail = (1 << 20) + np.arange(200, dtype=np.uint64)
    _both((t, j), lambda x: x.push_sparse(held, _grad(t, held, 0)))  # count 1
    _both((t, j), lambda x: x.push_sparse(held, _grad(t, held, 1)))  # admitted
    passes = (np.concatenate([held[:60], tail[:150]]), np.concatenate([held[40:], tail[100:]]))
    for n, keys in enumerate(passes):
        cache.begin_pass(keys)
        j.export_full(np.unique(keys), create=True)  # the JAX side of the build: probes only
        assert t.size() == j.size() == len(held)  # the build made no tail row
        bkeys = keys[rng.integers(0, len(keys), 256)]
        shows = np.ones(len(bkeys), np.float32)
        clicks = (rng.random(len(bkeys)) < 0.3).astype(np.float32)
        grads = rng.normal(size=(len(bkeys), 5)).astype(np.float32)
        tec.cache_push(cache.state, torch.from_numpy(cache.lookup(bkeys).astype(np.int64)),
                       torch.from_numpy(grads), torch.from_numpy(shows),
                       torch.from_numpy(clicks), cache.config)
        # the JAX table's side: the tail's observations, the held keys' flushed rows
        uniq = np.unique(keys)
        new = uniq[uniq >= tail[0]]
        obs = np.zeros((len(new), 8), np.float32)
        np.add.at(obs[:, 1], np.searchsorted(new, bkeys[bkeys >= tail[0]]), 1.0)
        np.add.at(obs[:, 2], np.searchsorted(new, bkeys[bkeys >= tail[0]]),
                  clicks[bkeys >= tail[0]])
        cache.end_pass()
        j.push_sparse(new, obs)
        old = uniq[uniq < tail[0]]
        j.import_full(old, t.export_full(old)[0])
        want = len(held) + (0 if n == 0 else 50)  # tail[100:150] came in both passes
        assert t.size() == j.size() == want, (n, t.size(), j.size())
        _same(t, j, f"pass {n}", keys=np.concatenate([held, tail]))
    st = t.stats()
    assert st["admit_admitted"] >= len(held) + 50 and st["admit_rejects"] > 0
    _close(t, j)
    # rows that vanish mid-pass (a shrink deletes them: score below
    # delete_threshold 0.8) still fail the flush, with admission (rows the
    # table had admitted before the build) and without it (the build's
    # fresh rows)
    for name, gate in (("plain", 0), ("gated", 2)):
        table = SsdSparseTable(str(tmp_path / name), _cfg(PORT, ssd_admission_threshold=gate))
        if gate:
            for seed in range(gate):
                table.push_sparse(held, _grad(table, held, seed))
        pc = tec.HbmEmbeddingCache(table, tec.CacheConfig(capacity=512, embedx_dim=4),
                                   device="cpu")
        pc.begin_pass(held)
        assert table.shrink() == len(held), name
        with pytest.raises(EnforceNotMet, match="missing from host table"):
            pc.end_pass()
        table.close()


# -- the background compactor and the IO budget -----------------------------------


def _drain(t, min_compactions=1, timeout=30.0):
    """Wait for the compactor to have compacted and drained its backlog."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = t.stats()
        if st["bg_compactions"] >= min_compactions and st["bg_backlog"] == 0:
            return st
        time.sleep(0.05)
    return t.stats()


def test_bg_compaction_is_digest_invariant_under_churn(tmp_path):
    """``ssd_bg_compact`` with a 64 MB/s budget: churn that leaves the
    content as it was (promote, spill), then ``compact_async``; the
    backlog drains and the digest stays, equal across the packages."""
    pair = _pair(tmp_path, "t", ssd_bg_compact=True, ssd_io_budget_mbps=64.0)
    keys, vals = _cold_rows(pair[0].full_dim, 2000, 4)
    # the background thread owns the shards: an inline step is refused
    assert pair[0]._engine.bg_step(0) == pair[1]._native.bg_step(0) == -1
    for t in pair:
        t.import_full(keys, vals)
        t.spill(0)
    dg = pair[0].digest()
    assert pair[1].digest() == dg
    for t in pair:
        for _ in range(4):
            t.pull_sparse(keys, create=False)
            t.spill(0)
        t.compact_async()
    for t in pair:
        st = _drain(t)
        assert st["bg_compactions"] > 0 and st["bg_backlog"] == 0, st
        assert t.digest() == dg
    _same(*pair, "drained", keys=keys)
    _close(*pair)


def test_io_budget_meters_background_bytes(tmp_path):
    """A starved budget (256 KB/s, a 64 KB bucket): the compactor waits for
    its bytes, and the wait shows in ``io_bg_wait_ms``; the content is the
    JAX table's."""
    pair = _pair(tmp_path, "t", shard_num=2)
    keys, vals = _cold_rows(pair[0].full_dim, 4000, 5)
    for t in pair:
        t.import_full(keys, vals)
        t.spill(0)
        for _ in range(3):
            t.pull_sparse(keys, create=False)
            t.spill(0)
    engines = (pair[0]._engine, pair[1]._native)
    for e in engines:
        e.io_budget(256 * 1024, 64 * 1024)
        e.bg_start(20)
    for t in pair:
        t.compact_async()
    for t in pair:
        st = _drain(t, min_compactions=2)
        assert st["bg_compactions"] >= 2 and st["bg_backlog"] == 0, st
        assert st["io_bg_bytes"] > 0 and st["io_bg_wait_ms"] > 0, st
    _same(*pair, "compacted", keys=keys)
    _close(*pair)


_CRASH_CHILD = textwrap.dedent("""
    import sys, time
    import numpy as np
    sys.path.insert(0, {repo!r})
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.faultpoints import arm_faultpoint
    from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig
    from paddle_tpu_torch.ps.table import SsdSparseTable, TableConfig

    assert not any(m == "jax" or m.startswith(("jax.", "paddle_tpu."))
                   or m == "paddle_tpu" for m in sys.modules), "the child imports JAX"
    t = SsdSparseTable(sys.argv[1], TableConfig(
        shard_num=2, storage="ssd", ssd_value_dtype="fp16", ssd_block_compress=True,
        accessor_config=AccessorConfig(sgd=SGDRuleConfig(initial_range=0.0), embedx_dim=4,
                                       embedx_threshold=0.0, delete_threshold=0.0)))
    rng = np.random.default_rng(0)
    keys = np.arange(1, 20001, dtype=np.uint64)
    vals = np.zeros((len(keys), t.full_dim), np.float32)
    vals[:, 3] = 1.0
    vals[:, 5] = rng.normal(size=len(keys)).astype(np.float32)
    t.import_full(keys, vals)
    t.spill(0)
    for _ in range(2):  # churn that leaves garbage worth compacting
        t.pull_sparse(keys, create=False)
        t.spill(0)
    t.flush()
    print("DIGEST", t.digest(), flush=True)
    # a starved budget: shard 0's copy passes on the full bucket, shard 1
    # waits in the bucket with its .compact file already created
    t._engine.io_budget(64 * 1024, 64 * 1024)
    t._engine.bg_start(20)
    t.compact_async()
    time.sleep(1.0)
    arm_faultpoint("ssd.compact", "kill-job")
    t.compact_async()  # the armed site SIGKILLs the process
    print("SURVIVED", flush=True)
    sys.exit(3)
""")


def test_sigkill_mid_compaction_keeps_durable_rows(tmp_path):
    """A child that imports only ``paddle_tpu_torch`` dies by SIGKILL at
    the ``ssd.compact`` faultpoint with the background sweep mid-copy:
    the port's table recovers digest-exact and ignores the orphan
    ``.compact`` file, compacts digest-exact, and the JAX table reads the
    recovered logs to the same digest."""
    path = str(tmp_path / "t")
    proc = subprocess.run([sys.executable, "-c", _CRASH_CHILD.format(repo=REPO), path],
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == -signal.SIGKILL, (proc.returncode, proc.stdout, proc.stderr)
    assert "SURVIVED" not in proc.stdout
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("DIGEST ")]
    assert lines, proc.stdout
    want = int(lines[0].split()[1])
    assert glob.glob(os.path.join(path, "*.compact")), "the kill landed after the sweep"
    back = SsdSparseTable(path, _cfg(PORT, **_comp(shard_num=2)))
    assert back.digest() == want
    back.compact()
    assert back.digest() == want
    back.close()
    j = JaxSsdTable(path, _cfg(JAX, **_comp(shard_num=2)))
    assert j.digest() == want
    j.close()


# -- observability and the client ---------------------------------------------------


def _series(snapshot, family, table="7"):
    fam = snapshot["metrics"][family]
    (s,) = [s for s in fam["series"] if s["labels"].get("table") == table]
    return s["value"]


def test_obs_probe_exports_the_cold_tier_series(tmp_path):
    """``obs_probe`` writes the stat vector as ``ssd_*`` families labelled
    ``table="7"``: counters by delta, gauges by level, equal to the JAX
    probe's for the salt-free fields; ``cold_tier_rules`` evaluates over
    them."""
    from paddle_tpu_torch.obs.slo import SloWatchdog
    from paddle_tpu_torch.obs.timeseries import MetricRing, Sampler

    pair = _pair(tmp_path, "t", table_id=7, ssd_admission_threshold=2)
    keys = np.arange(1, 101, dtype=np.uint64)
    g = _grad(pair[0], keys, 0)
    for t in pair:
        t.push_sparse(keys, g)
        t.push_sparse(keys, g)
        t.spill(0)
        t.obs_probe()
        t.push_sparse(keys, g)
        t.obs_probe()  # a second probe adds the deltas only
    snaps = port_registry.REGISTRY.snapshot(), jax_registry.REGISTRY.snapshot()
    st = pair[0].stats()
    for name in SsdSparseTable._OBS_COUNTERS + SsdSparseTable._OBS_GAUGES:
        fam = f"ssd_{name}"
        assert fam in snaps[0]["metrics"], fam
        if name in _TIMING or name == "io_serve_bytes":
            continue
        got, want = _series(snaps[0], fam), _series(snaps[1], fam)
        assert got == want, (fam, got, want)
        assert got == pytest.approx(st[name]), fam
    assert SsdSparseTable._OBS_COUNTERS == JaxSsdTable._OBS_COUNTERS
    assert SsdSparseTable._OBS_GAUGES == JaxSsdTable._OBS_GAUGES
    ring = MetricRing()
    sampler = Sampler(ring=ring).add_probe(pair[0].obs_probe)
    for i in range(4):
        sampler.tick(t=1000.0 + i)
    assert sampler.errors == 0
    dog = SloWatchdog(ring, cold_tier_rules())
    dog.evaluate(now=1003.0)
    assert {r.family for r in dog.rules} <= set(snaps[0]["metrics"])
    _close(*pair)


def test_local_client_table_stats_pass_the_full_vector(tmp_path):
    """``LocalPsClient.table_stats`` hands an SSD table's whole stat vector
    through (equal to the JAX client's on the salt-free fields), and {} for
    a RAM table."""
    stats = []
    for pkg, server_cls, client_cls in ((PORT, PsServerHandle, LocalPsClient),
                                        (JAX, JaxPsServerHandle, JaxLocalPsClient)):
        server = server_cls()
        cli = client_cls(server)
        server.create_sparse_table(0, _cfg(pkg, table_id=0,
                                           ssd_path=str(tmp_path / f"t{len(stats)}")))
        server.create_sparse_table(1, pkg["cfg"](table_id=1, accessor_config=pkg["acc"](
            sgd=pkg["sgd"](initial_range=0.0), embedx_dim=4, embedx_threshold=0.0)))
        cli.pull_sparse(0, np.arange(1, 51, dtype=np.uint64))
        st = cli.table_stats(0)
        assert st["hot_rows"] == 50 and "admit_checks" in st and "index_bytes" in st
        assert cli.table_stats(1) == {}
        stats.append({k: v for k, v in st.items() if k != "io_serve_bytes"})
        if pkg is PORT:
            server.close()
    assert stats[0] == stats[1]


# -- the config file -----------------------------------------------------------------

_KNOBS = {"ssd_value_dtype": "fp16", "ssd_block_compress": True, "ssd_admission_threshold": 5,
          "ssd_admission_sketch_kb": 32, "ssd_bg_compact": True, "ssd_io_budget_mbps": 128.0}


def test_config_file_knobs_reach_the_engine_in_jax_order(tmp_path, monkeypatch):
    """``load_ps_config`` of the five scale knobs (and fp16 values) gives
    the JAX package's ``TableConfig``, and an ``SsdSparseTable`` built from
    it makes the JAX table's engine calls, in the same order: block
    compression at open, admission, the IO budget in bytes a second, the
    background compactor last."""
    src = {"hyper_parameters": {"sparse_feature_dim": 9},
           "table_parameters": {"storage": "ssd", **_KNOBS}}
    tcfg, jcfg = load_ps_config(src).table, jax_load_ps_config(src).table
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    calls = {"port": [], "jax": []}

    def recording(base, log):
        class Engine(base):
            def __init__(self, *a, **kw):
                log.append(("open", kw.get("value_f16"), kw.get("block_compress")))
                super().__init__(*a, **kw)

            def admission_config(self, *a):
                log.append(("admission_config", *a))
                super().admission_config(*a)

            def io_budget(self, *a):
                log.append(("io_budget", *a))
                super().io_budget(*a)

            def bg_start(self, *a):
                log.append(("bg_start", *a))
                super().bg_start(*a)
        return Engine

    monkeypatch.setattr(port_table, "SsdTableEngine",
                        recording(port_native.SsdTableEngine, calls["port"]))
    monkeypatch.setattr(jax_native_mod, "SsdTableEngine",
                        recording(jax_native_mod.SsdTableEngine, calls["jax"]))
    t = port_table.make_sparse_table(dataclasses.replace(
        tcfg, storage="ssd", ssd_path=str(tmp_path / "port")))
    j = JaxSsdTable(str(tmp_path / "jax"), jcfg)
    want = [("open", True, True), ("admission_config", 5, 32),
            ("io_budget", 128 * 1024 * 1024), ("bg_start",)]
    assert calls["port"] == calls["jax"] == want
    assert t._engine.bg_step(0) == -1  # the background thread owns the shards
    keys = np.arange(1, 11, dtype=np.uint64)
    t.push_sparse(keys, _grad(t, keys, 0))
    assert t.size() == 0 and t.stats()["sketch_bytes"] == tcfg.shard_num * 32 * 1024
    _close(t, j)


# -- streaming save_file / load_file ------------------------------------------------


def _populated_pair(tmp_path, name):
    """Both packages' tables after the same pushes (embedx created past
    score 2), one hot and one cold half."""
    pair = _pair(tmp_path, name, acc={"embedx_threshold": 2.0})
    rng = np.random.default_rng(6)
    for _ in range(3):
        keys = np.unique(rng.integers(1, 4000, 300).astype(np.uint64))
        g = _grad(pair[0], keys, int(rng.integers(1 << 30)))
        g[:, 1] = rng.integers(1, 4, len(keys))
        g[:, 2] = rng.integers(0, 2, len(keys))
        for t in pair:
            t.push_sparse(keys, g)
    for t in pair:
        t.spill(t.size() // 2)
    _same(*pair, "populated")
    return pair


def _text_lines(path, fmt):
    opener = gzip.open if fmt == "gzip" else open
    with opener(path, "rt") as f:
        return sorted(f.read().splitlines())


@pytest.mark.parametrize("fmt", ["text", "gzip", "raw"])
def test_save_file_cross_loads_both_ways(tmp_path, fmt):
    """Each package's ``save_file`` loads into the other's table and into
    its own, to one digest (the source's, for "raw"); the text files hold
    the same lines; a text file fed to the raw loader raises, a raw file
    fed to the text loader loads nothing."""
    src = _populated_pair(tmp_path, "src")
    n = src[0].size()
    files = {side: str(tmp_path / f"{side}.{fmt}") for side in ("port", "jax")}
    for side, t in zip(("port", "jax"), src):
        assert t.save_file(files[side], fmt=fmt) == n
    if fmt != "raw":
        assert _text_lines(files["port"], fmt) == _text_lines(files["jax"], fmt)
    digests = set()
    for side, path in files.items():
        loaded = _pair(tmp_path, f"from_{side}")
        for t in loaded:
            assert t.load_file(path, fmt=fmt) == n
            assert t.stats()["cold_rows"] == n and t.stats()["hot_rows"] == 0
        _same(*loaded, f"{fmt} file of the {side} table")
        digests.add(loaded[0].digest())
        if fmt == "raw":
            assert loaded[0].digest() == src[0].digest()
            assert np.array_equal(*(t.snapshot_items(0)[1][np.argsort(t.snapshot_items(0)[0])]
                                    for t in loaded))
        if fmt != "raw":
            with pytest.raises(RuntimeError):
                loaded[0].load_file(path, fmt="raw")
            with pytest.raises(RuntimeError):
                loaded[1].load_file(path, fmt="raw")
        else:
            assert [t.load_file(path, fmt="gzip") for t in loaded] == [0, 0]
        _close(*loaded)
    assert len(digests) == 1
    _close(*src)


def test_streaming_load_survives_corruption(tmp_path):
    """A truncated raw file loads its whole records before the tear; junk
    lines in a gzip text file are skipped and every real row loads; a
    truncated gzip stream loads what decompressed cleanly. Both packages
    load each damaged file to the same count and digest."""
    src = _populated_pair(tmp_path, "src")
    n = src[0].size()
    raw, gz = str(tmp_path / "ck.bin"), str(tmp_path / "ck.gz")
    assert src[0].save_file(raw, fmt="raw") == n
    assert src[0].save_file(gz, fmt="gzip") == n
    rec = 8 + 4 * src[0].full_dim
    data = open(raw, "rb").read()
    with open(str(tmp_path / "torn.bin"), "wb") as f:
        f.write(data[:16 + rec * (n // 2) + rec // 3])  # header, half the rows, a torn one
    lines = gzip.open(gz, "rt").readlines()
    lines.insert(1, "not a row at all\n")
    lines.insert(5, "12 nan nan\n")  # a short head
    with gzip.open(str(tmp_path / "junk.gz"), "wt") as f:
        f.writelines(lines)
    blob = open(gz, "rb").read()
    with open(str(tmp_path / "cut.gz"), "wb") as f:
        f.write(blob[: len(blob) // 2])
    for name, fmt, check in (("torn.bin", "raw", lambda c: c == n // 2),
                             ("junk.gz", "gzip", lambda c: c == n),
                             ("cut.gz", "gzip", lambda c: 0 <= c < n)):
        pair = _pair(tmp_path, f"into_{name}")
        counts = [t.load_file(str(tmp_path / name), fmt=fmt) for t in pair]
        assert counts[0] == counts[1] and check(counts[0]), (name, counts)
        _same(*pair, name)
        _close(*pair)
    _close(*src)
