"""paddle_tpu_torch's file-fed dataset against the JAX package's.

The same MultiSlot part files (made from a numpy seed, with malformed
lines, variable-length and float slots) go through both packages:

- ``NativeDataFeed`` (each package's copy of ``csrc/data_feed.cc``) with
  one reader: the same chunks in file order, the same bad-line and
  unreadable-file counts; an empty file list yields nothing;
- ``load_into_memory`` with 1 thread: batches bitwise equal to JAX's, also
  after ``local_shuffle``; with 4 threads the chunk order follows the
  threads in both packages, so the records are compared as multisets;
- ``set_pipe_command``; ``DataGenerator``'s strings;
- SlotRecord files written by one package load in the other, both ways;
  a file of the wrong magic, a truncated file, a missing slot and a slot of
  the other type are refused by both;
- ``QueueDataset`` batches, including ``start_batch``;
- ``global_shuffle`` over 3 workers through an in-process exchange (and
  through a ``util``): every worker's store bitwise equal to JAX's worker's,
  with an empty partition and an empty worker, records conserved.

Tolerance: exact throughout (the data layer is integer and copy work).
"""

import io
import threading

import numpy as np
import pytest

from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

from paddle_tpu.data import dataset as jds
from paddle_tpu.ps import native as jnative
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.data import dataset as tds
from paddle_tpu_torch.ps import native as tnative

pytestmark = pytest.mark.usefixtures("jax_native")

FILES, LINES_PER_FILE = 5, 97


def _line(rng):
    ids = rng.integers(0, 1 << 40, 3)
    multi = rng.integers(0, 1000, rng.integers(0, 5))   # variable length
    dense = rng.normal(size=2)
    return " ".join([f"1 {v}" for v in ids]
                    + [f"{len(multi)}" + "".join(f" {v}" for v in multi)]
                    + [f"1 {v:.5f}" for v in dense] + [f"1 {int(dense[0] > 0)}"])


@pytest.fixture(scope="module")
def part_files(tmp_path_factory):
    """``FILES`` part files; file 2 has two malformed lines, file 3 is empty."""
    d = tmp_path_factory.mktemp("parts")
    rng = np.random.default_rng(0)
    paths = []
    for f in range(FILES):
        lines = [] if f == 3 else [_line(rng) for _ in range(LINES_PER_FILE)]
        if f == 2:
            lines[10:10] = ["2 1", "1 5 x"]  # counted, dropped
        p = d / f"part-{f:05d}"
        p.write_text("".join(line + "\n" for line in lines))
        paths.append(str(p))
    return paths


def _schema(mod):
    return ([mod.SlotDesc(f"s{i}", is_float=False, max_len=1) for i in range(3)]
            + [mod.SlotDesc("multi", is_float=False, max_len=3)]
            + [mod.SlotDesc(f"d{i}", is_float=True, max_len=1) for i in range(2)]
            + [mod.SlotDesc("label", is_float=True, max_len=1)])


def _feed_slots():
    return [(s.name, s.is_float, s.is_used) for s in _schema(tds)]


def _assert_batches_equal(a_batches, b_batches):
    a_batches, b_batches = list(a_batches), list(b_batches)
    assert len(a_batches) == len(b_batches) > 0
    for a, b in zip(a_batches, b_batches):
        assert a.keys() == b.keys()
        for k in a:
            (av, al), (bv, bl) = a[k], b[k]
            assert av.dtype == bv.dtype and al.dtype == bl.dtype, k
            np.testing.assert_array_equal(av, bv, err_msg=k)
            np.testing.assert_array_equal(al, bl, err_msg=k)


def _all(ds):
    return list(ds.batch_iter(1 << 20, drop_last=False))


def _records(ds):
    """The records as a sorted list of byte rows (an order-free view)."""
    (batch,) = _all(ds)
    cols = []
    for name in sorted(batch):
        v, l = batch[name]
        cols += [np.ascontiguousarray(v).view(np.uint8).reshape(len(l), -1),
                 l.reshape(-1, 1).view(np.uint8)]
    rows = np.concatenate(cols, axis=1)
    return sorted(bytes(r) for r in rows)


def _loaded(mod, files, threads, seed=0):
    ds = mod.InMemoryDataset(_schema(mod), seed=seed)
    ds.set_filelist(files)
    n = ds.load_into_memory(num_threads=threads)
    return ds, n


# -- the native feed ------------------------------------------------------------

def test_native_feed_chunks_and_errors_match_jax(part_files, tmp_path):
    missing = str(tmp_path / "nope")
    files = part_files + [missing]
    got = tnative.NativeDataFeed(_feed_slots(), files, num_threads=1)
    want = jnative.NativeDataFeed(_feed_slots(), files, num_threads=1)
    try:
        tchunks, jchunks = list(got), list(want)
        assert len(tchunks) == len(jchunks) == FILES - 1  # the empty file yields no chunk
        for t, j in zip(tchunks, jchunks):
            assert t.keys() == j.keys()
            for k in t:
                np.testing.assert_array_equal(t[k][0], j[k][0], err_msg=k)
                np.testing.assert_array_equal(t[k][1], j[k][1], err_msg=k)
        assert got.errors == want.errors == 3  # two bad lines, one unreadable file
    finally:
        got.close()
        want.close()
    empty = tnative.NativeDataFeed(_feed_slots(), [], num_threads=4)
    assert list(empty) == [] and empty.errors == 0
    empty.close()


# -- load_into_memory -----------------------------------------------------------

def test_load_into_memory_one_thread_is_bitwise_jax(part_files):
    t, tn = _loaded(tds, part_files, 1, seed=5)
    j, jn = _loaded(jds, part_files, 1, seed=5)
    assert tn == jn == (FILES - 1) * LINES_PER_FILE
    assert t.parse_errors == j.parse_errors == 2
    _assert_batches_equal(t.batch_iter(64, drop_last=False), j.batch_iter(64, drop_last=False))
    np.testing.assert_array_equal(t.pass_feasigns(), j.pass_feasigns())
    t.local_shuffle()
    j.local_shuffle()
    _assert_batches_equal(t.batch_iter(50), j.batch_iter(50))
    _assert_batches_equal(t.batch_iter(50, start_batch=3), j.batch_iter(50, start_batch=3))


def test_load_into_memory_four_threads_same_records_as_jax(part_files):
    t, tn = _loaded(tds, part_files, 4)
    j, jn = _loaded(jds, part_files, 4)
    one, _ = _loaded(tds, part_files, 1)
    assert tn == jn == one.num_records
    assert t.parse_errors == j.parse_errors == 2
    assert _records(t) == _records(j) == _records(one)


def test_load_into_memory_missing_file_raises_before_reading(part_files, tmp_path):
    ds = tds.InMemoryDataset(_schema(tds))
    ds.set_filelist(part_files + [str(tmp_path / "absent")])
    with pytest.raises(FileNotFoundError, match="absent"):
        ds.load_into_memory()


def test_pipe_command_matches_jax(part_files):
    # the command drops every line whose first id ends in 7, in both packages
    cmd = "awk '$2 !~ /7$/'"
    t, j = tds.InMemoryDataset(_schema(tds)), jds.InMemoryDataset(_schema(jds))
    for ds in (t, j):
        ds.set_filelist(part_files)
        ds.set_pipe_command(cmd)
    assert t.load_into_memory(num_threads=2) == j.load_into_memory(num_threads=2)
    assert 0 < t.num_records < (FILES - 1) * LINES_PER_FILE
    assert t.parse_errors == j.parse_errors
    _assert_batches_equal(_all(t), _all(j))
    bad = tds.InMemoryDataset(_schema(tds))
    bad.set_filelist(part_files[:1])
    bad.set_pipe_command("exit 3")
    with pytest.raises(RuntimeError, match="rc 3"):
        bad.load_into_memory()


def test_data_generator_strings_match_jax():
    def make(base):
        class Gen(base):
            def generate_sample(self, line):
                def it():
                    a, b = line.split(",")
                    yield [("click", [int(a) % 2]), ("ids", [int(a), int(b)]),
                           ("dense", [float(b) / 4])]
                return it
        return Gen()

    src = [f"{i},{3 * i + 1}" for i in range(6)]
    t, j = make(tds.DataGenerator), make(jds.DataGenerator)
    assert t.run_from_memory(src) == j.run_from_memory(src)
    assert t.run_from_memory(src)[1] == "1 1 2 1 4 1 1.0"
    tout, jout = io.StringIO(), io.StringIO()
    t.run_from_stdin(io.StringIO("\n".join(src) + "\n"), tout)
    j.run_from_stdin(io.StringIO("\n".join(src) + "\n"), jout)
    assert tout.getvalue() == jout.getvalue() != ""


# -- SlotRecord files -------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(tds, jds), (jds, tds)], ids=["port_to_jax",
                                                                        "jax_to_port"])
@pytest.mark.parametrize("mmap", [True, False])
def test_slot_record_files_cross_load(part_files, tmp_path, writer, reader, mmap):
    src, n = _loaded(writer, part_files, 1)
    src.local_shuffle()
    path = str(tmp_path / "pass.ptsr")
    assert src.save_slot_record(path) == n
    dst = reader.InMemoryDataset(_schema(reader))
    assert dst.load_slot_record(path, mmap=mmap) == n
    _assert_batches_equal(dst.batch_iter(40, drop_last=False), src.batch_iter(40, drop_last=False))
    np.testing.assert_array_equal(dst.pass_feasigns(), src.pass_feasigns())


def test_slot_record_rejections_match_jax(part_files, tmp_path):
    src, _ = _loaded(tds, part_files, 1)
    good = tmp_path / "good.ptsr"
    src.save_slot_record(str(good))
    data = good.read_bytes()
    (tmp_path / "magic.ptsr").write_bytes(b"XXXX0001" + data[8:])
    (tmp_path / "short.ptsr").write_bytes(data[:-100])
    for name in ("magic", "short"):
        path = str(tmp_path / f"{name}.ptsr")
        with pytest.raises(EnforceNotMet):
            tds.InMemoryDataset(_schema(tds)).load_slot_record(path)
        with pytest.raises(Exception):
            jds.InMemoryDataset(_schema(jds)).load_slot_record(path)
    extra = _schema(tds) + [tds.SlotDesc("absent")]
    with pytest.raises(EnforceNotMet, match="missing"):
        tds.InMemoryDataset(extra).load_slot_record(str(good))
    retyped = [tds.SlotDesc(s.name, is_float=not s.is_float, max_len=s.max_len)
               if s.name == "d0" else s for s in _schema(tds)]
    with pytest.raises(EnforceNotMet, match="type mismatch"):
        tds.InMemoryDataset(retyped).load_slot_record(str(good))


# -- QueueDataset -------------------------------------------------------------------

@pytest.mark.parametrize("batch,start", [(32, 0), (50, 0), (50, 3), (128, 1)])
def test_queue_dataset_matches_jax(part_files, batch, start):
    t, j = tds.QueueDataset(_schema(tds), chunk_lines=16), jds.QueueDataset(_schema(jds),
                                                                           chunk_lines=16)
    t.set_filelist(part_files)
    j.set_filelist(part_files)
    tb, jb = list(t.batch_iter(batch, start_batch=start)), list(j.batch_iter(batch,
                                                                             start_batch=start))
    assert len(tb) == (FILES - 1) * LINES_PER_FILE // batch - start
    _assert_batches_equal(tb, jb)
    assert t.parse_errors == j.parse_errors
    assert t.parse_errors == (2 if start * batch <= 2 * LINES_PER_FILE + 10 else 0)


# -- global shuffle -------------------------------------------------------------------

class _Exchange:
    """An in-process all-to-all among ``n`` threads: ``fn(rank)`` is that
    worker's ``exchange(blobs) -> blobs``."""

    def __init__(self, n):
        self.n = n
        self.box = [[None] * n for _ in range(n)]
        self.bar = threading.Barrier(n, timeout=60)

    def fn(self, rank):
        def exchange(blobs):
            for dst, blob in enumerate(blobs):
                self.box[rank][dst] = blob
            self.bar.wait()
            out = [self.box[src][rank] for src in range(self.n)]
            self.bar.wait()
            return out
        return exchange


class _Util:
    """The ``fleet.util`` surface ``global_shuffle`` reads."""

    def __init__(self, rank, world, exchange):
        self.rank, self.world_size, self.all_to_all_bytes = rank, world, exchange


def _shuffled(mod, shards, via_util):
    workers = []
    for rank, files in enumerate(shards):
        ds = mod.InMemoryDataset(_schema(mod), seed=10 + rank)
        ds.set_filelist(files)
        ds.load_into_memory(num_threads=1)
        workers.append(ds)
    ex = _Exchange(len(workers))
    errors = []

    def run(rank):
        try:
            if via_util:
                workers[rank].global_shuffle(util=_Util(rank, len(workers), ex.fn(rank)))
            else:
                workers[rank].global_shuffle(ex.fn(rank), worker_id=rank,
                                             worker_num=len(workers))
        except BaseException as e:  # noqa: BLE001 — re-raised by the test
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(len(workers))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    assert not errors, errors
    return workers


@pytest.mark.parametrize("shards", [
    [[0, 1], [2], [4]],       # file 2 holds the bad lines
    [[0, 4], [1, 2], [3]],    # worker 2 holds only the empty file: no records
], ids=["three_loaded", "one_empty_worker"])
@pytest.mark.parametrize("via_util", [False, True], ids=["exchange", "util"])
def test_global_shuffle_matches_jax(part_files, shards, via_util):
    names = [[part_files[i] for i in s] for s in shards]
    t = _shuffled(tds, names, via_util)
    j = _shuffled(jds, names, via_util)
    before = [_loaded(tds, s, 1)[0] for s in names]
    for rank, (a, b) in enumerate(zip(t, j)):
        assert a.num_records == b.num_records, rank
        if a.num_records:
            _assert_batches_equal(_all(a), _all(b))
    assert sum(w.num_records for w in t) == sum(w.num_records for w in before)
    assert sorted(r for w in t if w.num_records for r in _records(w)) == \
        sorted(r for w in before if w.num_records for r in _records(w))


def test_global_shuffle_one_worker_is_the_local_shuffle(part_files):
    a, _ = _loaded(tds, part_files, 1, seed=3)
    b, _ = _loaded(tds, part_files, 1, seed=3)
    a.global_shuffle()
    b.local_shuffle()
    _assert_batches_equal(_all(a), _all(b))
    with pytest.raises(EnforceNotMet, match="contradict"):
        a.global_shuffle(worker_id=1, worker_num=2, util=_Util(0, 2, None))


def test_record_blob_rejects_a_malformed_transport_result(part_files):
    ds, _ = _loaded(tds, part_files, 1)
    st = ds._store
    blob = st.extract_bytes(np.arange(5))
    n = ds.num_records
    assert st.ingest_bytes(blob) == 5 and ds.num_records == n + 5
    for bad in (blob[:3], blob[:-1], blob + b"\0"):
        with pytest.raises(EnforceNotMet):
            st.ingest_bytes(bad)
    assert ds.num_records == n + 5
