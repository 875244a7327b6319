"""paddle_tpu_torch's in-memory dataset against the JAX package's.

The same MultiSlot lines go through both ``InMemoryDataset``s (each
parses with its own copy of ``csrc/slot_parser.cc``); every batch must
agree exactly — values and per-slot lengths, float and uint64 slots,
padding/truncation to ``max_len`` — including ``start_batch`` re-entry,
``local_shuffle`` with the same seed, ``pass_feasigns`` and the parse
error count. Tolerance: exact (the data layer is integer and copy work).
"""

import numpy as np
import pytest

from paddle_tpu.data.dataset import InMemoryDataset as JaxDataset
from paddle_tpu.data.dataset import SlotDesc as JaxSlotDesc
from paddle_tpu_torch.data.dataset import InMemoryDataset, SlotDesc


def _lines(n=203, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ids = rng.integers(0, 1 << 40, 3)
        multi = rng.integers(0, 1000, rng.integers(0, 5))   # variable length
        dense = rng.normal(size=2)
        out.append(" ".join([f"1 {v}" for v in ids]
                            + [f"{len(multi)}" + "".join(f" {v}" for v in multi)]
                            + [f"1 {v:.5f}" for v in dense]
                            + [f"1 {int(dense[0] > 0)}"]))
        if i == 50:
            out.append("2 1")  # malformed: counted, dropped
    return out


def _schema(cls):
    return ([cls(f"s{i}", is_float=False, max_len=1) for i in range(3)]
            + [cls("multi", is_float=False, max_len=3)]
            + [cls(f"d{i}", is_float=True, max_len=1) for i in range(2)]
            + [cls("label", is_float=True, max_len=1)])


def _pair(seed=0):
    lines = _lines()
    j, t = JaxDataset(_schema(JaxSlotDesc), seed=seed), InMemoryDataset(_schema(SlotDesc), seed=seed)
    assert j.load_from_lines(lines) == t.load_from_lines(lines) == 203
    assert j.parse_errors == t.parse_errors == 1
    return j, t


def _assert_batches_equal(jb, tb):
    assert len(jb) == len(tb) > 0
    for a, b in zip(jb, tb):
        assert a.keys() == b.keys()
        for k in a:
            (av, al), (bv, bl) = a[k], b[k]
            assert av.dtype == bv.dtype and al.dtype == bl.dtype, k
            np.testing.assert_array_equal(av, bv, err_msg=k)
            np.testing.assert_array_equal(al, bl, err_msg=k)


@pytest.mark.parametrize("drop_last", [True, False])
def test_batches_equal(drop_last):
    j, t = _pair()
    _assert_batches_equal(list(j.batch_iter(32, drop_last=drop_last)),
                          list(t.batch_iter(32, drop_last=drop_last)))
    np.testing.assert_array_equal(j.pass_feasigns(), t.pass_feasigns())
    assert j.num_records == t.num_records


def test_start_batch_and_local_shuffle_equal():
    j, t = _pair(seed=11)
    j.local_shuffle()
    t.local_shuffle()
    _assert_batches_equal(list(j.batch_iter(40, start_batch=2)),
                          list(t.batch_iter(40, start_batch=2)))
    full = list(t.batch_iter(40))
    _assert_batches_equal(full[2:], list(t.batch_iter(40, start_batch=2)))
    j.local_shuffle()  # the generator advances identically
    t.local_shuffle()
    _assert_batches_equal(list(j.batch_iter(64)), list(t.batch_iter(64)))


def test_release_memory():
    _, t = _pair()
    t.release_memory()
    assert t.num_records == 0
    with pytest.raises(Exception, match="load_from_lines first"):
        list(t.batch_iter(8))
