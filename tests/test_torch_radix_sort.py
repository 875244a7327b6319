"""The stable row sort in front of B4 and the merges, and models of the
kernels' designs, on the CPU.

- ``_sort_rows`` on the CPU (the plain version, the oracle of the card's
  radix sort) equals numpy's ``argsort(kind="stable")``, in full mode and
  in bounded mode (rows outside [0, bound) mapped to the bound).
- A numpy model of the radix kernels' passes, at the kernel's tile size
  and digit width: per-tile counts, the scanned [digit x tile] offsets,
  the in-tile stable rank (warp by warp, 32 keys a round) and the next
  pass's counts by destination tile. It must give the stable argsort.
- Models of the segment walk: the end search past the halo (gallop, then
  32 probes a step) against ``searchsorted``, and the long-segment path
  (entries staged in chunks, one column per lane, each column summed in
  order) against ``index_add_``'s float32 sums, bitwise.

Tolerance: exact (integers) and bitwise (float32 sums in one order).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import hot_kernels as hk

ROOT = pathlib.Path(__file__).resolve().parents[1]
CU = ROOT / "paddle_tpu_torch" / "ops" / "csrc" / "hot_kernels.cu"


def _cu_const(name):
    """A ``constexpr int`` of the kernel source: the model runs at the
    kernel's own tile and digit."""
    return int(re.search(rf"constexpr int {name} = (\d+);", CU.read_text()).group(1))


SORT_TILE = _cu_const("kSortTile")
RADIX_BITS = _cu_const("kRadixBits")
BINS = 1 << RADIX_BITS
WARPS = _cu_const("kSortThreads") // 32  # warp w ranks keys [w*per, (w+1)*per) of a tile


def _rows(kind, n, rng):
    """Rows for the contract tests: a mix of in-range rows, negatives and
    the sentinel 1000; a 5,000-entry heavy row; all equal."""
    if kind == "mixed":
        r = rng.integers(-4, 1001, n)
        r[rng.random(n) < 0.1] = 1000
        return r
    if kind == "heavy":
        r = rng.integers(0, 1000, n + 5000)
        r[rng.permutation(n + 5000)[:5000]] = 7
        return r
    return np.full(n, 3)


def _mapped(r, bound):
    return np.where((r >= 0) & (r < bound), r, bound)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("bound", [None, 1000, 512])
@pytest.mark.parametrize("kind,n", [("mixed", 0), ("mixed", 1), ("mixed", 255), ("mixed", 4097),
                                    ("mixed", 10001), ("heavy", 3000), ("equal", 4097)])
def test_plain_sort_is_the_stable_argsort(kind, n, bound, dtype):
    r = _rows(kind, n, np.random.default_rng(n)).astype(dtype)
    keys = r if bound is None else _mapped(r, bound)
    order = np.argsort(keys, kind="stable")
    for index_dtype in (torch.int32, torch.int64):
        srows, perm = hk._sort_rows(torch.from_numpy(r), bound, index_dtype)
        assert srows.dtype == perm.dtype == index_dtype
        np.testing.assert_array_equal(perm.numpy(), order)
        np.testing.assert_array_equal(srows.numpy(), keys[order])


def test_sort_segments_bounded_on_canonical_rows():
    """The sharded dedup's rows lie in [0, sentinel]: bounded mode is the
    plain stable sort of the rows themselves."""
    rng = np.random.default_rng(4)
    r = rng.integers(0, 65, 3000)
    srows, perm, seg = hk.sort_segments(torch.from_numpy(r), 64)
    order = np.argsort(r, kind="stable")
    np.testing.assert_array_equal(perm.numpy(), order)
    np.testing.assert_array_equal(srows.numpy(), r[order])
    _, inv = np.unique(r, return_inverse=True)
    np.testing.assert_array_equal(seg.numpy(), inv.reshape(-1)[order])


# -- a numpy model of the radix kernels --------------------------------------


def _keys(r, bound):
    """The kernels' uint32 keys: full mode flips the int32 sign bit."""
    if bound is None:
        return (r.astype(np.int32).view(np.uint32) ^ np.uint32(0x80000000)).astype(np.int64)
    return _mapped(r, bound).astype(np.int64)


def _tile_ranks(digits):
    """In-tile stable rank as the scatter kernel takes it: each warp ranks
    its 128 consecutive keys 32 a round (earlier rounds and lower lanes
    first), then digit start + the warp's exclusive prefix + that rank."""
    m = len(digits)
    per = SORT_TILE // WARPS
    warp_count = np.zeros((WARPS, BINS), np.int64)
    in_warp = np.zeros(m, np.int64)
    for w in range(WARPS):
        for j0 in range(w * per, min(m, (w + 1) * per), 32):
            rnd = digits[j0:min(m, j0 + 32, (w + 1) * per)]
            for lane, d in enumerate(rnd):  # peers in lower lanes, then the round's leader adds
                in_warp[j0 + lane] = warp_count[w, d] + np.sum(rnd[:lane] == d)
            np.add.at(warp_count[w], rnd, 1)
    warp_prefix = np.cumsum(warp_count, axis=0) - warp_count
    tile_count = warp_count.sum(0)
    start = np.cumsum(tile_count) - tile_count
    warp_of = np.arange(m) // per
    return start[digits] + warp_prefix[warp_of, digits] + in_warp, start


def _radix_model(keys, passes):
    """(sorted keys, permutation) through the passes of the kernels."""
    n = len(keys)
    tiles = -(-n // SORT_TILE)
    vals = np.arange(n)
    # the count kernel: pass 0's [tile x digit] matrix
    counts = np.zeros((tiles, BINS), np.int64)
    for t in range(tiles):
        counts[t] = np.bincount(keys[t * SORT_TILE:(t + 1) * SORT_TILE] & (BINS - 1),
                                minlength=BINS)
    for p in range(passes):
        shift = p * RADIX_BITS
        total = counts.sum(0)
        digit_base = np.cumsum(total) - total
        before = np.cumsum(counts, axis=0) - counts           # earlier tiles, per digit
        out_k, out_v = np.empty_like(keys), np.empty_like(vals)
        nxt = np.zeros((tiles, BINS), np.int64)
        for t in range(tiles):
            sl = slice(t * SORT_TILE, min(n, (t + 1) * SORT_TILE))
            k, v = keys[sl], vals[sl]
            d = (k >> shift) & (BINS - 1)
            rank, start = _tile_ranks(d)
            dest = digit_base[d] + before[t, d] + rank - start[d]
            out_k[dest], out_v[dest] = k, v
            if p + 1 < passes:  # next pass's counts, by destination tile
                np.add.at(nxt, (dest // SORT_TILE, (k >> (shift + RADIX_BITS)) & (BINS - 1)), 1)
        keys, vals, counts = out_k, out_v, nxt
        if p + 1 < passes:  # the atomics must give the recount of the tile
            for t in range(tiles):
                sl = keys[t * SORT_TILE:(t + 1) * SORT_TILE]
                np.testing.assert_array_equal(
                    counts[t], np.bincount((sl >> (shift + RADIX_BITS)) & (BINS - 1),
                                           minlength=BINS))
    return keys, vals


@pytest.mark.parametrize("kind,n,bound", [("mixed", 1, None), ("mixed", 255, 1000),
                                          ("mixed", 4097, None), ("mixed", 10001, 1000),
                                          ("heavy", 4000, 1000), ("equal", 4097, None)])
def test_radix_model_is_the_stable_argsort(kind, n, bound):
    r = _rows(kind, n, np.random.default_rng(7 + n)).astype(np.int32)
    keys = _keys(r, bound)
    passes = 32 // RADIX_BITS if bound is None else max(1, -(-bound.bit_length() // RADIX_BITS))
    got_k, got_v = _radix_model(keys, passes)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got_v, order)
    np.testing.assert_array_equal(got_k, keys[order])
    # the last pass writes the rows back: full mode unflips the sign bit
    rows = got_k if bound is not None else \
        (got_k.astype(np.uint32) ^ np.uint32(0x80000000)).view(np.int32)
    want, _ = hk._sort_rows(torch.from_numpy(r), bound)
    np.testing.assert_array_equal(rows, want.numpy())


# -- models of the segment walk ------------------------------------------------

def _find_end(skeys, lo, hi, r):
    """find_end in hot_kernels.cu: positions < lo hold r; a gallop, then
    32 evenly spaced probes a step. Returns (end, steps)."""
    gallop, steps = True, 0
    while lo < hi:
        step = (hi - lo + 31) // 32
        p = lo + (1 << np.arange(32)) - 1 if gallop else lo + np.arange(32) * step
        probed = p < hi
        inside = probed & (skeys[np.minimum(p, hi - 1)] == r)
        c, probes = int(inside.sum()), int(probed.sum())
        assert inside[:c].all()  # the probes inside the segment are a prefix
        if c > 0:
            lo = int(p[c - 1]) + 1
        if c < probes:
            hi = int(p[c])
        gallop, steps = False, steps + 1
    return lo, steps


@pytest.mark.parametrize("length", [1, 33, 288, 2351, 70000])
def test_find_end_model_matches_searchsorted(length):
    rng = np.random.default_rng(length)
    skeys = np.sort(np.concatenate([rng.integers(0, 50, 3000), np.full(length, 50),
                                    rng.integers(51, 100, 3000)]))
    s = int(np.searchsorted(skeys, 50))
    lo = s + min(length, 1)
    end, steps = _find_end(skeys, lo, len(skeys), 50)
    assert end == s + length
    assert steps <= 6


def _staged_sums(entries, cols, per):
    """The warp/block path: ``per`` entries staged at a time, each lane
    owning one column and adding the chunk's values in order from 0.0f."""
    acc = np.zeros(cols.shape[1], np.float32)
    for j0 in range(0, len(entries), per):
        stage = cols[entries[j0:j0 + per]]          # [cnt, columns]
        for q in range(stage.shape[0]):
            acc = (acc + stage[q]).astype(np.float32)  # one f32 add per lane
    return acc


@pytest.mark.parametrize("per,width", [(32, 9), (256, 9), (23, 129), (7, 3)])
def test_long_segment_model_matches_index_add(per, width):
    """show, click and the grads of a 2,351-entry segment (in occurrence
    order) staged through chunks of ``per``: bitwise ``index_add_``."""
    rng = np.random.default_rng(per + width)
    n = 5000
    rows = rng.integers(0, 400, n)
    rows[rng.permutation(n)[:2351]] = 7
    cols = np.concatenate([rng.integers(1, 3, (n, 1)), (rng.random((n, 1)) < 0.3),
                           rng.normal(size=(n, width)) * 10.0 ** rng.integers(-3, 4, (n, 1))],
                          axis=1).astype(np.float32)
    entries = np.nonzero(rows == 7)[0]
    want = torch.zeros((1, cols.shape[1])).index_add_(
        0, torch.zeros(len(entries), dtype=torch.int64), torch.from_numpy(cols[entries]))
    got = _staged_sums(entries, cols, per)
    np.testing.assert_array_equal(got.view(np.int32), want[0].numpy().view(np.int32))
    # and the port's plain merge gives the same sums for that row
    t = [torch.from_numpy(a) for a in (rows, cols[:, 2:], cols[:, 0], cols[:, 1])]
    uniq, ss, cs, g = hk.merge_sparse_grads_plain(*t, 400)
    o = int((uniq == 7).nonzero()[0, 0])
    np.testing.assert_array_equal(np.concatenate([[ss[o], cs[o]], g[o].numpy()]).view(np.int32),
                                  got.view(np.int32))
