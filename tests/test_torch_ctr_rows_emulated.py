"""``ctr_sparse_rows.cu`` run on the CPU: B1 in both of its forms — in place
by index (``ctr_sparse_rows_at``) and rows in, rows out
(``ctr_sparse_rows``: the same kernel on copies of the rows) — from the
kernel source itself, bitwise against their plain versions.

The source is compiled with ``g++`` against the SIMT emulator of
``test_torch_hot_kernels_emulated.py`` (one block at a time, each thread a
fiber, ``__syncthreads`` a rendezvous), with plain-memory versions of the
copy functions of ``async_copy.cuh`` (below): a bulk copy or a ``cp.async``
copies at once and aborts on a misaligned address or size, and an mbarrier
wait aborts unless its one thread has arrived and every expected byte has
landed. It checks the tiles, offsets, the pieces chosen for each
column's address, tail handling and sentinel skips of the source; it says nothing about speed or about what
only nvcc or the card do (``tests/test_torch_ctr_rows_cuda.py`` and
``chip_smoke.py`` run on the card). Skips without ``g++``.
"""

import ctypes
import importlib.util
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import sparse_optimizer as so
from test_torch_hot_kernels_emulated import CUDA_RUNTIME_H, EMU_CC, emulated_source

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = pathlib.Path(so.__file__).resolve().parent / "csrc"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
RULE_PAIRS, HYPER = CS.RULE_PAIRS, CS.HYPER
TILE = 128  # kTile of the source: rows a block

# What the port's kernels use beyond the hot-tier emulator's header.
RUNTIME_EXTRA = r'''
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline float2 make_float2(float x, float y) { return float2{x, y}; }
inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class T> cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) {
  return cudaSuccess;
}
'''

ASYNC_COPY_EMU = r'''// async_copy.cuh for the SIMT emulator: every copy at once, in plain
// memory, with the card's alignment rules checked.
#pragma once
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
namespace async_copy {
inline void fail(const char* what) { fprintf(stderr, "emu async_copy: %s\n", what); abort(); }
inline void aligned(const void* p, uintptr_t a, const char* what) {
  if (reinterpret_cast<uintptr_t>(p) % a) fail(what);
}
inline unsigned char* dynamic_smem() {
  alignas(16) static unsigned char buf[256 * 1024];
  return buf;
}
// an mbarrier: [0] bytes still expected, [1] whether its one thread arrived
inline int32_t* mb(uint64_t* bar) { return reinterpret_cast<int32_t*>(bar); }
inline void mbar_init(uint64_t* bar, unsigned count) {
  if (count != 1) fail("an mbarrier of more than one thread");
  mb(bar)[0] = 0;
  mb(bar)[1] = 0;
}
inline void mbar_arrive_expect(uint64_t* bar, unsigned bytes) {
  if (mb(bar)[1]) fail("a second arrival on a one-thread mbarrier");
  mb(bar)[1] = 1;
  mb(bar)[0] += static_cast<int32_t>(bytes);
}
inline void mbar_wait(uint64_t* bar, unsigned phase) {
  if (phase != 0) fail("a wait on a later phase");
  if (!mb(bar)[1] || mb(bar)[0] != 0) fail("a wait before every expected byte landed");
}
inline void bulk_check(const void* dst, const void* src, unsigned bytes) {
  aligned(dst, 16, "a bulk copy to a misaligned address");
  aligned(src, 16, "a bulk copy from a misaligned address");
  if (bytes == 0 || bytes % 16) fail("a bulk copy of a size that is not a multiple of 16");
}
inline void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  bulk_check(dst, src, bytes);
  std::memcpy(dst, src, bytes);
  mb(bar)[0] -= static_cast<int32_t>(bytes);
}
template <int B> inline void copy_async(void* dst, const void* src) {
  static_assert(B == 4 || B == 8 || B == 16, "cp.async copies 4, 8 or 16 bytes");
  aligned(dst, B, "a cp.async to a misaligned address");
  aligned(src, B, "a cp.async from a misaligned address");
  std::memcpy(dst, src, B);
}
inline void copy_async_wait() {}
}  // namespace async_copy
'''


def build_emulated(d, cu_text):
    """Compile ``cu_text`` (a version of ``ctr_sparse_rows.cu``) with the
    emulator in directory ``d``; returns the library bound as the wrapper
    binds the card's."""
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME_H + RUNTIME_EXTRA)
    (d / "emu.cc").write_text(EMU_CC)
    (d / "ctr_rule.cuh").write_text((CSRC / "ctr_rule.cuh").read_text())
    (d / "async_copy.cuh").write_text(ASYNC_COPY_EMU)
    (d / "rows.cc").write_text(emulated_source(cu_text))
    so_path = d / "libctr_rows_emu.so"
    subprocess.run([shutil.which("g++"), "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-Wno-unknown-pragmas", f"-I{d}", "-o", str(so_path),
                    str(d / "rows.cc"), str(d / "emu.cc")], check=True, capture_output=True)
    return so.bind_kernel(ctypes.CDLL(str(so_path)))


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernels")
    return build_emulated(tmp_path_factory.mktemp("ctr_rows_emu"),
                          (CSRC / "ctr_sparse_rows.cu").read_text())


@pytest.fixture(autouse=True)
def no_stream(monkeypatch):
    monkeypatch.setattr(so, "_stream", lambda t: None)  # CPU pointers, no stream


def rule_kw(embed_rule, embedx_rule, cag):
    return dict(embed_rule=embed_rule, embedx_rule=embedx_rule, create_applies_grad=cag,
                **HYPER)


def launch_rows(lib, cols, deltas, kw):
    """The out-of-place form on CPU tensors through the wrapper's launch."""
    return so._launch_rows(lib, cols, deltas, dim=cols[4].shape[1], es=cols[3].shape[1],
                           xs=cols[5].shape[1], **kw)


def launch_at(lib, state, uniq, ds, dc, g, C, kw):
    """The in-place form on CPU tensors through the wrapper's launch."""
    dim = state[4].shape[1]
    so._launch_at(lib, state, uniq, ds, dc, g, capacity=C, dim=dim, es=state[3].shape[1],
                  xs=state[5].shape[1], **kw)


def bitwise(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("cag", [True, False])
@pytest.mark.parametrize("pair", RULE_PAIRS, ids=lambda p: "/".join(p))
@pytest.mark.parametrize("n", [3 * TILE + 37, 5])
@pytest.mark.parametrize("dim", [8, 13])
def test_emulated_rows_match_plain(emu_lib, dim, n, pair, cag):
    """Rows in, rows out (the in-place kernel on copies of the rows, entries
    0 .. n-1): whole tiles by bulk copies and the short tile by plain loads
    (n = 3 tiles + 37; n = 5, below one tile), the fixed-width instance
    (dim 8) and the run-time one (dim 13), bitwise against
    ``fused_row_update``; rows on both sides of the creation threshold;
    the inputs keep their bits."""
    rng = np.random.default_rng(dim * 100 + n + RULE_PAIRS.index(pair) * 2 + cag)
    cols, deltas = CS.rows_inputs(rng, n, dim, *pair, "cpu")
    kw = rule_kw(*pair, cag)
    want = so.ctr_sparse_rows(cols, *deltas, **kw)  # CPU: the plain version
    before = so.ctr_sparse_rows.launches
    kept = tuple(c.clone() for c in cols)
    got = launch_rows(emu_lib, cols, deltas, kw)
    assert so.ctr_sparse_rows.launches == before + 1
    for name, g, w in zip(CS.COLUMNS, got, want):
        assert bitwise(g, w), name
    assert CS.bitwise_cols(cols, kept)
    if n > TILE:
        created = (want[6] > 0) & (cols[6] == 0)
        assert created.any() and ((cols[6] == 0) & ~created).any()


def at_inputs(rng, C, n, dim, pair, uniq_dtype):
    """``chip_smoke.at_inputs`` on the CPU: distinct rows in random order,
    padding (C) and negative rows among them, nonzero deltas."""
    return CS.at_inputs(rng, C, n, dim, *pair, "cpu", uniq_dtype)


@pytest.mark.parametrize("cag", [True, False])
@pytest.mark.parametrize("pair", RULE_PAIRS, ids=lambda p: "/".join(p))
@pytest.mark.parametrize("dim", [8, 13])
def test_emulated_rows_at_match_plain(emu_lib, dim, pair, cag):
    """In place by index: whole tiles of entries by bulk copies and the
    short tile by plain loads (n = 3 tiles + 37), each row's pieces staged
    by cp.async, padding (C) and negative rows skipped, int32 and int64
    rows; the cache bitwise equal to ``ctr_sparse_rows_at_plain``'s."""
    i = RULE_PAIRS.index(pair) * 2 + cag
    rng = np.random.default_rng(1000 + dim * 100 + i)
    C, n = 700, 3 * TILE + 37
    state, uniq, ds, dc, g = at_inputs(rng, C, n, dim, pair,
                                       (torch.int32, torch.int64)[i % 2])
    kw = rule_kw(*pair, cag)
    want = so.ctr_sparse_rows_at(tuple(c.clone() for c in state), uniq, ds, dc, g,
                                 capacity=C, **kw)  # CPU: the plain version
    got = tuple(c.clone() for c in state)
    before = so.ctr_sparse_rows.launches
    launch_at(emu_lib, got, uniq, ds, dc, g, C, kw)
    assert so.ctr_sparse_rows.launches == before + 1
    for name, a, b in zip(CS.COLUMNS, got, want):
        assert bitwise(a, b), name
    created = (want[6] > 0) & (state[6] == 0)
    assert created.any()
    untouched = np.setdiff1d(np.arange(C), uniq.numpy())
    assert bitwise(got[4][untouched], state[4][untouched])


@pytest.mark.parametrize("n", [0, 5, TILE])
@pytest.mark.parametrize("dim", [8, 13])
def test_emulated_rows_at_all_sentinels_and_small(emu_lib, dim, n):
    """An all-sentinel batch (every entry C or negative) leaves the cache
    as it was; n below one tile and exactly one tile apply like the plain
    version; n = 0 launches nothing."""
    rng = np.random.default_rng(dim + n)
    C, pair = 200, ("adagrad", "adam")
    kw = rule_kw(*pair, True)
    state, _, ds, dc, g = at_inputs(rng, C, n + 10, dim, pair, torch.int64)
    ds, dc, g = ds[:n], dc[:n], g[:n].contiguous()
    uniq = torch.from_numpy(rng.choice(C, n, replace=False))
    sentinel = torch.where(torch.arange(n) % 2 == 0, C, -1).to(torch.int64)
    for rows in (sentinel, uniq):
        got = tuple(c.clone() for c in state)
        want = so.ctr_sparse_rows_at(tuple(c.clone() for c in state), rows, ds, dc, g,
                                     capacity=C, **kw)
        before = so.ctr_sparse_rows.launches
        launch_at(emu_lib, got, rows, ds, dc, g, C, kw)
        assert so.ctr_sparse_rows.launches == before + (1 if n else 0)
        for name, a, b in zip(CS.COLUMNS, got, want):
            assert bitwise(a, b), name
        if rows is sentinel:
            for name, a, b in zip(CS.COLUMNS, got, state):
                assert bitwise(a, b), name


def test_emulator_catches_a_broken_sentinel_skip(emu_lib, tmp_path):
    """The in-place tests are not vacuous: the source with the sentinel
    skip turned into a clamp (padding and negative entries update row
    C - 1 or row 0 with their deltas) disagrees with the plain version."""
    src = (CSRC / "ctr_sparse_rows.cu").read_text()
    old = "if (r < 0 || r >= a.capacity) return;"
    assert src.count(old) == 1
    bad = src.replace(old, "r = r < 0 ? 0 : r >= a.capacity ? a.capacity - 1 : r;")
    lib = build_emulated(tmp_path, bad)
    rng = np.random.default_rng(3)
    C, n, pair = 500, 2 * TILE + 9, ("adagrad", "adagrad")
    state, uniq, ds, dc, g = at_inputs(rng, C, n, 8, pair, torch.int64)
    uniq = torch.where((uniq == 0) | (uniq == C - 1), C, uniq)  # rows 0 and C-1 untouched
    kw = rule_kw(*pair, True)
    want = so.ctr_sparse_rows_at(tuple(c.clone() for c in state), uniq, ds, dc, g,
                                 capacity=C, **kw)
    got = tuple(c.clone() for c in state)
    launch_at(lib, got, uniq, ds, dc, g, C, kw)
    assert not all(bitwise(a, b) for a, b in zip(got, want))
    assert not bitwise(got[4][[0, C - 1]], state[4][[0, C - 1]])


def test_emulator_aborts_on_a_misaligned_bulk_copy(emu_lib, tmp_path):
    """The emulated copies hold the card's alignment rule: a tile offset
    that is not a multiple of 16 bytes aborts the launch."""
    src = (CSRC / "ctr_sparse_rows.cu").read_text()
    old = "    a.off[c] = off;\n    off += static_cast<unsigned>(a.tile) * 4u * static_cast<unsigned>(tw[c]);"
    assert src.count(old) == 1
    bad = src.replace(old, old.replace("a.off[c] = off;", "a.off[c] = off + 4;"))
    lib_path = build_emulated(tmp_path, bad)._name
    script = (
        "import ctypes, torch, numpy as np\n"
        "from paddle_tpu_torch.ops import sparse_optimizer as so\n"
        f"lib = so.bind_kernel(ctypes.CDLL({lib_path!r}))\n"
        "so._stream = lambda t: None\n"
        "n, dim = 256, 8\n"
        "state = tuple(torch.zeros(s) for s in [(n,), (n,), (n, 1), (n, 1), (n, dim), (n, 1), (n,)])\n"
        "so._launch_at(lib, state, torch.arange(n), torch.ones(n), torch.zeros(n),\n"
        "              torch.zeros(n, 1 + dim), capacity=n, dim=dim, es=1, xs=1,\n"
        "              embed_rule='adagrad', embedx_rule='adagrad', create_applies_grad=True,\n"
        "              lr=0.1, initial_g2sum=3.0, weight_bounds=(-10.0, 10.0), beta1=0.9,\n"
        "              beta2=0.999, eps=1e-8, nonclk_coeff=0.1, click_coeff=1.0,\n"
        "              embedx_threshold=0.0)\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          cwd=str(ROOT))
    assert proc.returncode != 0 and "misaligned" in proc.stderr, proc.stderr[-2000:]


def _shard_inputs(rng, dim, pair, uniq_dtype, K=4, per=125, s=1):
    """Shard s of a K-shard cache of K·per rows: each column the view of its
    block of rows, as ``shard_state`` hands a shard (per = 125: the 1-wide
    columns start on 4 bytes, Adam's 18-float rows on 8), and 130 entries
    (one whole tile and a short one) into it."""
    full, _ = CS.rows_inputs(rng, K * per, dim, *pair, "cpu")
    _, uniq, ds, dc, g = at_inputs(rng, per, 130, dim, pair, uniq_dtype)
    return full, tuple(c[s * per:(s + 1) * per] for c in full), uniq, ds, dc, g, per


def _off_by_one_float(t):
    """A copy of t that starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("pair", RULE_PAIRS, ids=lambda p: "/".join(p))
@pytest.mark.parametrize("dim", [8, 13])
def test_emulated_rows_at_on_a_shard_view(emu_lib, dim, pair):
    """In place on one shard's block of a cache whose shard size is not a
    multiple of 4 rows: every piece fits the column's own address (the
    emulated cp.async aborts on a misaligned one), the shard equals the
    plain version's bitwise, and the other shards keep their bits."""
    i = RULE_PAIRS.index(pair)
    rng = np.random.default_rng(2000 + dim * 10 + i)
    full, shard, uniq, ds, dc, g, per = _shard_inputs(rng, dim, pair,
                                                      (torch.int32, torch.int64)[i % 2])
    kw = rule_kw(*pair, True)
    want = so.ctr_sparse_rows_at(tuple(c.clone() for c in shard), uniq, ds, dc, g,
                                 capacity=per, **kw)  # CPU: the plain version
    got_full = tuple(c.clone() for c in full)
    launch_at(emu_lib, tuple(c[per:2 * per] for c in got_full), uniq, ds, dc, g, per, kw)
    for name, a, b, f in zip(CS.COLUMNS, got_full, want, full):
        assert bitwise(a[per:2 * per], b), name
        rest = torch.cat([a[:per], a[2 * per:]])
        assert bitwise(rest, torch.cat([f[:per], f[2 * per:]])), name


@pytest.mark.parametrize("pair", RULE_PAIRS, ids=lambda p: "/".join(p))
@pytest.mark.parametrize("dim", [8, 16])
def test_emulated_rows_at_misaligned_bases(emu_lib, dim, pair):
    """Every column and every delta starts 4 bytes past a 16-byte boundary:
    the launch takes the run-time instance with 4-byte pieces and reads
    the entries from global memory (a 16-byte piece or a bulk copy would
    abort in the emulator), bitwise equal to the plain version."""
    i = RULE_PAIRS.index(pair)
    rng = np.random.default_rng(3000 + dim * 10 + i)
    C, n = 300, 2 * TILE + 5
    state, uniq, ds, dc, g = at_inputs(rng, C, n, dim, pair, (torch.int64, torch.int32)[i % 2])
    kw = rule_kw(*pair, True)
    want = so.ctr_sparse_rows_at(tuple(c.clone() for c in state), uniq, ds, dc, g,
                                 capacity=C, **kw)
    got = tuple(_off_by_one_float(c) if c.numel() else c for c in state)
    odd = [_off_by_one_float(t) for t in (ds, dc, g)]
    launch_at(emu_lib, got, uniq, *odd, C, kw)
    for name, a, b in zip(CS.COLUMNS, got, want):
        assert bitwise(a, b), name
