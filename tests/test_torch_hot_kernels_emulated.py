"""``hot_kernels.cu`` run on the CPU: the radix sort, B4's segment walk
and the merge, from the kernel source itself, bitwise against their plain
versions.

The source is compiled with ``g++`` against a small SIMT emulator (below):
one block at a time, each thread a ``ucontext`` fiber, ``__syncthreads``
and the warp intrinsics (``__ballot_sync``, ``__match_any_sync``,
``__shfl*_sync``, ``__syncwarp``, ``__syncthreads_count``) as rendezvous
points where every lane's value is exchanged. Float adds are IEEE f32 as
on the card (``-ffp-contract=off``). It catches what a model of the
design cannot: wrong ranks, halos, searches and barriers in the source.
It says nothing about speed, and nothing about what only nvcc or the card
do (registers, shared-memory limits, the memory model under real
concurrency): ``tests/test_torch_hot_kernels_cuda.py`` runs on the card.
Skips without ``g++``.
"""

import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import hot_kernels as hk
from paddle_tpu_torch.ops.sparse_optimizer import rule_state_dim
from paddle_tpu_torch.ps.embedding_cache import CacheConfig

CSRC = pathlib.Path(hk.__file__).resolve().parent / "csrc"


def _cu_const(name):
    """A ``constexpr int`` of ``hot_kernels.cu``."""
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         (CSRC / "hot_kernels.cu").read_text()).group(1))


BLOCK_MIN = _cu_const("kWalkBlockMin")  # the walk's block threshold

CUDA_RUNTIME_H = r'''// Minimal SIMT emulation of the CUDA features the port's kernels use:
// one block at a time, each thread a ucontext fiber, __syncthreads and
// the warp intrinsics as rendezvous points.
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#define __global__
#define __device__
#define __host__
#define __shared__ static
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
cudaError_t cudaGetLastError();
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1) : x(a) {}
};
enum cudaLaunchAttributeID { cudaLaunchAttributeProgrammaticStreamSerialization = 1 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct { int programmaticStreamSerializationAllowed; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
extern dim3 threadIdx, blockIdx, blockDim;
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
namespace emu {
enum Op { kBallot, kMatch, kShfl, kShflUp, kShflDown, kSyncWarp };
uint64_t warp_op(Op op, uint64_t v, int arg);
void syncthreads();
int syncthreads_count(int p);
unsigned lanemask_lt();
struct Cfg {
  unsigned grid, block;
  Cfg(unsigned long long g, unsigned long long b, long long = 0, void* = nullptr)
      : grid(static_cast<unsigned>(g)), block(static_cast<unsigned>(b)) {}
};
void launch(Cfg c, std::function<void()> body);
}  // namespace emu
inline unsigned __ballot_sync(unsigned, bool p) { return (unsigned)emu::warp_op(emu::kBallot, p, 0); }
inline unsigned __match_any_sync(unsigned, unsigned v) { return (unsigned)emu::warp_op(emu::kMatch, v, 0); }
template <class T> T __shfl_sync(unsigned, T v, int src) {
  uint64_t u = 0; std::memcpy(&u, &v, sizeof(T));
  u = emu::warp_op(emu::kShfl, u, src); T r; std::memcpy(&r, &u, sizeof(T)); return r;
}
template <class T> T __shfl_up_sync(unsigned, T v, int d) {
  uint64_t u = 0; std::memcpy(&u, &v, sizeof(T));
  u = emu::warp_op(emu::kShflUp, u, d); T r; std::memcpy(&r, &u, sizeof(T)); return r;
}
inline void __syncthreads() { emu::syncthreads(); }
inline int __syncthreads_count(int p) { return emu::syncthreads_count(p); }
template <class T> T __shfl_down_sync(unsigned, T v, int d) {
  uint64_t u = 0; std::memcpy(&u, &v, sizeof(T));
  u = emu::warp_op(emu::kShflDown, u, d); T r; std::memcpy(&r, &u, sizeof(T)); return r;
}
inline void __syncwarp() { emu::warp_op(emu::kSyncWarp, 0, 0); }
inline unsigned atomicAdd(unsigned* p, unsigned v) { unsigned o = *p; *p += v; return o; }
inline int atomicAdd(int* p, int v) { int o = *p; *p += v; return o; }
inline unsigned atomicOr(unsigned* p, unsigned v) { unsigned o = *p; *p |= v; return o; }
template <class... E, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* c, void (*k)(E...), A&&... a) {
  emu::launch(emu::Cfg(c->gridDim.x, c->blockDim.x), [&] { k(a...); });
  return cudaSuccess;
}
'''

EMU_CC = r'''#include "cuda_runtime.h"
#include <ucontext.h>
#include <cstdio>
#include <cstdlib>
#include <vector>
dim3 threadIdx, blockIdx, blockDim;
static cudaError_t g_err = cudaSuccess;
cudaError_t cudaGetLastError() { cudaError_t e = g_err; g_err = cudaSuccess; return e; }
namespace emu {
namespace {
struct Fiber { ucontext_t ctx; char* stack = nullptr; bool done = false; int wait = 0;
               Op op; uint64_t v; int arg; uint64_t res; int cnt = 0; };
std::vector<Fiber> F;
ucontext_t sched;
int cur = -1;
std::function<void()>* body_p = nullptr;
constexpr size_t kStack = 256 * 1024;
void trampoline() { (*body_p)(); F[cur].done = true; }
void yield() { swapcontext(&F[cur].ctx, &sched); }
}  // namespace
uint64_t warp_op(Op op, uint64_t v, int arg) {
  Fiber& f = F[cur]; f.wait = 2; f.op = op; f.v = v; f.arg = arg; yield(); return f.res;
}
void syncthreads() { F[cur].cnt = 0; F[cur].wait = 1; yield(); }
int syncthreads_count(int p) { F[cur].cnt = p != 0; F[cur].wait = 1; yield(); return (int)F[cur].res; }
unsigned lanemask_lt() { unsigned l = threadIdx.x & 31; return (1u << l) - 1u; }
static void resolve_warp(int w0, int nth) {
  int lanes = std::min(32, nth - w0);
  int done = 0, at_op = 0;
  for (int l = 0; l < lanes; ++l) {
    done += F[w0 + l].done;
    at_op += !F[w0 + l].done && F[w0 + l].wait == 2;
  }
  if (at_op == 0 || at_op + done < lanes) return;
  if (done) { fprintf(stderr, "emu: %d lanes exited before a warp op\n", done); abort(); }
  Op op = F[w0].op;
  for (int l = 0; l < lanes; ++l)
    if (F[w0 + l].op != op) { fprintf(stderr, "emu: lanes at different warp ops\n"); abort(); }
  for (int l = 0; l < lanes; ++l) {
    Fiber& f = F[w0 + l]; uint64_t r = 0;
    switch (op) {
      case kBallot: for (int j = 0; j < lanes; ++j) if (F[w0 + j].v) r |= 1ull << j; break;
      case kMatch: for (int j = 0; j < lanes; ++j) if (F[w0 + j].v == f.v) r |= 1ull << j; break;
      case kShfl: { int s = f.arg & 31; r = F[w0 + (s < lanes ? s : l)].v; break; }
      case kShflUp: r = (l >= f.arg) ? F[w0 + l - f.arg].v : f.v; break;
      case kShflDown: r = (l + f.arg < lanes) ? F[w0 + l + f.arg].v : f.v; break;
      case kSyncWarp: break;
    }
    f.res = r;
  }
  for (int l = 0; l < lanes; ++l) F[w0 + l].wait = 0;
}
void launch(Cfg c, std::function<void()> body) {
  blockDim.x = c.block;
  body_p = &body;
  const int nth = (int)c.block;
  if (F.size() < (size_t)nth) F.resize(nth);
  for (auto& f : F) if (!f.stack) f.stack = (char*)malloc(kStack);
  for (unsigned b = 0; b < c.grid; ++b) {
    blockIdx.x = b;
    for (int t = 0; t < nth; ++t) {
      Fiber& f = F[t]; f.done = false; f.wait = 0;
      getcontext(&f.ctx); f.ctx.uc_stack.ss_sp = f.stack; f.ctx.uc_stack.ss_size = kStack;
      f.ctx.uc_link = &sched; makecontext(&f.ctx, trampoline, 0);
    }
    for (;;) {
      bool ran = false;
      for (int t = 0; t < nth; ++t) {
        if (F[t].done || F[t].wait) continue;
        cur = t; threadIdx.x = t; ran = true;
        swapcontext(&sched, &F[t].ctx);
      }
      for (int w0 = 0; w0 < nth; w0 += 32) resolve_warp(w0, nth);
      bool all_done = true, all_bar = true, any_run = false;
      for (int t = 0; t < nth; ++t) {
        if (F[t].done) continue;
        all_done = false;
        if (F[t].wait == 0) any_run = true;
        if (F[t].wait != 1) all_bar = false;
      }
      if (all_done) break;
      if (any_run) continue;
      if (all_bar) {
        uint64_t c = 0;
        for (int t = 0; t < nth; ++t) if (!F[t].done) c += F[t].cnt;
        for (int t = 0; t < nth; ++t) if (!F[t].done) { F[t].wait = 0; F[t].res = c; }
        continue;
      }
      if (!ran) { fprintf(stderr, "emu: deadlock in block %u\n", b); abort(); }
    }
  }
}
}  // namespace emu
'''


def emulated_source(cu: str) -> str:
    """The kernel source with each launch ``k<<<cfg>>>(args)`` turned into
    an emulated launch (``cudaLaunchKernelEx`` is one in the header), the
    inline PTX read of ``%lanemask_lt`` into a call and the dependent-launch
    controls (``griddepcontrol``) into nothing."""
    out = re.sub(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);",
                 lambda m: f"emu::launch(emu::Cfg({m.group(2)}), [&] {{ {m.group(1)}({m.group(3)}); }});",
                 cu, flags=re.S)
    out = out.replace('asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));', "m = emu::lanemask_lt();")
    # one block at a time: a launch has finished before the next starts
    out = out.replace('asm volatile("griddepcontrol.launch_dependents;");', "")
    out = out.replace('asm volatile("griddepcontrol.wait;" ::: "memory");', "")
    assert "<<<" not in out and "asm" not in out, "a launch or PTX the emulator does not take"
    return out


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory, monkeypatch_module):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated kernels")
    d = tmp_path_factory.mktemp("hot_kernels_emu")
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (d / "emu.cc").write_text(EMU_CC)
    (d / "ctr_rule.cuh").write_text((CSRC / "ctr_rule.cuh").read_text())
    (d / "hk.cc").write_text(emulated_source((CSRC / "hot_kernels.cu").read_text()))
    so = d / "libhk_emu.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-Wno-unknown-pragmas", f"-I{d}", "-o", str(so), str(d / "hk.cc"),
                    str(d / "emu.cc")], check=True, capture_output=True)
    # the wrappers' launch code, pointed at the emulated library: CPU
    # pointers, no stream
    monkeypatch_module.setattr(hk, "build_cuda_library", lambda *a, **k: str(so))
    monkeypatch_module.setattr(hk, "_LIB", None)
    monkeypatch_module.setattr(hk, "_stream", lambda t: None)
    return hk.load_hot_kernels()


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("n", [1, 255, 4097, 9001])
@pytest.mark.parametrize("bound", [None, 1000, 1 << 19])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_emulated_radix_sort_is_torch_sort(emu_lib, n, bound, dtype):
    rng = np.random.default_rng(n)
    r = rng.integers(-5, 1200, n)
    r[rng.random(n) < 0.3] = 7                      # a heavy row
    if n > 4000:
        r[:300] = rng.integers(-2**31, 2**31, 300)  # the whole int32 range
    rows = torch.from_numpy(r).to(dtype)
    for index_dtype in (torch.int32, torch.int64):
        got = hk._radix_sort(rows, bound, index_dtype)
        want = hk._sort_rows_plain(rows, bound, index_dtype)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("bound,passes", [(None, 4), (0, 1), (255, 1), (256, 2),
                                          (1 << 17, 3), (1 << 19, 3), (1 << 24, 4)])
def test_emulated_sort_passes(emu_lib, bound, passes):
    """Digit passes: ceil(bit_length(bound) / 8), at least 1, bounded; 4
    full. The work buffer holds both key/value buffers and one count
    matrix a pass."""
    assert emu_lib.radix_sort_passes(int(bound is None), bound or 0) == passes
    n = 5000
    assert emu_lib.radix_sort_work_words(n, int(bound is None), bound or 0) == \
        4 * n + passes * -(-n // _cu_const("kSortTile")) * 256


def _state(rng, C, dim, rule):
    es, xs = rule_state_dim(rule, 1), rule_state_dim(rule, dim)
    f = np.float32
    st = {"show": np.abs(rng.normal(size=C)).astype(f),
          "click": np.abs(rng.normal(size=C)).astype(f),
          "embed_w": rng.normal(size=(C, 1)).astype(f),
          "embed_state": np.abs(rng.normal(size=(C, es))).astype(f),
          "embedx_w": rng.normal(size=(C, dim)).astype(f),
          "embedx_state": np.abs(rng.normal(size=(C, xs))).astype(f),
          "has_embedx": (rng.random(C) > 0.5).astype(f)}
    if rule == "adam":
        st["embed_state"][:, 2:] = 0.9
        st["embedx_state"][:, 2 * dim:] = 0.9
    return {k: torch.from_numpy(v) for k, v in st.items()}


@pytest.mark.parametrize("heavy", [BLOCK_MIN - 1, BLOCK_MIN, 2100])
@pytest.mark.parametrize("dim,rule", [(8, "adagrad"), (8, "adam"), (5, "std_adagrad")])
def test_emulated_walk_matches_plain(emu_lib, dim, rule, heavy):
    """B4 and the merge through every path of the walk (short segments,
    warp-long ones, a ``heavy``-entry one: just below the block threshold
    on a warp, at it or far past it on the block; dropped and negative
    rows; tiles crossed), dim 8 (the fixed-width instance) and 5 (the
    run-time one)."""
    rng = np.random.default_rng(dim + heavy)
    C = 1024
    spread = rng.integers(0, C, 3300)
    spread[spread == 7] = 6  # row 7 holds exactly `heavy` entries
    rows = np.concatenate([spread, np.full(heavy, 7), np.full(40, 9),
                           np.full(33, 11), np.full(300, 12), np.full(100, C),
                           -rng.integers(1, 5, 100), np.full(31, 999)])
    rng.shuffle(rows)
    n = len(rows)
    args = [torch.from_numpy(a) for a in (
        rows.astype(np.int32),
        (rng.normal(size=(n, 1 + dim)) * 10.0 ** rng.integers(-3, 4, (n, 1))).astype(np.float32),
        rng.integers(1, 3, n).astype(np.float32), (rng.random(n) > 0.6).astype(np.float32))]
    cfg = CacheConfig(capacity=C, embedx_dim=dim, embed_rule=rule, embedx_rule=rule,
                      embedx_threshold=1.5)
    state = _state(rng, C, dim, rule)
    want = hk.hot_scatter_apply_plain({k: v.clone() for k, v in state.items()}, *args, cfg)
    got = {k: v.clone() for k, v in state.items()}
    before = hk.hot_scatter_apply.launches
    hk._scatter_apply(emu_lib, got, *args, cfg)
    assert hk.hot_scatter_apply.launches == before + 1
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for rows_dtype in (torch.int32, torch.int64):
        merged = [args[0].to(rows_dtype), *args[1:]]
        mw = hk.merge_sparse_grads_plain(*merged, C)
        mg = hk._merge(emu_lib, *merged, C)
        for g, w in zip(mg, mw):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_emulator_catches_an_unstable_rank(emu_lib, tmp_path):
    """The emulator is not vacuous: the sort with the in-warp rank of
    equal digits reversed inside each round (still a permutation, no
    longer stable) differs from torch.sort."""
    src = emulated_source((CSRC / "hot_kernels.cu").read_text())
    bad = src.replace("+ __popc(peers & lanemask_lt());",
                      "+ (__popc(peers) - 1 - __popc(peers & lanemask_lt()));")
    assert bad != src
    (tmp_path / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (tmp_path / "ctr_rule.cuh").write_text((CSRC / "ctr_rule.cuh").read_text())
    (tmp_path / "emu.cc").write_text(EMU_CC)
    (tmp_path / "bad.cc").write_text(bad)
    so = tmp_path / "libbad.so"
    subprocess.run([shutil.which("g++"), "-std=c++17", "-O1", "-fPIC", "-shared",
                    "-Wno-unknown-pragmas", f"-I{tmp_path}", "-o", str(so),
                    str(tmp_path / "bad.cc"), str(tmp_path / "emu.cc")],
                   check=True, capture_output=True)
    lib = hk.bind_hot_kernels(ctypes.CDLL(str(so)))
    n = 5000
    rows = torch.from_numpy(np.random.default_rng(1).integers(0, 50, n).astype(np.int32))
    out = torch.empty(n, dtype=torch.int32)
    perm = torch.empty(n, dtype=torch.int32)
    work = torch.empty(lib.radix_sort_work_words(n, 1, 0), dtype=torch.int32)  # full mode
    assert lib.radix_sort_launch(rows.data_ptr(), 0, n, 1, 0, out.data_ptr(),
                                 perm.data_ptr(), 0, work.data_ptr(), None) == 0
    # an LSD pass that is not stable loses the lower digits' order, so the
    # keys come out unsorted too
    want_rows, want_perm = torch.sort(rows, stable=True)
    assert not torch.equal(out, want_rows)
    assert not torch.equal(perm.to(torch.int64), want_perm)
