// flash_attention: blockwise softmax attention, forward and backward, on
// Hopper (sm_90a).
//
// Replaces the Pallas kernels of paddle_tpu/ops/flash_attention.py:
//
// - B5 forward (_fwd / _fwd_kernel, :127 / :69): S = Q K^T * scale, masked
//   by the key length and, when causal, by position
//   (q_offset + i >= k_offset + j); an online softmax (running max m and
//   sum l, corr = exp(m_prev - m_new)) over key tiles; O = P V / l and the
//   per-row log-sum-exp lse = m + log(l) (NEG when a row saw no key).
// - B6 backward dQ (_bwd_dq_kernel, :176): P = exp(S - lse) recomputed,
//   dP = dO V^T, dS = P * (dP - delta), dQ = dS K * scale.
// - B7 backward dK/dV (_bwd_dkv_kernel, :221): dV = P^T dO,
//   dK = dS^T Q * scale.
//   Separate from dQ, as in the JAX package: each output row belongs to
//   one block, so there are no atomics and the gradients are the same
//   from run to run, bit for bit.
//
// The TPU grid's sequential axis ("arbitrary") becomes a loop inside one
// thread block, and the VMEM scratch accumulators become registers. A
// block owns a range of rows (query rows for B5 and B6, key rows for B7)
// of one (batch, head) and streams the other side in tiles through shared
// memory. Inputs are read in place in the [B, L, H, D] layout (row stride
// H*D), so no transpose runs around the kernels.
//
// precision "default" (ERNIE's): operands rounded to bf16 (__float2bfloat16_rn,
// the rounding of JAX's astype), products on the tensor cores in bf16 with
// f32 accumulators, the scale applied after the product, P and dS rounded
// to bf16 before their products, everything else f32. Each warp owns 16
// rows, and the S accumulator fragment is reused as the A operand of the
// next product (FlashAttention-2's register layout), so P and dS never
// touch shared memory.
// precision "highest": f32 operands and f32 FMA, never TF32, one thread
// per owned row (tests and parity checks only).
//
// Bounds at ERNIE's call (B*H = 128, L = 512, D = 64, f32 in and out):
// HBM bytes, each input read once and each output written once, are
// 67/84/101 MB for B5/B6/B7 (0.020/0.025/0.030 ms at 3.35 TB/s), against
// 8.6/12.9/17.2 G bf16 operations (0.009/0.013/0.017 ms at 989 TFLOP/s):
// all three are bound by bytes. exp and the masks are a few percent of
// the work.
//
// The three "default" kernels are built around Hopper's asynchronous
// copies and warpgroup products, on one skeleton:
// - A ring of kStages = 2 stages in shared memory, filled with 16-byte
//   cp.async.cg copies (4-byte cp.async.ca for B7's lse and delta rows)
//   and commit/wait groups. While tile j's products run, tile j + 1
//   (landed) is converted and tile j + 2's copies are in flight; a stage
//   is refilled as soon as its tile has been converted. (3 stages measured
//   2-3 % slower for B6 and B7 on the H100, and 37 % slower for B5, whose
//   larger stages then leave room for one block an SM.) The ragged last
//   tile reads zeros past the sequence (cp.async's src-size 0 fill). Under
//   a causal mask the ring walks only the contiguous run of tiles the mask
//   keeps (B5 and B6 stop at the last key tile any of their rows sees, B7
//   starts at the first query tile that sees any of its keys): a skipped
//   tile is never copied, and every group is waited on before the block
//   exits. Only the tiles that cross a warp's causal diagonal or the keys'
//   end apply the masks. B5 takes two ring tiles (64 keys) a step, so its
//   stages and buffers hold 64 rows: its online softmax rounds P against
//   a maximum over 64 keys, and at L <= 64 against the row's maximum, as
//   the plain version does (32-key steps moved the small ERNIE's
//   card-vs-CPU updates past their bound).
// - The ring holds tiles as they landed (f32 in ERNIE, bf16 through the
//   same template T), rows padded by 16 bytes. One cooperative pass per
//   tile writes the bf16 tile that the tensor cores read, with the same
//   __float2bfloat16_rn, into one of two buffers: tile j + 1 is converted
//   while tile j's first products run, so each tile costs one
//   __syncthreads. The resident operands (Q for B5, Q and dO for B6, K and
//   V for B7) are converted once, at the prologue, while the ring's first
//   copies are in flight.
// - Products are wgmma (sm_90a), one warpgroup per 64 owned rows: S (and
//   dP) over a 32-row tile (m64n32k16), then O += P V (B5), dQ (B6), or dV
//   and dK (B7) (m64n{64,128}k16, the tile read transposed), all from one
//   blocked copy of each tile in shared memory, read by the tensor cores
//   once per warpgroup (mma.sync would read every B fragment once per
//   16-row warp, through ldmatrix and the register file). B5 and B6 keep
//   their warp's Q (and dO) A fragments in registers; B7 reads K and V
//   from shared memory (its dK and dV accumulators take 64 of its 128
//   registers). S and dP come back in FA-2's fragment layout, and P and dS
//   are the register A operand of the next products. In B6 and B7 the
//   last product of tile j (dQ, or dV and dK) runs on while the next step
//   waits for its copies and is waited for before that step's barrier,
//   which then frees its buffer; keeping it in flight past the barrier (a
//   third buffer) made ptxas serialise the wgmma for want of registers,
//   and was slower. B5 waits for both its products within the step,
//   converting the next step's K while S runs and its V while P V runs:
//   with P V in flight into the next step, the rescaling of O made ptxas
//   serialise B5's wgmma (C7515), and it was slower.
// - Blocks own kBRows = 128 rows (two warpgroups) and stream kBTile = 32
//   rows a stage. Each block re-reads the whole other side of its (batch,
//   head) from L2, in f32 in ERNIE: 128 owned rows halve those re-reads
//   against 64 (at ERNIE's call B5 runs 512 blocks that read 134 MB of K
//   and V from L2, where the 1,024 blocks of 64 rows read 268 MB; the HBM
//   bound counts 67 MB), and 32-row stages keep S and dP at 16 registers
//   each. Shared memory at D = 64, f32: 102,400 bytes (B5, which stages Q
//   in its bf16 buffers before their first use), 88,064 (B6) and 84,992
//   (B7) a block, so two blocks (16 warps) share an SM with a 16 KB stage
//   (32 KB for B5) of each in flight behind the products (Little's law at
//   3.35 TB/s and ~1 us asks for ~25 KB an SM). The head width is a
//   compile-time 64 (or 128, zeros past D). __launch_bounds__(256, 2)
//   holds registers to 128 a thread: ptxas (-Xptxas -v) gives B5 128 and
//   B6 and B7 126-128 registers with no spill and no serialised wgmma; the
//   D = 128 variants hold one block an SM at 190-216 (B5) and 214-236.
// - exp is ex2.approx of an FMA on log2(e)-prescaled operands (one
//   MUFU.EX2 a score). In B6 and B7 a row past the end or one that saw no
//   key carries lse = +inf, so its P is 0 without a mask. B5's online
//   softmax runs in log2 units: s2 = S * scale * log2(e), a running
//   maximum m2, P = ex2(s2 - m2) and the correction ex2(m2_old - m2_new)
//   of O and l. A masked score is -inf and the maximum starts at the
//   finite NEG, so a row that has seen no key keeps P = 0 and never forms
//   inf - inf; lse is written in natural units, m * scale + log(l).
//
// Each entry returns cudaGetLastError(); the Python wrapper raises if it
// is not 0. The kernels launch on the caller's stream and allocate
// nothing. Built with the port's common flags (--fmad=false): the mma
// path is unaffected, the f32 path calls fmaf explicitly.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNeg = -1e30f;   // the JAX package's NEG
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;        // rows a block owns (f32 path)
constexpr int kPad = 8;          // bf16 padding of a resident row-major row
constexpr int kTileF = 32;       // rows streamed per step (f32 path)
constexpr int kBRows = 128;      // rows a block owns (B5, B6, B7)
constexpr int kBThreads = kBRows / 16 * 32;  // one warp per 16 rows
constexpr int kBTile = 32;       // rows a ring stage holds
constexpr int kStages = 2;       // ring depth
constexpr int kBBlocks = 2;      // blocks an SM holds (at D <= 64)

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

// the [B, L, H, D] geometry of one (batch, head)
struct Seq {
  int64_t base;    // element offset of row 0
  int64_t stride;  // H * D
  int len;
};

__device__ __forceinline__ Seq seq_of(int bh, int H, int L, int D) {
  const int b = bh / H, h = bh - b * H;
  return Seq{(static_cast<int64_t>(b) * L * H + h) * D, static_cast<int64_t>(H) * D, L};
}

// four consecutive elements as f32 (16 bytes for f32, 8 for bf16; the
// wrappers check the alignment)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + n) of a sequence into shared memory as bf16, row-major
// [n][ld] (or, with kBlock > 0, in 8x8 core matrices of a kBlock-column
// tile: see the wgmma section); rows past the end and columns past D are
// zeros. Each of the block's kN threads moves four elements at a time and
// issues kBatch loads before it stores any, so the copy pays the memory
// latency once per kBatch loads instead of once per element.
template <int kN, int kBatch, int kBlock = 0, typename T>
__device__ void stage_bf16(const T* __restrict__ src, Seq s, int r0, int n, int D, int Dp,
                           bf16* dst, int ld) {
  const int per_row = Dp >> 2, total = n * per_row;
  for (int base = threadIdx.x; base < total; base += kBatch * kN) {
    float4 x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kN, r = idx / per_row, d = (idx - r * per_row) * 4;
      x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < total && r0 + r < s.len && d < D)
        x[u] = load4(src + s.base + (r0 + r) * s.stride + d);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kN, r = idx / per_row, d = (idx - r * per_row) * 4;
      const int o = kBlock ? ((r >> 3) * (kBlock / 8) + (d >> 3)) * 64 + (r & 7) * 8 + (d & 7)
                           : r * ld + d;
      if (idx < total)
        *reinterpret_cast<uint2*>(dst + o) =
            make_uint2(pack_bf16(x[u].x, x[u].y), pack_bf16(x[u].z, x[u].w));
    }
  }
}

// the same in f32, row-major [n][ld]
template <typename T>
__device__ void stage_f32(const T* __restrict__ src, Seq s, int r0, int n, int D, float* dst,
                          int ld) {
  for (int idx = threadIdx.x; idx < n * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    dst[r * ld + d] = r0 + r < s.len ? to_f32(src[s.base + (r0 + r) * s.stride + d]) : 0.f;
  }
}

// per-row lse and delta ([B, L, H] f32) of rows [r0, r0 + n); a row past
// the end gets lse = NEG (so P = 0) and delta = 0
__device__ void stage_rows(const float* __restrict__ lse, const float* __restrict__ delta,
                           int bh, int H, int L, int r0, int n, float* lse_s, float* delta_s) {
  const int b = bh / H, h = bh - b * H;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool ok = r0 + i < L;
    const int64_t o = (static_cast<int64_t>(b) * L + r0 + i) * H + h;
    lse_s[i] = ok ? lse[o] : kNeg;
    delta_s[i] = ok ? delta[o] : 0.f;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// asynchronous copies into shared memory; with ok false nothing is read
// (src-size 0) and the destination is filled with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ring: rows [r0, r0 + kBTile) of a sequence into a stage as they are
// ([kBTile][kRs] of T, columns D.. not copied), 16 bytes a copy; rows past
// the end are zeros. kRs pads a row by 16 bytes, so the conversion's reads
// of eight rows at one column are free of bank conflicts. The wrappers
// check that D is a multiple of 8 and the tensors start on 16 bytes, so
// every row starts on 16 bytes in both types.
template <int kDp, int kRs, typename T>
__device__ __forceinline__ void ring_rows(const T* __restrict__ src, Seq s, int r0, int D,
                                          T* dst) {
  constexpr int kV = 16 / sizeof(T), kPer = kDp / kV, kN = kBTile * kPer;  // copies a tile
  static_assert(kN % kBThreads == 0, "a stage is a whole number of copies per thread");
#pragma unroll
  for (int u = 0; u < kN / kBThreads; ++u) {
    const int c = threadIdx.x + u * kBThreads, r = c / kPer, d = c % kPer * kV;
    if (d < D) {
      const bool ok = r0 + r < s.len;
      cp_async16(dst + r * kRs + d, ok ? src + s.base + (r0 + r) * s.stride + d : src, ok);
    }
  }
}

// ring: lse and delta ([B, L, H] f32, row stride H) of rows
// [r0, r0 + kBTile), one 4-byte copy each; rows past the end are zeros
__device__ __forceinline__ void ring_stats(const float* __restrict__ lse,
                                           const float* __restrict__ delta, int bh, int H,
                                           int L, int r0, float* dst) {
  const int i = threadIdx.x;
  if (i >= 2 * kBTile) return;
  const int b = bh / H, h = bh - b * H, r = i % kBTile;
  const float* src = i < kBTile ? lse : delta;
  const bool ok = r0 + r < L;
  cp_async4(dst + i, ok ? src + (static_cast<int64_t>(b) * L + r0 + r) * H + h : src, ok);
}

// 16 landed bytes as bf16 (four f32 rounded by __float2bfloat16_rn, as
// stage_bf16 rounds them; eight bf16 copied)
__device__ __forceinline__ void put_bf16(bf16* dst, const float* src) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
}
__device__ __forceinline__ void put_bf16(bf16* dst, const bf16* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

// a landed stage [kBTile][kRs] of T into the blocked bf16 tile that wgmma
// reads (8x8 core matrices, see the wgmma section), rounded as stage_bf16
// rounds; columns D..kDp keep the zeros written at the prologue. Sixteen
// (f32) or eight (bf16) threads fill one 128-byte core matrix, so the
// stores are free of bank conflicts.
template <int kDp, int kRs, typename T>
__device__ __forceinline__ void ring_to_blocked(const T* src, int D, bf16* dst) {
  constexpr int kV = 16 / sizeof(T), kParts = 8 / kV;   // 16-byte pieces of a core row
  constexpr int kU = 8 * kParts, kN = kBTile * kDp / kV;  // pieces a core matrix, a tile
  static_assert(kN % kBThreads == 0, "a tile is a whole number of pieces per thread");
#pragma unroll
  for (int u = 0; u < kN / kBThreads; ++u) {
    const int c = threadIdx.x + u * kBThreads, cm = c / kU, w = c % kU;
    const int row = w / kParts, part = w % kParts;
    const int r = cm / (kDp / 8) * 8 + row, d = cm % (kDp / 8) * 8 + part * kV;
    if (d < D) put_bf16(dst + cm * 64 + row * 8 + part * kV, src + r * kRs + d);
  }
}

// zeros over n bytes of shared memory (n a multiple of 16)
__device__ __forceinline__ void zero_smem(void* p, int n) {
  for (int i = threadIdx.x; i < n / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(p)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// ---------------------------------------------------------------------------
// B5, B6 and B7: helpers
// ---------------------------------------------------------------------------

// the maximum and the sum over the four lanes (t = 0..3) that hold one
// row of an accumulator fragment
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// this lane's ldmatrix address (in elements from the fragment's first row)
// of an A fragment of a row-major [rows][kLd] array: lanes 0-15 rows 0..15
// at column 0, lanes 16-31 the same rows at column 8
template <int kLd>
__device__ __forceinline__ int lane_a(int lane) {
  return (lane & 15) * kLd + (lane >> 4) * 8;
}

// 2^x (MUFU.EX2; -inf -> 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two adjacent columns of an output row
__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// store the accumulator fragment rows (r0 + g, r0 + g + 8) x D of one
// (batch, head), times `mul`, two columns a store; acc holds NT n-tiles
// of mma.sync's C layout
template <typename T, int NT>
__device__ __forceinline__ void store_pairs(T* __restrict__ dst, Seq s, int r0, int D,
                                            const float acc[NT * 4], float mul, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= s.len) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = n * 8 + 2 * t;
      if (d < D)
        put2(dst + s.base + row * s.stride + d, acc[4 * n + 2 * r] * mul,
             acc[4 * n + 2 * r + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// B5, B6 and B7: warpgroup products (wgmma) on core-matrix-blocked bf16 tiles
// ---------------------------------------------------------------------------
//
// A tile of R rows x kDp columns sits in shared memory as 8x8 core
// matrices of 128 contiguous bytes (8 rows of 8 bf16), core matrix
// (r / 8, d / 8) at byte (r / 8 * kDp / 8 + d / 8) * 128. wgmma reads it
// through a matrix descriptor in either role:
// - K-major (k = d: S = Q K^T, dP = dO V^T, their transposes in B7): LBO
//   = 128 bytes between column groups, SBO = kDp / 8 * 128 between row
//   groups, a 16-column step 256 bytes further;
// - MN-major (k = row, n = d, read transposed: O = P V, dQ = dS K,
//   dV = P^T dO, dK = dS^T Q): LBO = kDp / 8 * 128 between row groups, SBO = 128
//   between column groups, a 16-row step two row groups further.
// (Both measured against a host product on the H100 before use.) A
// register A operand of a warpgroup's 64 rows is, per warp, mma.sync's
// m16n8k16 A fragment, and the f32 accumulator of m64nN is, per warp,
// N / 8 mma.sync C fragments: S and dP come back in the FA-2 layout, and
// P and dS feed the next product from registers.

// descriptor of a no-swizzle matrix at shared byte address a
__device__ __forceinline__ uint64_t mdesc(uint32_t a, int lbo, int sbo) {
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared-memory writes of this thread made visible to the async proxy
// (wgmma's operand reads)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// pin accumulator registers: reads after wg_wait() stay after it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[16] (+)= A (registers) . B, m64n32k16, B K-major
__device__ __forceinline__ void wgmma_n32_rs(float (&d)[16], const uint32_t a[4], uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d[16] (+)= A . B, m64n32k16, both from shared memory, K-major
__device__ __forceinline__ void wgmma_n32_ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

// d[4 NT] += A (registers) . B, m64n(8 NT)k16, B MN-major (read transposed)
template <int NT>
__device__ __forceinline__ void wgmma_nd_rs_t(float (&d)[NT * 4], const uint32_t a[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_nd_rs_t<8>(float (&d)[32], const uint32_t a[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_nd_rs_t<16>(float (&d)[64], const uint32_t a[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// B5, forward, wgmma, fed by the cp.async ring
// ---------------------------------------------------------------------------

// B5's online softmax takes kFKeys = 64 keys a step, two ring tiles: P
// rounds to bf16 against the running maximum over 64 keys, so at L <= 64
// it rounds against the row's maximum as the plain version does.
constexpr int kFKeys = 2 * kBTile;

// Shared memory of B5 (bytes): two blocked bf16 K/V buffers of a step (Q
// is staged there as row-major bf16 at the prologue and read once into
// registers), the ring of kStages K/V stages of a step as they landed
// (rows padded by 16 bytes).
template <int NT>
constexpr size_t fwd_smem(int itemsize) {
  return static_cast<size_t>(4 * kFKeys) * NT * 8 * 2 +
         static_cast<size_t>(kStages) * 2 * kFKeys * (NT * 8 * itemsize + 16);
}

template <typename T, int NT>
__global__ void __launch_bounds__(kBThreads, NT <= 8 ? kBBlocks : 1)
fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ out, float* __restrict__ lse, int H, int Lq, int Lk, int D,
               float scale, int causal, int q_off, int k_off) {
  constexpr int kDp = NT * 8, kLd = kDp + kPad;
  constexpr int kRs = kDp + 16 / sizeof(T);  // ring row stride (elements)
  constexpr int kTb = kBTile * kDp * 2;      // bytes of a blocked bf16 ring tile
  constexpr int kG = kDp / 8 * 128;          // bytes between its 8-row groups
  static_assert(kBRows * kLd <= 4 * kFKeys * kDp, "Q fits the blocked buffers");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* kv_b = reinterpret_cast<bf16*>(smem);  // [2 buffers][K, V] blocked, kFKeys rows each
  bf16* q_s = kv_b;                            // [kBRows][kLd] at the prologue only
  T* ring = reinterpret_cast<T*>(kv_b + 4 * kFKeys * kDp);  // [kStages][K, V][kFKeys][kRs]
  constexpr int kStage = 2 * kFKeys * kRs;
  const int bh = blockIdx.y, q0 = blockIdx.x * kBRows;
  const Seq sq = seq_of(bh, H, Lq, D), sk = seq_of(bh, H, Lk, D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;  // this warp's rows: 16 of its warpgroup's 64
  const int pos[2] = {q_off + q0 + wr + g, q_off + q0 + wr + g + 8};

  // steps 0..n-1 of kFKeys keys: all of them, or under the causal mask up
  // to the last one that any row of this block sees
  int n = (Lk + kFKeys - 1) / kFKeys;
  if (causal) {
    const int last = q_off + q0 + kBRows - 1 - k_off;  // the last key position seen
    n = last < 0 ? 0 : min(n, last / kFKeys + 1);
  }
  auto issue = [&](int j) {  // the keys of step j into stage j % kStages
    T* dst = ring + (j % kStages) * kStage;
#pragma unroll
    for (int x = 0; x < 4; ++x)  // K, then V, each in two tiles of kBTile rows
      ring_rows<kDp, kRs>(x < 2 ? k : v, sk, j * kFKeys + (x & 1) * kBTile, D,
                          dst + x * kBTile * kRs);
  };
  auto convert = [&](int j, int x) {  // K (x = 0) or V (1) of landed step j into buffer j & 1
    const T* src = ring + (j % kStages) * kStage + x * kFKeys * kRs;
    bf16* dst = kv_b + ((j & 1) * 2 + x) * kFKeys * kDp;
    ring_to_blocked<kDp, kRs>(src, D, dst);
    ring_to_blocked<kDp, kRs>(src + kBTile * kRs, D, dst + kBTile * kDp);
    fence_async_smem();
  };

  // prologue: the first kStages steps in flight (one group each, empty past
  // n); meanwhile Q with plain loads into the blocked buffers, read into
  // registers before they are cleared and take step 0
#pragma unroll
  for (int j = 0; j < kStages; ++j) {
    if (j < n) issue(j);
    cp_async_commit();
  }
  stage_bf16<kBThreads, 8>(q, sq, q0, kBRows, D, kDp, q_s, kLd);
  __syncthreads();
  // this warp's A fragments of Q (the register A operand of S)
  uint32_t qf[kDp / 16][4];
  {
    const uint32_t qa = smem_addr(q_s + wr * kLd + lane_a<kLd>(lane));
#pragma unroll
    for (int ks = 0; ks < kDp / 16; ++ks) ldsm_x4(qf[ks], qa + ks * 32);
  }
  __syncthreads();
  zero_smem(kv_b, 4 * kFKeys * kDp * 2);  // the bf16 tiles' columns D..kDp stay 0
  const float scale2 = scale * kLog2e;
  const uint32_t kv0 = smem_addr(kv_b);
  cp_async_wait<kStages - 1>();  // step 0 (this thread's copies)
  __syncthreads();
  if (n > 0) {
    convert(0, 0);
    convert(0, 1);
  }

  float acc[NT * 4];  // O of this warp's 16 rows: NT n-tiles of mma.sync's C layout
#pragma unroll
  for (int i = 0; i < NT * 4; ++i) acc[i] = 0.f;
  // per row (g, g + 8): the running maximum of the raw scores, the same
  // times scale * log2(e), and this thread's part of the running sum
  float m[2] = {kNeg, kNeg}, m2[2] = {kNeg * scale2, kNeg * scale2}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n; ++j) {
    cp_async_wait<kStages - 2>();  // step j + 1 (this thread's copies)
    // step j's bf16 buffer and step j + 1's stage are complete; every warp
    // is done with stage j (converted) and with buffer (j + 1) & 1 (step
    // j - 1's products, waited for within step j - 1)
    __syncthreads();
    if (j + kStages < n) issue(j + kStages);
    cp_async_commit();

    const uint32_t kb = kv0 + (j & 1) * 4 * kTb, vb = kb + 2 * kTb;
    float s[2][kBTile / 2];  // S of the step's two ring tiles, kBTile / 8 n-tiles each
    wg_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ks = 0; ks < kDp / 16; ++ks)
        wgmma_n32_rs(s[h], qf[ks], mdesc(kb + h * kTb + ks * 256, 128, kG), ks > 0);
    wg_commit();
    if (j + 1 < n) convert(j + 1, 0);  // K, on the CUDA cores while S runs
    wg_wait();
    fence_regs(s[0]);
    fence_regs(s[1]);
    const int c0 = j * kFKeys;
    // a step past the keys' end, or one that crosses this warp's causal
    // diagonal, masks by position (-inf); every other step keeps all keys
    if (c0 + kFKeys > Lk || (causal && k_off + c0 + kFKeys - 1 > q_off + q0 + wr)) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < kBTile / 2; ++i) {
          const int r = (i >> 1) & 1, c = c0 + h * kBTile + (i >> 2) * 8 + 2 * t + (i & 1);
          if (!(c < Lk && (!causal || k_off + c <= pos[r]))) s[h][i] = __uint_as_float(0xff800000u);
        }
    }
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < kBTile / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[h][i]);
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = fmaxf(m[r], quad_max(mx[r]));
      const float m2_new = m[r] * scale2;
      corr[r] = ex2(m2[r] - m2_new);  // 1 while the row has seen no key
      m2[r] = m2_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < kBTile / 2; ++i) {
        const int r = (i >> 1) & 1;
        s[h][i] = ex2(__fmaf_rn(s[h][i], scale2, -m2[r]));  // P; 0 for a masked key
        l[r] += s[h][i];
      }
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) acc[i] *= corr[(i >> 1) & 1];
    uint32_t a[kFKeys / 16][4];  // P as the A operand, 16 keys a product
#pragma unroll
    for (int kk = 0; kk < kFKeys / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float* p = s[kk >> 1] + 8 * (kk & 1) + 2 * x;
        a[kk][x] = pack_bf16(p[0], p[1]);
      }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kFKeys / 16; ++kk)
      wgmma_nd_rs_t<NT>(acc, a[kk], mdesc(vb + kk * 2 * kG, kG, 128));
    wg_commit();
    if (j + 1 < n) convert(j + 1, 1);  // V, while P V runs
    wg_wait();
    fence_regs(acc);
  }
  cp_async_wait<0>();
  float ltot[2], lsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ltot[r] = quad_sum(l[r]);
    lsum[r] = fmaxf(ltot[r], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < NT * 4; ++i) acc[i] /= lsum[(i >> 1) & 1];
  store_pairs<T, NT>(out, sq, q0 + wr, D, acc, 1.f, lane);
  if (t == 0) {
    const int b = bh / H, h = bh - b * H;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wr + g + 8 * r;
      if (row < Lq)
        lse[(static_cast<int64_t>(b) * Lq + row) * H + h] =
            ltot[r] > 0.f ? m[r] * scale + logf(lsum[r]) : kNeg;
    }
  }
}

// ---------------------------------------------------------------------------
// B6, backward dQ, wgmma, fed by the cp.async ring
// ---------------------------------------------------------------------------

// Shared memory of B6 (bytes): resident Q and dO as row-major bf16 (read
// once into registers), two blocked bf16 K/V tiles, the ring of kStages
// K/V stages as they landed (rows padded by 16 bytes).
template <int NT>
constexpr size_t dq_smem(int itemsize) {
  return static_cast<size_t>(2 * kBRows) * (NT * 8 + kPad) * 2 +
         static_cast<size_t>(4 * kBTile) * NT * 8 * 2 +
         static_cast<size_t>(kStages) * 2 * kBTile * (NT * 8 * itemsize + 16);
}

template <typename T, int NT>
__global__ void __launch_bounds__(kBThreads, NT <= 8 ? kBBlocks : 1)
bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq, int H, int Lq, int Lk,
                  int D, float scale, int causal, int q_off, int k_off) {
  constexpr int kDp = NT * 8, kLd = kDp + kPad;
  constexpr int kRs = kDp + 16 / sizeof(T);  // ring row stride (elements)
  constexpr int kTb = kBTile * kDp * 2;      // bytes of a blocked bf16 tile
  constexpr int kG = kDp / 8 * 128;          // bytes between its 8-row groups
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kBRows][kLd], resident
  bf16* do_s = q_s + kBRows * kLd;            // [kBRows][kLd], resident
  bf16* kv_b = do_s + kBRows * kLd;           // [2 buffers][K, V] blocked tiles
  T* ring = reinterpret_cast<T*>(kv_b + 4 * kBTile * kDp);  // [kStages][K, V][kBTile][kRs]
  constexpr int kStage = 2 * kBTile * kRs;
  const int bh = blockIdx.y, q0 = blockIdx.x * kBRows;
  const Seq sq = seq_of(bh, H, Lq, D), sk = seq_of(bh, H, Lk, D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;  // this warp's rows: 16 of its warpgroup's 64
  const int pos[2] = {q_off + q0 + wr + g, q_off + q0 + wr + g + 8};

  // key tiles 0..n-1: all of them, or under the causal mask up to the last
  // one that any row of this block sees
  int n = (Lk + kBTile - 1) / kBTile;
  if (causal) {
    const int last = q_off + q0 + kBRows - 1 - k_off;  // the last key position seen
    n = last < 0 ? 0 : min(n, last / kBTile + 1);
  }
  auto issue = [&](int j) {  // key tile j into stage j % kStages
    T* dst = ring + (j % kStages) * kStage;
    ring_rows<kDp, kRs>(k, sk, j * kBTile, D, dst);
    ring_rows<kDp, kRs>(v, sk, j * kBTile, D, dst + kBTile * kRs);
  };
  auto convert = [&](int j) {  // landed key tile j into bf16 buffer j & 1
    const T* src = ring + (j % kStages) * kStage;
    bf16* dst = kv_b + (j & 1) * 2 * kBTile * kDp;
    ring_to_blocked<kDp, kRs>(src, D, dst);
    ring_to_blocked<kDp, kRs>(src + kBTile * kRs, D, dst + kBTile * kDp);
    fence_async_smem();
  };

  // prologue: the first kStages tiles in flight (one group each, empty
  // past n), then the resident operands with plain loads meanwhile
#pragma unroll
  for (int j = 0; j < kStages; ++j) {
    if (j < n) issue(j);
    cp_async_commit();
  }
  zero_smem(kv_b, 2 * kTb * 2);  // the bf16 tiles' columns D..kDp stay 0
  stage_bf16<kBThreads, 8>(q, sq, q0, kBRows, D, kDp, q_s, kLd);
  stage_bf16<kBThreads, 8>(dout, sq, q0, kBRows, D, kDp, do_s, kLd);
  // lse * log2(e), so P = exp2(S * scale * log2(e) - lse2); +inf (P = 0)
  // for a row past the end or one that saw no key (lse NEG)
  float lse2[2], delta_r[2];
  {
    const int b = bh / H, h = bh - b * H;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wr + g + 8 * r;
      const int64_t o = (static_cast<int64_t>(b) * Lq + row) * H + h;
      const float l = row < Lq ? lse[o] : kNeg;
      lse2[r] = l > kNeg / 2 ? l * kLog2e : __int_as_float(0x7f800000);
      delta_r[r] = row < Lq ? delta[o] : 0.f;
    }
  }
  const float scale2 = scale * kLog2e;
  const uint32_t kv0 = smem_addr(kv_b);
  cp_async_wait<kStages - 1>();  // tile 0 (this thread's copies)
  __syncthreads();
  // this warp's A fragments of Q and dO (the register A operand of S and dP)
  uint32_t qf[kDp / 16][4], dof[kDp / 16][4];
  {
    const uint32_t qa = smem_addr(q_s + wr * kLd + lane_a<kLd>(lane));
    const uint32_t doa = smem_addr(do_s + wr * kLd + lane_a<kLd>(lane));
#pragma unroll
    for (int ks = 0; ks < kDp / 16; ++ks) {
      ldsm_x4(qf[ks], qa + ks * 32);
      ldsm_x4(dof[ks], doa + ks * 32);
    }
  }
  if (n > 0) convert(0);

  float acc[NT * 4];  // dQ of this warp's 16 rows: NT n-tiles of mma.sync's C layout
#pragma unroll
  for (int i = 0; i < NT * 4; ++i) acc[i] = 0.f;

  for (int j = 0; j < n; ++j) {
    cp_async_wait<kStages - 2>();  // tile j + 1 (this thread's copies)
    wg_wait();                     // this warpgroup's dQ product of tile j - 1
    // tile j's bf16 buffer and tile j + 1's stage are complete; every warp
    // is done with stage j (converted) and with buffer (j + 1) & 1 (tile
    // j - 1's products)
    __syncthreads();
    if (j + kStages < n) issue(j + kStages);
    cp_async_commit();

    const uint32_t kb = kv0 + (j & 1) * 2 * kTb, vb = kb + kTb;
    float s[kBTile / 2], dp[kBTile / 2];  // S and dP, kBTile / 8 n-tiles
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kDp / 16; ++ks) {
      wgmma_n32_rs(s, qf[ks], mdesc(kb + ks * 256, 128, kG), ks > 0);
      wgmma_n32_rs(dp, dof[ks], mdesc(vb + ks * 256, 128, kG), ks > 0);
    }
    wg_commit();
    if (j + 1 < n) convert(j + 1);  // on the CUDA cores while S and dP run
    wg_wait();
    fence_regs(s);
    fence_regs(dp);
    const int c0 = j * kBTile;
    // a tile past the keys' end, or one that crosses this warp's causal
    // diagonal, masks by position; every other tile by lse alone
    const bool edge = c0 + kBTile > Lk || (causal && k_off + c0 + kBTile - 1 > q_off + q0 + wr);
#pragma unroll
    for (int i = 0; i < kBTile / 2; ++i) {
      const int r = (i >> 1) & 1, c = c0 + (i >> 2) * 8 + 2 * t + (i & 1);
      float p = ex2(__fmaf_rn(s[i], scale2, -lse2[r]));
      if (edge && !(c < Lk && (!causal || k_off + c <= pos[r]))) p = 0.f;
      s[i] = p * (dp[i] - delta_r[r]);  // dS
    }
    uint32_t a[kBTile / 16][4];  // dS as the A operand, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < kBTile / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) a[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBTile / 16; ++kk)
      wgmma_nd_rs_t<NT>(acc, a[kk], mdesc(kb + kk * 2 * kG, kG, 128));
    wg_commit();
  }
  cp_async_wait<0>();
  wg_wait();
  fence_regs(acc);
  store_pairs<T, NT>(dq, sq, q0 + wr, D, acc, scale, lane);
}

// ---------------------------------------------------------------------------
// B7, backward dK and dV, wgmma, fed by the cp.async ring
// ---------------------------------------------------------------------------

// Shared memory of B7 (bytes): resident K and V as blocked bf16 (wgmma's
// A operand), two blocked bf16 Q/dO tiles, two copies of a tile's lse and
// delta, the ring of kStages Q/dO stages as they landed (rows padded by
// 16 bytes) and their lse/delta rows.
template <int NT>
constexpr size_t dkv_smem(int itemsize) {
  return static_cast<size_t>(2 * kBRows + 4 * kBTile) * NT * 8 * 2 +
         static_cast<size_t>(2 + kStages) * 2 * kBTile * 4 +
         static_cast<size_t>(kStages) * 2 * kBTile * (NT * 8 * itemsize + 16);
}

template <typename T, int NT>
__global__ void __launch_bounds__(kBThreads, NT <= 8 ? kBBlocks : 1)
bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                   int H, int Lq, int Lk, int D, float scale, int causal, int q_off, int k_off) {
  constexpr int kDp = NT * 8;
  constexpr int kRs = kDp + 16 / sizeof(T);
  constexpr int kTb = kBTile * kDp * 2;
  constexpr int kG = kDp / 8 * 128;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [kBRows x kDp] blocked, resident
  bf16* v_s = k_s + kBRows * kDp;             // [kBRows x kDp] blocked, resident
  bf16* qd_b = v_s + kBRows * kDp;            // [2 buffers][Q, dO] blocked tiles
  float* st_b = reinterpret_cast<float*>(qd_b + 4 * kBTile * kDp);  // [2][lse2, delta][kBTile]
  float* st_r = st_b + 2 * 2 * kBTile;         // [kStages][lse, delta][kBTile]
  T* ring = reinterpret_cast<T*>(st_r + kStages * 2 * kBTile);  // [kStages][Q, dO][kBTile][kRs]
  constexpr int kStage = 2 * kBTile * kRs;
  const int bh = blockIdx.y, c0 = blockIdx.x * kBRows;
  const Seq sq = seq_of(bh, H, Lq, D), sk = seq_of(bh, H, Lk, D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;  // this warp's keys: 16 of its warpgroup's 64
  const int kpos[2] = {k_off + c0 + wr + g, k_off + c0 + wr + g + 8};

  // query tiles t0..t0+n-1: all of them, or under the causal mask from the
  // first one whose last row sees this block's first key
  int t0 = 0;
  if (causal) {
    const int x = k_off + c0 - q_off - (kBTile - 1);  // a tile at row >= x sees a key
    if (x > 0) t0 = (x + kBTile - 1) / kBTile;
  }
  const int n = max(0, (Lq + kBTile - 1) / kBTile - t0);
  auto issue = [&](int j) {  // query tile t0 + j into stage j % kStages
    const int r0 = (t0 + j) * kBTile, sl = j % kStages;
    T* dst = ring + sl * kStage;
    ring_rows<kDp, kRs>(q, sq, r0, D, dst);
    ring_rows<kDp, kRs>(dout, sq, r0, D, dst + kBTile * kRs);
    ring_stats(lse, delta, bh, H, Lq, r0, st_r + sl * 2 * kBTile);
  };
  auto convert = [&](int j) {  // landed tile j into bf16 buffer j & 1
    const int r0 = (t0 + j) * kBTile, sl = j % kStages;
    const T* src = ring + sl * kStage;
    bf16* dst = qd_b + (j & 1) * 2 * kBTile * kDp;
    ring_to_blocked<kDp, kRs>(src, D, dst);
    ring_to_blocked<kDp, kRs>(src + kBTile * kRs, D, dst + kBTile * kDp);
    fence_async_smem();
    // lse as lse * log2(e), +inf (P = 0) for a row past the end or one
    // that saw no key; delta 0 past the end
    const int i = threadIdx.x;
    if (i < 2 * kBTile) {
      const bool ok = r0 + i % kBTile < Lq;
      const float x = st_r[sl * 2 * kBTile + i];
      st_b[(j & 1) * 2 * kBTile + i] =
          i < kBTile ? (ok && x > kNeg / 2 ? x * kLog2e : __int_as_float(0x7f800000))
                     : (ok ? x : 0.f);
    }
  };

#pragma unroll
  for (int j = 0; j < kStages; ++j) {
    if (j < n) issue(j);
    cp_async_commit();
  }
  zero_smem(qd_b, 2 * kTb * 2);  // the bf16 tiles' columns D..kDp stay 0
  stage_bf16<kBThreads, 8, kDp>(k, sk, c0, kBRows, D, kDp, k_s, 0);
  stage_bf16<kBThreads, 8, kDp>(v, sk, c0, kBRows, D, kDp, v_s, 0);
  fence_async_smem();
  const float scale2 = scale * kLog2e;
  // this warpgroup's 64 rows of K and V (wgmma's A operand)
  const uint32_t ka = smem_addr(k_s) + (warp >> 2) * 8 * kG;
  const uint32_t va = smem_addr(v_s) + (warp >> 2) * 8 * kG;
  const uint32_t qd0 = smem_addr(qd_b);
  cp_async_wait<kStages - 1>();
  __syncthreads();
  if (n > 0) convert(0);

  float dka[NT * 4], dva[NT * 4];
#pragma unroll
  for (int i = 0; i < NT * 4; ++i) dka[i] = dva[i] = 0.f;

  for (int j = 0; j < n; ++j) {
    cp_async_wait<kStages - 2>();
    wg_wait();
    __syncthreads();  // as in B6
    if (j + kStages < n) issue(j + kStages);
    cp_async_commit();

    const uint32_t qb = qd0 + (j & 1) * 2 * kTb, dob = qb + kTb;
    // transposed scores: rows are this warp's keys, columns the tile's queries
    float st[kBTile / 2], dpt[kBTile / 2];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kDp / 16; ++ks) {
      wgmma_n32_ss(st, mdesc(ka + ks * 256, 128, kG), mdesc(qb + ks * 256, 128, kG), ks > 0);
      wgmma_n32_ss(dpt, mdesc(va + ks * 256, 128, kG), mdesc(dob + ks * 256, 128, kG), ks > 0);
    }
    wg_commit();
    if (j + 1 < n) convert(j + 1);
    wg_wait();
    fence_regs(st);
    fence_regs(dpt);
    const float* lse_b = st_b + (j & 1) * 2 * kBTile;
    const float* delta_b = lse_b + kBTile;
    const int r0 = (t0 + j) * kBTile;
    // a tile that crosses this warp's causal diagonal masks by position;
    // rows past the end have lse2 = +inf
    const bool edge = causal && k_off + c0 + wr + 15 > q_off + r0;
#pragma unroll
    for (int jj = 0; jj < kBTile / 8; ++jj) {
      // this thread's two query columns of n-tile jj
      const float2 l2 = *reinterpret_cast<const float2*>(lse_b + jj * 8 + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(delta_b + jj * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * jj + e, r = e >> 1, i = jj * 8 + 2 * t + (e & 1);
        float p = ex2(__fmaf_rn(st[x], scale2, -(e & 1 ? l2.y : l2.x)));
        if (edge && kpos[r] > q_off + r0 + i) p = 0.f;
        st[x] = p;                                        // P^T
        dpt[x] = p * (dpt[x] - (e & 1 ? d2.y : d2.x));  // dS^T
      }
    }
    uint32_t pa[kBTile / 16][4], sa[kBTile / 16][4];  // P^T and dS^T as A operands
#pragma unroll
    for (int kk = 0; kk < kBTile / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        pa[kk][x] = pack_bf16(st[8 * kk + 2 * x], st[8 * kk + 2 * x + 1]);
        sa[kk][x] = pack_bf16(dpt[8 * kk + 2 * x], dpt[8 * kk + 2 * x + 1]);
      }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBTile / 16; ++kk) {
      wgmma_nd_rs_t<NT>(dva, pa[kk], mdesc(dob + kk * 2 * kG, kG, 128));
      wgmma_nd_rs_t<NT>(dka, sa[kk], mdesc(qb + kk * 2 * kG, kG, 128));
    }
    wg_commit();
  }
  cp_async_wait<0>();
  wg_wait();
  fence_regs(dka);
  fence_regs(dva);
  store_pairs<T, NT>(dk, sk, c0 + wr, D, dka, scale, lane);
  store_pairs<T, NT>(dv, sk, c0 + wr, D, dva, 1.f, lane);
}

// ---------------------------------------------------------------------------
// "highest": f32 operands, f32 FMA, one thread per owned row
// ---------------------------------------------------------------------------

__device__ __forceinline__ float dot_f32(const float* a, const float* b, int D) {
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kRows)
fwd_f32_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ out, float* __restrict__ lse, int H, int Lq, int Lk, int D,
               float scale, int causal, int q_off, int k_off) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldr = D + 1;  // odd stride: a thread's own row, conflict-free
  float* q_s = reinterpret_cast<float*>(smem);  // [kRows][ldr]
  float* acc_s = q_s + kRows * ldr;             // [kRows][ldr]
  float* k_s = acc_s + kRows * ldr;             // [kTileF][D]
  float* v_s = k_s + kTileF * D;                // [kTileF][D]
  const int bh = blockIdx.y, q0 = blockIdx.x * kRows, r = threadIdx.x;
  const Seq sq = seq_of(bh, H, Lq, D), sk = seq_of(bh, H, Lk, D);
  const int pos = q_off + q0 + r;
  stage_f32(q, sq, q0, kRows, D, q_s, ldr);
  float* qr = q_s + r * ldr;
  float* ar = acc_s + r * ldr;
  for (int d = 0; d < D; ++d) ar[d] = 0.f;
  float m = kNeg, l = 0.f;

  for (int c0 = 0; c0 < Lk; c0 += kTileF) {
    if (causal && q_off + q0 + kRows - 1 < k_off + c0) break;
    __syncthreads();
    stage_f32(k, sk, c0, kTileF, D, k_s, D);
    stage_f32(v, sk, c0, kTileF, D, v_s, D);
    __syncthreads();
    float s[kTileF];
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < kTileF; ++j) {
      const int c = c0 + j;
      const bool ok = c < Lk && (!causal || k_off + c <= pos);
      s[j] = ok ? dot_f32(qr, k_s + j * D, D) * scale : kNeg;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    m = m_new;
    l *= corr;
#pragma unroll
    for (int j = 0; j < kTileF; ++j) {
      const int c = c0 + j;
      const bool ok = c < Lk && (!causal || k_off + c <= pos);
      s[j] = ok ? expf(s[j] - m) : 0.f;
      l += s[j];
    }
    for (int d = 0; d < D; ++d) {
      float a = ar[d] * corr;
#pragma unroll
      for (int j = 0; j < kTileF; ++j) a = fmaf(s[j], v_s[j * D + d], a);
      ar[d] = a;
    }
  }
  if (q0 + r < Lq) {
    const float lc = fmaxf(l, 1e-30f);
    for (int d = 0; d < D; ++d) out[sq.base + (q0 + r) * sq.stride + d] = from_f32<T>(ar[d] / lc);
    const int b = bh / H, h = bh - b * H;
    lse[(static_cast<int64_t>(b) * Lq + q0 + r) * H + h] = l > 0.f ? m + logf(lc) : kNeg;
  }
}

template <typename T>
__global__ void __launch_bounds__(kRows)
bwd_dq_f32_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq, int H, int Lq, int Lk,
                  int D, float scale, int causal, int q_off, int k_off) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldr = D + 1;
  float* q_s = reinterpret_cast<float*>(smem);  // [kRows][ldr]
  float* do_s = q_s + kRows * ldr;              // [kRows][ldr]
  float* dq_s = do_s + kRows * ldr;             // [kRows][ldr]
  float* k_s = dq_s + kRows * ldr;              // [kTileF][D]
  float* v_s = k_s + kTileF * D;                // [kTileF][D]
  float* lse_s = v_s + kTileF * D;              // [kRows]
  float* delta_s = lse_s + kRows;               // [kRows]
  const int bh = blockIdx.y, q0 = blockIdx.x * kRows, r = threadIdx.x;
  const Seq sq = seq_of(bh, H, Lq, D), sk = seq_of(bh, H, Lk, D);
  const int pos = q_off + q0 + r;
  stage_f32(q, sq, q0, kRows, D, q_s, ldr);
  stage_f32(dout, sq, q0, kRows, D, do_s, ldr);
  stage_rows(lse, delta, bh, H, Lq, q0, kRows, lse_s, delta_s);
  __syncthreads();
  const float* qr = q_s + r * ldr;
  const float* dor = do_s + r * ldr;
  float* ar = dq_s + r * ldr;
  for (int d = 0; d < D; ++d) ar[d] = 0.f;
  const float lr = lse_s[r], dl = delta_s[r];

  for (int c0 = 0; c0 < Lk; c0 += kTileF) {
    if (causal && q_off + q0 + kRows - 1 < k_off + c0) break;
    __syncthreads();
    stage_f32(k, sk, c0, kTileF, D, k_s, D);
    stage_f32(v, sk, c0, kTileF, D, v_s, D);
    __syncthreads();
    float ds[kTileF];
#pragma unroll
    for (int j = 0; j < kTileF; ++j) {
      const int c = c0 + j;
      const bool ok = c < Lk && (!causal || k_off + c <= pos) && lr > kNeg / 2;
      const float p = ok ? expf(dot_f32(qr, k_s + j * D, D) * scale - lr) : 0.f;
      ds[j] = p * (dot_f32(dor, v_s + j * D, D) - dl);
    }
    for (int d = 0; d < D; ++d) {
      float a = ar[d];
#pragma unroll
      for (int j = 0; j < kTileF; ++j) a = fmaf(ds[j], k_s[j * D + d], a);
      ar[d] = a;
    }
  }
  if (q0 + r < Lq)
    for (int d = 0; d < D; ++d) dq[sq.base + (q0 + r) * sq.stride + d] = from_f32<T>(ar[d] * scale);
}

template <typename T>
__global__ void __launch_bounds__(kRows)
bwd_dkv_f32_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                   int H, int Lq, int Lk, int D, float scale, int causal, int q_off, int k_off) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldr = D + 1;
  float* k_s = reinterpret_cast<float*>(smem);  // [kRows][ldr]
  float* v_s = k_s + kRows * ldr;               // [kRows][ldr]
  float* dk_s = v_s + kRows * ldr;              // [kRows][ldr]
  float* dv_s = dk_s + kRows * ldr;             // [kRows][ldr]
  float* q_s = dv_s + kRows * ldr;              // [kTileF][D]
  float* do_s = q_s + kTileF * D;               // [kTileF][D]
  float* lse_s = do_s + kTileF * D;             // [kTileF]
  float* delta_s = lse_s + kTileF;              // [kTileF]
  const int bh = blockIdx.y, c0 = blockIdx.x * kRows, r = threadIdx.x;
  const Seq sq = seq_of(bh, H, Lq, D), sk = seq_of(bh, H, Lk, D);
  const int kpos = k_off + c0 + r;
  stage_f32(k, sk, c0, kRows, D, k_s, ldr);
  stage_f32(v, sk, c0, kRows, D, v_s, ldr);
  const float* kr = k_s + r * ldr;
  const float* vr = v_s + r * ldr;
  float* dkr = dk_s + r * ldr;
  float* dvr = dv_s + r * ldr;
  for (int d = 0; d < D; ++d) dkr[d] = dvr[d] = 0.f;

  for (int r0 = 0; r0 < Lq; r0 += kTileF) {
    if (causal && q_off + r0 + kTileF - 1 < k_off + c0) continue;
    __syncthreads();
    stage_f32(q, sq, r0, kTileF, D, q_s, D);
    stage_f32(dout, sq, r0, kTileF, D, do_s, D);
    stage_rows(lse, delta, bh, H, Lq, r0, kTileF, lse_s, delta_s);
    __syncthreads();
    float p[kTileF], ds[kTileF];
#pragma unroll
    for (int i = 0; i < kTileF; ++i) {
      const float li = lse_s[i];
      const bool ok = (!causal || kpos <= q_off + r0 + i) && li > kNeg / 2;
      p[i] = ok ? expf(dot_f32(q_s + i * D, kr, D) * scale - li) : 0.f;
      ds[i] = p[i] * (dot_f32(do_s + i * D, vr, D) - delta_s[i]);
    }
    for (int d = 0; d < D; ++d) {
      float a = dvr[d], b = dkr[d];
#pragma unroll
      for (int i = 0; i < kTileF; ++i) {
        a = fmaf(p[i], do_s[i * D + d], a);
        b = fmaf(ds[i], q_s[i * D + d], b);
      }
      dvr[d] = a;
      dkr[d] = b;
    }
  }
  if (c0 + r < Lk)
    for (int d = 0; d < D; ++d) {
      dk[sk.base + (c0 + r) * sk.stride + d] = from_f32<T>(dkr[d] * scale);
      dv[sk.base + (c0 + r) * sk.stride + d] = from_f32<T>(dvr[d]);
    }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Shape {
  int B, H, Lq, Lk, D, causal, q_off, k_off, highest;
  int Dp() const { return (D + 15) / 16 * 16; }
  dim3 grid(int rows, int per = kRows) const { return dim3((rows + per - 1) / per, B * H); }
};

// launch with `smem` bytes of dynamic shared memory (above 48 KB a kernel
// must opt in); returns the launch's error
template <typename K, typename... Args>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t st,
                   Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out, float* lse, Shape s,
                float scale, cudaStream_t st) {
  auto* tq = static_cast<const T*>(q);
  auto* tk = static_cast<const T*>(k);
  auto* tv = static_cast<const T*>(v);
  auto* to = static_cast<T*>(out);
  if (s.highest) {
    const dim3 grid = s.grid(s.Lq);
    const size_t smem = (2 * kRows * (s.D + 1) + 2 * kTileF * s.D) * sizeof(float);
    return launch(fwd_f32_kernel<T>, grid, kRows, smem, st, tq, tk, tv, to, lse, s.H, s.Lq, s.Lk,
                  s.D, scale, s.causal, s.q_off, s.k_off);
  }
  const bool wide = s.Dp() > 64;
  const size_t smem = wide ? fwd_smem<16>(sizeof(T)) : fwd_smem<8>(sizeof(T));
  auto kernel = wide ? fwd_mma_kernel<T, 16> : fwd_mma_kernel<T, 8>;
  return launch(kernel, s.grid(s.Lq, kBRows), kBThreads, smem, st, tq, tk, tv, to, lse, s.H,
                s.Lq, s.Lk, s.D, scale, s.causal, s.q_off, s.k_off);
}

template <typename T>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, Shape s, float scale,
                   cudaStream_t st) {
  auto* tq = static_cast<const T*>(q);
  auto* tk = static_cast<const T*>(k);
  auto* tv = static_cast<const T*>(v);
  auto* tdo = static_cast<const T*>(dout);
  auto* tdq = static_cast<T*>(dq);
  if (s.highest) {
    const dim3 grid = s.grid(s.Lq);
    const size_t smem =
        (3 * kRows * (s.D + 1) + 2 * kTileF * s.D + 2 * kRows) * sizeof(float);
    return launch(bwd_dq_f32_kernel<T>, grid, kRows, smem, st, tq, tk, tv, tdo, lse, delta, tdq,
                  s.H, s.Lq, s.Lk, s.D, scale, s.causal, s.q_off, s.k_off);
  }
  const bool wide = s.Dp() > 64;
  const size_t smem = wide ? dq_smem<16>(sizeof(T)) : dq_smem<8>(sizeof(T));
  auto kernel = wide ? bwd_dq_mma_kernel<T, 16> : bwd_dq_mma_kernel<T, 8>;
  return launch(kernel, s.grid(s.Lq, kBRows), kBThreads, smem, st, tq, tk, tv, tdo, lse, delta,
                tdq, s.H, s.Lq, s.Lk, s.D, scale, s.causal, s.q_off, s.k_off);
}

template <typename T>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, Shape s,
                    float scale, cudaStream_t st) {
  auto* tq = static_cast<const T*>(q);
  auto* tk = static_cast<const T*>(k);
  auto* tv = static_cast<const T*>(v);
  auto* tdo = static_cast<const T*>(dout);
  auto* tdk = static_cast<T*>(dk);
  auto* tdv = static_cast<T*>(dv);
  if (s.highest) {
    const dim3 grid = s.grid(s.Lk);
    const size_t smem =
        (4 * kRows * (s.D + 1) + 2 * kTileF * s.D + 2 * kTileF) * sizeof(float);
    return launch(bwd_dkv_f32_kernel<T>, grid, kRows, smem, st, tq, tk, tv, tdo, lse, delta, tdk,
                  tdv, s.H, s.Lq, s.Lk, s.D, scale, s.causal, s.q_off, s.k_off);
  }
  const bool wide = s.Dp() > 64;
  const size_t smem = wide ? dkv_smem<16>(sizeof(T)) : dkv_smem<8>(sizeof(T));
  auto kernel = wide ? bwd_dkv_mma_kernel<T, 16> : bwd_dkv_mma_kernel<T, 8>;
  return launch(kernel, s.grid(s.Lk, kBRows), kBThreads, smem, st, tq, tk, tv, tdo, lse, delta,
                tdk, tdv, s.H, s.Lq, s.Lk, s.D, scale, s.causal, s.q_off, s.k_off);
}

}  // namespace

extern "C" {

// is_bf16: inputs and outputs in bf16 (else f32); lse and delta are f32
int flash_fwd_launch(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                     int H, int Lq, int Lk, int D, int causal, int q_off, int k_off,
                     int highest, int is_bf16, float scale, void* stream) {
  const Shape s{B, H, Lq, Lk, D, causal, q_off, k_off, highest};
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  return static_cast<int>(is_bf16 ? fwd<bf16>(q, k, v, out, l, s, scale, st)
                                  : fwd<float>(q, k, v, out, l, s, scale, st));
}

int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int B, int H, int Lq,
                        int Lk, int D, int causal, int q_off, int k_off, int highest,
                        int is_bf16, float scale, void* stream) {
  const Shape s{B, H, Lq, Lk, D, causal, q_off, k_off, highest};
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<const float*>(delta);
  return static_cast<int>(is_bf16 ? bwd_dq<bf16>(q, k, v, dout, l, dl, dq, s, scale, st)
                                  : bwd_dq<float>(q, k, v, dout, l, dl, dq, s, scale, st));
}

int flash_bwd_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                         int Lq, int Lk, int D, int causal, int q_off, int k_off, int highest,
                         int is_bf16, float scale, void* stream) {
  const Shape s{B, H, Lq, Lk, D, causal, q_off, k_off, highest};
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<const float*>(delta);
  return static_cast<int>(is_bf16 ? bwd_dkv<bf16>(q, k, v, dout, l, dl, dk, dv, s, scale, st)
                                  : bwd_dkv<float>(q, k, v, dout, l, dl, dk, dv, s, scale, st));
}

}  // extern "C"
