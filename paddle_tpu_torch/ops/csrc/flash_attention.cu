// flash_attention: blockwise softmax attention, forward and backward, on
// Hopper (sm_90a).
//
// Replaces the Pallas kernels of paddle_tpu/ops/flash_attention.py:
//
// - B5 forward (_fwd / _fwd_kernel): S = Q K^T * scale, masked by the key
//   length and, when causal, by position (q_offset + i >= k_offset + j);
//   an online softmax (running max m and sum l, corr = exp(m_prev - m_new))
//   over key tiles; O = P V / l and the per-row log-sum-exp
//   lse = m + log(l) (NEG when a row saw no key).
// - B6 backward dQ (_bwd_dq_kernel): P = exp(S - lse) recomputed,
//   dP = dO V^T, dS = P * (dP - delta), dQ = dS K * scale.
// - B7 backward dK/dV (_bwd_dkv_kernel): dV = P^T dO, dK = dS^T Q * scale.
//   Separate from dQ, as in the JAX package: each output row belongs to
//   one block, so there are no atomics and the gradients are the same
//   from run to run.
//
// The TPU grid's sequential key axis ("arbitrary") becomes a loop inside
// one thread block, and the VMEM scratch accumulators become registers.
// One block owns 64 rows (query rows for B5 and B6, key rows for B7) of
// one (batch, head) and streams the other side in 64-row tiles through
// shared memory. Inputs are read in place in the [B, L, H, D] layout
// (row stride H*D), so no transpose runs around the kernels.
//
// precision "default" (ERNIE's): operands rounded to bf16 (__float2bfloat16_rn,
// the rounding of JAX's astype), products on the tensor cores with
// mma.sync.m16n8k16 bf16 -> f32, the scale applied after the product,
// P and dS rounded to bf16 before their products, everything else f32.
// Four warps per block, 16 rows each. The S accumulator fragment is
// reused as the A operand of the next product (FlashAttention-2's
// register layout), so P and dS never touch shared memory. Every tile is
// staged row-major as bf16 (four elements a thread, several loads in
// flight); fragments load with ldmatrix, and the products that need a
// tile transposed (P V, dS K, P^T dO, dS^T Q) read it through
// ldmatrix .trans. Shared rows are padded by 8 bf16 so those loads are
// free of bank conflicts.
// precision "highest": f32 operands and f32 FMA, never TF32, one thread
// per owned row (tests and parity checks only).
//
// Bound at the ERNIE shape (B*H = 128, L = 512, D = 64, f32 in): HBM
// bytes, 67/84/101 MB for B5/B6/B7 (0.020/0.025/0.030 ms at 3.35 TB/s)
// against 8.6/12.9/17.2 GFLOP bf16 (0.009/0.013/0.017 ms at 989 TFLOP/s).
// This first version stages tiles with plain loads and multiplies with
// mma.sync; TMA, wgmma and loads overlapped with the math are later work.
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
constexpr int kRows = 64;        // rows a block owns
constexpr int kTile = 64;        // rows streamed per step (mma path)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;          // bf16 padding of a shared row
constexpr int kTileF = 32;       // rows streamed per step (f32 path)

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
// [n][ld]; rows past the end and columns past D are zeros. Each thread
// moves four elements at a time and issues kBatch loads before it stores
// any, so the copy pays the memory latency once per kBatch loads instead
// of once per element.
template <typename T>
__device__ void stage_bf16(const T* __restrict__ src, Seq s, int r0, int n, int D, int Dp,
                           bf16* dst, int ld) {
  constexpr int kBatch = 4;
  const int per_row = Dp >> 2, total = n * per_row;
  for (int base = threadIdx.x; base < total; base += kBatch * kThreads) {
    float4 x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads, r = idx / per_row, d = (idx - r * per_row) * 4;
      x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < total && r0 + r < s.len && d < D)
        x[u] = load4(src + s.base + (r0 + r) * s.stride + d);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads, r = idx / per_row, d = (idx - r * per_row) * 4;
      if (idx < total)
        *reinterpret_cast<uint2*>(dst + r * ld + d) =
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

__device__ __forceinline__ uint32_t smem_addr(const bf16* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// c += a * b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment: the 16x16 block at (r0, k0) of a row-major [rows][ld] array.
// ldmatrix .x4: lanes 0-15 address rows r0..r0+15 at column k0, lanes
// 16-31 the same rows at k0 + 8 (the four 8x8 quarters in a0..a3 order).
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* x, int ld, int r0, int k0,
                                       int lane) {
  const bf16* p = x + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(p))
               : "memory");
}

// B fragment (k 16 x n 8) of B[k][n] = y[n][k], y row-major [n][ld], at
// (k0, n0): lanes 0-7 address rows n0..n0+7 at k0, lanes 8-15 at k0 + 8
__device__ __forceinline__ void load_b(uint32_t b[2], const bf16* y, int ld, int n0, int k0,
                                       int lane) {
  const bf16* p = y + (n0 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(smem_addr(p))
               : "memory");
}

// B fragment (k 16 x n 8) of B[k][n] = z[k][n], z row-major [k][ld], at
// (k0, n0): ldmatrix .trans over rows k0..k0+15, so no transposed copy of
// z is ever staged
__device__ __forceinline__ void load_b_trans(uint32_t b[2], const bf16* z, int ld, int k0,
                                             int n0, int lane) {
  const bf16* p = z + (k0 + (lane & 15)) * ld + n0;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(smem_addr(p))
               : "memory");
}

// s[8][4] = X[16 rows at r0] . Y[64 rows]^T over Dp columns: both operands
// row-major in shared memory (the rows of Y are the n index)
__device__ __forceinline__ void mma_xyt(float s[8][4], const bf16* x, const bf16* y, int ld,
                                        int r0, int Dp, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  for (int k0 = 0; k0 < Dp; k0 += 16) {
    uint32_t a[4];
    load_a(a, x, ld, r0, k0, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t b[2];
      load_b(b, y, ld, j * 8, k0, lane);
      mma_bf16(s[j], a, b);
    }
  }
}

// acc[n][4] += bf16(p)[16 x 64] . Z[64 x Dp], Z row-major ([64][ld]) in
// shared memory; p is the accumulator fragment of mma_xyt. NT is the
// accumulator's compile-time width in n-tiles of 8 (8 for D <= 64, 16 for
// D <= 128), nt = Dp / 8 the width in use
template <int NT>
__device__ __forceinline__ void mma_pz(float acc[NT][4], const float p[8][4], const bf16* z,
                                       int ld, int nt, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n < nt) {
        uint32_t b[2];
        load_b_trans(b, z, ld, kk * 16, n * 8, lane);
        mma_bf16(acc[n], a, b);
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// store the accumulator fragment rows (r0 + g, r0 + g + 8) x Dp of one
// (batch, head), times `mul`, divided by `div[2]`
template <typename T, int NT>
__device__ __forceinline__ void store_frag(T* __restrict__ dst, Seq s, int r0, int D, int nt,
                                           const float acc[NT][4], float mul,
                                           const float div[2], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= s.len) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n >= nt) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + 2 * t + e;
        if (d < D) dst[s.base + row * s.stride + d] = from_f32<T>(acc[n][2 * r + e] * mul / div[r]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B5, forward, tensor cores
// ---------------------------------------------------------------------------

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ out, float* __restrict__ lse, int H, int Lq, int Lk, int D, int Dp,
               float scale, int causal, int q_off, int k_off) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = Dp + kPad;
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kRows][ld]
  bf16* k_s = q_s + kRows * ld;               // [kTile][ld]
  bf16* v_s = k_s + kTile * ld;               // [kTile][ld]
  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const Seq sq = seq_of(bh, H, Lq, D), sk = seq_of(bh, H, Lk, D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp * 16, nt = Dp / 8;
  const int pos[2] = {q_off + q0 + wr + g, q_off + q0 + wr + g + 8};

  stage_bf16(q, sq, q0, kRows, D, Dp, q_s, ld);

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // l: this thread's columns only

  for (int c0 = 0; c0 < Lk; c0 += kTile) {
    // causal tile skip: this and every later tile lies in the future
    if (causal && q_off + q0 + kRows - 1 < k_off + c0) break;
    __syncthreads();
    stage_bf16(k, sk, c0, kTile, D, Dp, k_s, ld);
    stage_bf16(v, sk, c0, kTile, D, Dp, v_s, ld);
    __syncthreads();

    float s[8][4];
    mma_xyt(s, q_s, k_s, ld, wr, Dp, lane);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = c0 + j * 8 + 2 * t + (e & 1);
        const bool ok = c < Lk && (!causal || k_off + c <= pos[r]);
        s[j][e] = ok ? s[j][e] * scale : kNeg;
        mx[r] = fmaxf(mx[r], s[j][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = expf(m[r] - m_new);  // m = NEG -> 0
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = c0 + j * 8 + 2 * t + (e & 1);
        const bool ok = c < Lk && (!causal || k_off + c <= pos[r]);
        s[j][e] = ok ? expf(s[j][e] - m[r]) : 0.f;
        l[r] += s[j][e];
      }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
    mma_pz<NT>(acc, s, v_s, ld, nt, lane);
  }

  float ltot[2], lsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ltot[r] = quad_sum(l[r]);
    lsum[r] = fmaxf(ltot[r], 1e-30f);
  }
  store_frag<T, NT>(out, sq, q0 + wr, D, nt, acc, 1.f, lsum, lane);
  if (t == 0) {
    const int b = bh / H, h = bh - b * H;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wr + g + 8 * r;
      if (row < Lq)
        lse[(static_cast<int64_t>(b) * Lq + row) * H + h] =
            ltot[r] > 0.f ? m[r] + logf(lsum[r]) : kNeg;
    }
  }
}

// ---------------------------------------------------------------------------
// B6, backward dQ, tensor cores
// ---------------------------------------------------------------------------

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq, int H, int Lq, int Lk,
                  int D, int Dp, float scale, int causal, int q_off, int k_off) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = Dp + kPad;
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kRows][ld]
  bf16* do_s = q_s + kRows * ld;              // [kRows][ld]
  bf16* k_s = do_s + kRows * ld;              // [kTile][ld]
  bf16* v_s = k_s + kTile * ld;               // [kTile][ld]
  float* lse_s = reinterpret_cast<float*>(v_s + kTile * ld);  // [kRows]
  float* delta_s = lse_s + kRows;                            // [kRows]
  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const Seq sq = seq_of(bh, H, Lq, D), sk = seq_of(bh, H, Lk, D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp * 16, nt = Dp / 8;
  const int pos[2] = {q_off + q0 + wr + g, q_off + q0 + wr + g + 8};

  stage_bf16(q, sq, q0, kRows, D, Dp, q_s, ld);
  stage_bf16(dout, sq, q0, kRows, D, Dp, do_s, ld);
  stage_rows(lse, delta, bh, H, Lq, q0, kRows, lse_s, delta_s);
  __syncthreads();
  const float lse_r[2] = {lse_s[wr + g], lse_s[wr + g + 8]};
  const float delta_r[2] = {delta_s[wr + g], delta_s[wr + g + 8]};

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int c0 = 0; c0 < Lk; c0 += kTile) {
    if (causal && q_off + q0 + kRows - 1 < k_off + c0) break;
    __syncthreads();
    stage_bf16(k, sk, c0, kTile, D, Dp, k_s, ld);
    stage_bf16(v, sk, c0, kTile, D, Dp, v_s, ld);
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_xyt(s, q_s, k_s, ld, wr, Dp, lane);
    mma_xyt(dp, do_s, v_s, ld, wr, Dp, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = c0 + j * 8 + 2 * t + (e & 1);
        const bool ok = c < Lk && (!causal || k_off + c <= pos[r]) && lse_r[r] > kNeg / 2;
        const float p = ok ? expf(s[j][e] * scale - lse_r[r]) : 0.f;
        s[j][e] = p * (dp[j][e] - delta_r[r]);  // dS
      }
    mma_pz<NT>(acc, s, k_s, ld, nt, lane);
  }
  const float one[2] = {1.f, 1.f};
  store_frag<T, NT>(dq, sq, q0 + wr, D, nt, acc, scale, one, lane);
}

// ---------------------------------------------------------------------------
// B7, backward dK and dV, tensor cores
// ---------------------------------------------------------------------------

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                   int H, int Lq, int Lk, int D, int Dp, float scale, int causal, int q_off,
                   int k_off) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = Dp + kPad;
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [kRows][ld], resident
  bf16* v_s = k_s + kRows * ld;               // [kRows][ld], resident
  bf16* q_s = v_s + kRows * ld;               // [kTile][ld]
  bf16* do_s = q_s + kTile * ld;              // [kTile][ld]
  float* lse_s = reinterpret_cast<float*>(do_s + kTile * ld);  // [kTile]
  float* delta_s = lse_s + kTile;                             // [kTile]
  const int bh = blockIdx.y, c0 = blockIdx.x * kRows;
  const Seq sq = seq_of(bh, H, Lq, D), sk = seq_of(bh, H, Lk, D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp * 16, nt = Dp / 8;
  const int kpos[2] = {k_off + c0 + wr + g, k_off + c0 + wr + g + 8};

  stage_bf16(k, sk, c0, kRows, D, Dp, k_s, ld);
  stage_bf16(v, sk, c0, kRows, D, Dp, v_s, ld);

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int r0 = 0; r0 < Lq; r0 += kTile) {
    // causal: a query tile wholly before this key block sees none of it
    if (causal && q_off + r0 + kTile - 1 < k_off + c0) continue;
    __syncthreads();
    stage_bf16(q, sq, r0, kTile, D, Dp, q_s, ld);
    stage_bf16(dout, sq, r0, kTile, D, Dp, do_s, ld);
    stage_rows(lse, delta, bh, H, Lq, r0, kTile, lse_s, delta_s);
    __syncthreads();

    // transposed scores: rows are this warp's keys, columns the tile's queries
    float st[8][4], dpt[8][4];
    mma_xyt(st, k_s, q_s, ld, wr, Dp, lane);
    mma_xyt(dpt, v_s, do_s, ld, wr, Dp, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, i = j * 8 + 2 * t + (e & 1);
        const float li = lse_s[i];
        const bool ok = (!causal || kpos[r] <= q_off + r0 + i) && li > kNeg / 2;
        const float p = ok ? expf(st[j][e] * scale - li) : 0.f;
        st[j][e] = p;                             // P^T
        dpt[j][e] = p * (dpt[j][e] - delta_s[i]);  // dS^T
      }
    mma_pz<NT>(dva, st, do_s, ld, nt, lane);
    mma_pz<NT>(dka, dpt, q_s, ld, nt, lane);
  }
  const float one[2] = {1.f, 1.f};
  store_frag<T, NT>(dk, sk, c0 + wr, D, nt, dka, scale, one, lane);
  store_frag<T, NT>(dv, sk, c0 + wr, D, nt, dva, 1.f, one, lane);
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
  int ld() const { return Dp() + kPad; }
  dim3 grid(int rows) const { return dim3((rows + kRows - 1) / kRows, B * H); }
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
  const dim3 grid = s.grid(s.Lq);
  if (s.highest) {
    const size_t smem = (2 * kRows * (s.D + 1) + 2 * kTileF * s.D) * sizeof(float);
    return launch(fwd_f32_kernel<T>, grid, kRows, smem, st, tq, tk, tv, to, lse, s.H, s.Lq, s.Lk,
                  s.D, scale, s.causal, s.q_off, s.k_off);
  }
  const size_t smem = (kRows + 2 * kTile) * s.ld() * sizeof(bf16);
  auto kernel = s.Dp() <= 64 ? fwd_mma_kernel<T, 8> : fwd_mma_kernel<T, 16>;
  return launch(kernel, grid, kThreads, smem, st, tq, tk, tv, to, lse, s.H, s.Lq, s.Lk, s.D,
                s.Dp(), scale, s.causal, s.q_off, s.k_off);
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
  const dim3 grid = s.grid(s.Lq);
  if (s.highest) {
    const size_t smem =
        (3 * kRows * (s.D + 1) + 2 * kTileF * s.D + 2 * kRows) * sizeof(float);
    return launch(bwd_dq_f32_kernel<T>, grid, kRows, smem, st, tq, tk, tv, tdo, lse, delta, tdq,
                  s.H, s.Lq, s.Lk, s.D, scale, s.causal, s.q_off, s.k_off);
  }
  const size_t smem = (2 * kRows + 2 * kTile) * s.ld() * sizeof(bf16) + 2 * kRows * sizeof(float);
  auto kernel = s.Dp() <= 64 ? bwd_dq_mma_kernel<T, 8> : bwd_dq_mma_kernel<T, 16>;
  return launch(kernel, grid, kThreads, smem, st, tq, tk, tv, tdo, lse, delta, tdq, s.H, s.Lq,
                s.Lk, s.D, s.Dp(), scale, s.causal, s.q_off, s.k_off);
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
  const dim3 grid = s.grid(s.Lk);
  if (s.highest) {
    const size_t smem =
        (4 * kRows * (s.D + 1) + 2 * kTileF * s.D + 2 * kTileF) * sizeof(float);
    return launch(bwd_dkv_f32_kernel<T>, grid, kRows, smem, st, tq, tk, tv, tdo, lse, delta, tdk,
                  tdv, s.H, s.Lq, s.Lk, s.D, scale, s.causal, s.q_off, s.k_off);
  }
  const size_t smem = (2 * kRows + 2 * kTile) * s.ld() * sizeof(bf16) + 2 * kTile * sizeof(float);
  auto kernel = s.Dp() <= 64 ? bwd_dkv_mma_kernel<T, 8> : bwd_dkv_mma_kernel<T, 16>;
  return launch(kernel, grid, kThreads, smem, st, tq, tk, tv, tdo, lse, delta, tdk, tdv, s.H,
                s.Lq, s.Lk, s.D, s.Dp(), scale, s.causal, s.q_off, s.k_off);
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
