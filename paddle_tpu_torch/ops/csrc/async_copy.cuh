// async_copy.cuh: the asynchronous copies of Hopper (sm_90a) behind small
// device functions, so that a kernel source holds no PTX of its own.
//
// - A bulk copy (cp.async.bulk) moves one contiguous range from global
//   into shared memory, issued by one thread, and completes on an
//   mbarrier in shared memory that expects the copied bytes.
// - cp.async copies 4, 8 or 16 bytes from global into shared memory for
//   the issuing thread, which waits on its own copies.
//
// Addresses and sizes of a bulk copy must be multiples of 16 bytes; a
// cp.async copy of b bytes needs both addresses b-byte aligned.
// tests/test_torch_ctr_rows_emulated.py runs the kernels on the CPU with
// plain-memory versions of these functions.

#pragma once

#include <cstdint>

namespace async_copy {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The block's dynamic shared memory (16-byte aligned).
__device__ __forceinline__ unsigned char* dynamic_smem() {
  extern __shared__ __align__(16) unsigned char smem[];
  return smem;
}

// One thread: an mbarrier that completes when `count` threads have
// arrived and the expected bytes have landed; visible to the copy engine.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive on `bar` and expect `bytes` more to land in this phase.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until phase `phase` (0, 1, ...) of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
  }
}

// Bulk copy global -> shared of `bytes`, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// cp.async of B (4, 8 or 16) bytes global -> shared for this thread.
template <int B>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  static_assert(B == 4 || B == 8 || B == 16, "cp.async copies 4, 8 or 16 bytes");
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(B)
                 : "memory");
}

// Wait for all of this thread's cp.async copies.
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

}  // namespace async_copy
