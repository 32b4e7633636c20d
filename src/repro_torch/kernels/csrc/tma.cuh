// TMA and the mbarriers its copies complete on, shared by the flash and the
// scan kernels: the host's lookup of cuTensorMapEncodeTiled, and mbarrier
// init, arrive, arrive announcing TMA bytes, and wait.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                            void*, const cuuint64_t*, const cuuint64_t*,
                            const cuuint32_t*, const cuuint32_t*,
                            CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Host: cuTensorMapEncodeTiled, looked up once through the runtime's
// entry-point query, so no library links libcuda. Null where it is
// missing, with the CUDA error code in *err.
inline Encode encoder(int* err) {
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) {
      *err = (int)e;
      return nullptr;
    }
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      *err = (int)cudaErrorSymbolNotFound;
      return nullptr;
    }
    encode = reinterpret_cast<Encode>(fn);
  }
  return encode;
}

// mbarriers in shared memory, by their shared-memory address: init (one
// thread, then fence_barrier_init and a CTA barrier), arrive, arrive
// announcing a TMA copy's bytes, and wait for the completion of the phase
// of the given parity. A wait that outlasts 2^32 clocks (about 2 s) gives
// up, so that a lost arrival shows as a wrong result, not a hang.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done && clock64() - t0 < (1ll << 32));
}

}  // namespace tma
