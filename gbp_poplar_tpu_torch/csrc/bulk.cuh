// Hopper's one-dimensional bulk copies (cp.async.bulk, global -> shared)
// and the mbarriers that count their bytes, as inline PTX for sm_90a. A 1-D
// bulk copy needs no tensor map (and so no driver API): one thread names
// the source, the destination, the size and the barrier. Addresses and
// sizes must be multiples of 16 bytes; callers check and copy element by
// element otherwise. Also the launchers' per-device set-up: the SM count
// and the dynamic shared-memory opt-in of a kernel that stages through
// shared memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gbp {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// one arrival expected per phase (the thread that arms the barrier)
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// make the initialised barriers visible to the async proxy
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the arming thread's arrival, announcing ``bytes`` of copies to come
// (0: the phase completes at once)
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity ``parity`` has completed. A wrong parity
// would spin for ever; after 2^31 clock cycles (about a second) the kernel
// traps, so a fault surfaces as a launch error and not as a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 31)) __trap();
  }
}

// order this thread's earlier generic-proxy accesses of shared memory
// before its later bulk copies into it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// copy ``bytes`` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory; completion counts against ``bar``
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

constexpr int MAX_DEVICES = 64;

// the current device and its SM count, queried once per device
inline cudaError_t device_sms(int* dev, int* sms) {
  static int count[MAX_DEVICES] = {0};
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 0 || *dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (count[*dev] == 0) {
    err = cudaDeviceGetAttribute(&count[*dev],
                                 cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return err;
  }
  *sms = count[*dev];
  return cudaSuccess;
}

// let ``kernel`` take ``bytes`` of dynamic shared memory on device ``dev``;
// ``set`` (one per kernel) holds the largest size already allowed there
template <typename Kernel>
cudaError_t smem_opt_in(Kernel kernel, int bytes, int dev, int* set) {
  if (bytes <= set[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) set[dev] = bytes;
  return err;
}

}  // namespace gbp
