// Copy-shape probe for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU probe tools/probe_dma_shapes.py:make_probe (its
// inner `kernel`). Same function: copy row src[idx] of a table in device
// memory into on-chip memory with an asynchronous copy, wait for it, and
// write the row's first n_out (<= 32) floats:
//   out[0, :] = src[idx].reshape(-1)[:n_out]
// The TPU kernel asks which row shapes its DMA engine accepts; on Hopper
// the counterpart of pltpu.make_async_copy and its DMA semaphore is the 1-D
// bulk asynchronous copy (cp.async.bulk, the Tensor Memory Accelerator's
// non-tensor form) completing on an mbarrier in shared memory. A bulk copy
// needs a 16-byte aligned source and destination and a size that is a
// multiple of 16 bytes; the launcher refuses other rows. idx is clipped to
// [0, n_rows - 1].
//
// What bounds it: one row of at most a few KB and 8 floats out; a launch,
// the copy's latency and the mbarrier wait are all it costs.
//
// Design: one CTA of 32 threads. Thread 0 initialises the mbarrier for one
// arrival, arms it with the row's byte count (arrive.expect_tx) and issues
// the copy; the copy's completion decrements the transaction count and
// completes phase 0. Every thread waits on phase 0 (try_wait.parity 0),
// then the first n_out threads each write one float.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;
// the default dynamic shared memory limit, less the mbarrier's 16 bytes
constexpr int MAX_ROW_BYTES = 48 * 1024 - 16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(THREADS)
    probe_copy_kernel(const float* __restrict__ src,
                      const int32_t* __restrict__ idx,
                      float* __restrict__ out, int n_rows, int row_floats,
                      int n_out) {
  // dynamic shared memory only, so the row starts at the (aligned) base of
  // the CTA's window; the mbarrier follows it at a 16-byte multiple
  extern __shared__ __align__(128) float row[];
  const uint32_t bar_addr = smem_addr(row + row_floats);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_addr)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int i = min(max(idx[0], 0), n_rows - 1);
    const uint32_t bytes = static_cast<uint32_t>(row_floats) * 4u;
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            bar_addr),
        "r"(bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(row)),
        "l"(src + static_cast<int64_t>(i) * row_floats), "r"(bytes),
        "r"(bar_addr)
        : "memory");
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar_addr), "r"(0u)
        : "memory");
  }
  if (static_cast<int>(threadIdx.x) < n_out) out[threadIdx.x] = row[threadIdx.x];
}

}  // namespace

// src (n_rows, row_floats) f32 contiguous, idx (1,) int32, out (1, n_out)
// f32, on one device. Returns the cudaError_t of the launch (0 on success).
extern "C" int persia_probe_copy(const void* src, const void* idx, void* out,
                                 int n_rows, int row_floats, int n_out,
                                 void* stream) {
  const int64_t row_bytes = static_cast<int64_t>(row_floats) * 4;
  if (n_rows <= 0 || row_floats <= 0 || n_out <= 0 || n_out > THREADS ||
      n_out > row_floats || row_bytes % 16 != 0 ||
      row_bytes > MAX_ROW_BYTES ||
      reinterpret_cast<uintptr_t>(src) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  probe_copy_kernel<<<1, THREADS, static_cast<size_t>(row_bytes) + 16,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), n_rows, row_floats, n_out);
  return (int)cudaGetLastError();
}

extern "C" const char* persia_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
