// Embedding bag (gather + weighted pool) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel persia_tpu/ops/embedding_bag.py:
// _packed_bag_kernel (driven by pallas_embedding_bag_packed). Same function:
//   out[b, :] = sum_s w[b, s] * table[clip(ids[b, s], 0, V - 1), :]
// over a (V, D) f32 table, (B, S) int32 ids and (B, S) f32 weights, giving
// (B, D) f32. The TPU kernel lane-packs the table into (ceil(V/P), 128) rows
// (P = 128 / D) because Mosaic cannot DMA a sub-(8, 128) row; that packing
// is TPU tiling only, so this kernel reads the plain (V, D) table, takes any
// D >= 1 and any B (no padding to 8 samples). Ids are clipped to [0, V - 1]:
// the Pallas kernel clips to its packed range, which is the same rule
// whenever P divides V.
//
// What bounds it on an H100 SXM (3.35 TB/s): it does 2 FLOP per 4-byte
// table element read, so it is bound by bytes, B * S * (4 D + 8) + 4 B D
// at most. At device mode's shape (B = 4096, S = 1, D = 16) that is
// ~0.5 MB, ~0.15 us: far below a launch, so each call is launch-bound.
//
// Design (simple and right first): one thread per output element (b, d).
// Consecutive threads hold consecutive d of one sample, so the D threads of
// a sample read one contiguous row and the warp's loads coalesce. Each
// thread walks s = 0 .. S-1 in order, rounding every product and every sum
// as the plain version does (no fused multiply-add), and writes its f32
// sum once: no atomics, no shared memory, deterministic. Vectorised loads,
// several slots in one launch and cp.async / TMA row staging are later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    embedding_bag_kernel(const float* __restrict__ table,
                         const int32_t* __restrict__ ids,
                         const float* __restrict__ weights,
                         float* __restrict__ out, int64_t n_out, int bag,
                         int dim, int vocab) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n_out) return;
  const int64_t b = i / dim;
  const int d = static_cast<int>(i - b * dim);
  const int32_t* row_ids = ids + b * bag;
  const float* row_w = weights + b * bag;
  float acc = 0.0f;
  for (int s = 0; s < bag; ++s) {
    const int id = min(max(row_ids[s], 0), vocab - 1);
    const float x = table[static_cast<int64_t>(id) * dim + d];
    acc = __fadd_rn(acc, __fmul_rn(row_w[s], x));
  }
  out[i] = acc;
}

}  // namespace

// table (vocab, dim) f32, ids (batch, bag) int32, weights (batch, bag) f32,
// out (batch, dim) f32, all contiguous on one device. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int persia_embedding_bag(const void* table, const void* ids,
                                    const void* weights, void* out, int batch,
                                    int bag, int dim, int vocab,
                                    void* stream) {
  if (batch <= 0 || bag <= 0 || dim <= 0 || vocab <= 0)
    return (int)cudaErrorInvalidValue;
  const int64_t n_out = static_cast<int64_t>(batch) * dim;
  const int64_t blocks = (n_out + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  embedding_bag_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(ids),
      static_cast<const float*>(weights), static_cast<float*>(out), n_out,
      bag, dim, vocab);
  return (int)cudaGetLastError();
}

extern "C" const char* persia_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
