// Flash-attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel persia_tpu/ops/flash_attention.py:_fwd_kernel
// (driven by flash_attention_fwd_pallas). Same function: online-softmax
// attention over (B*H, T, Dh) with scale 1/sqrt(Dh), f32 statistics and
// accumulation, mask value -1e30 (not -inf), keys past the true length
// masked, optional causal masking (k-tiles wholly above the diagonal are
// skipped), an optional (B, T_k) key mask broadcast over heads, and a
// fully masked query row giving 0, not NaN. Output in the input dtype.
// Optionally (the training path) it also writes the (B*H, T_q) f32
// logsumexp m + log(max(l, 1e-20)) that the backward kernels K3/K4 read;
// a fully masked row keeps m = -1e30, so its lse stays <= -1e30 / 2 and
// the backward forces its probabilities to 0. The serving path passes no
// lse buffer and writes nothing more, as the JAX kernel does.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s):
// at the attention-bench shape (B=4, H=8, T=8192, Dh=128, bf16, causal)
// the two products are ~5.5e11 FLOP, a 0.56 ms compute floor against
// ~0.27 GB of q/k/v/out, 0.08 ms of bytes: compute-bound. At the
// sequence-tower's serving shape (B=256, H=4, T=64, Dh=4, bf16) it moves
// ~2.1 MB (0.6 us) and does ~67 MFLOP (0.07 us): launch-bound.
//
// Design (simple and right first): one CTA of 256 threads owns one
// (batch*head, 64-row q-tile) pair and loops over 64-key k-tiles staged in
// shared memory as f32. Four threads share a query row: each scores 16 of
// the tile's keys, the row max and row sum are reduced with warp shuffles,
// the probabilities go through a per-row strip of shared memory, and each
// thread accumulates Dh/4 output columns in registers. The products run on
// the f32 CUDA cores, not the tensor cores; wgmma, TMA and warp
// specialisation are for a later change. Any Dh <= 128 is taken: the kernel
// is instantiated for padded widths 4..128 and zero-fills the padding
// columns, which leaves the scores unchanged (the scale uses the true Dh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // query rows per CTA
constexpr int BK = 64;            // keys per k-tile
constexpr int GROUP = 4;          // threads per query row
constexpr int NT = BQ * GROUP;    // threads per CTA
constexpr int KPT = BK / GROUP;   // keys each thread scores per tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int DHP>
constexpr size_t smem_bytes() {
  // q tile, k tile, v tile (rows padded by one float against bank
  // conflicts) and the per-row probability strips
  return sizeof(float) *
         (size_t)(BQ * (DHP + 1) + 2 * BK * (DHP + 1) + BQ * (BK + 1));
}

template <typename T, int DHP>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const uint8_t* __restrict__ kv_mask,
           T* __restrict__ out, float* __restrict__ lse, int heads, int t_q,
           int t_k, int dh, int causal, float scale) {
  static_assert(DHP % GROUP == 0, "padded head dim must divide by GROUP");
  constexpr int LD = DHP + 1;
  constexpr int LDP = BK + 1;
  constexpr int NACC = DHP / GROUP;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * LD;
  float* v_s = k_s + BK * LD;
  float* p_s = v_s + BK * LD;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int r = tid / GROUP;  // query row within the tile
  const int j = tid % GROUP;  // this thread's lane within the row's group
  const int qrow = q0 + r;
  const size_t q_base = (size_t)bh * t_q * dh;
  const size_t kv_base = (size_t)bh * t_k * dh;
  const uint8_t* mask_row =
      kv_mask != nullptr ? kv_mask + (size_t)(bh / heads) * t_k : nullptr;

  for (int idx = tid; idx < BQ * DHP; idx += NT) {
    const int rr = idx / DHP, d = idx % DHP;
    const int qi = q0 + rr;
    q_s[rr * LD + d] =
        (qi < t_q && d < dh) ? to_f32(q[q_base + (size_t)qi * dh + d]) : 0.f;
  }

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  float m = NEG_INF;  // running max of this row
  float l = 0.f;      // running sum of this row

  int n_k = (t_k + BK - 1) / BK;
  if (causal) {
    // tiles whose first key lies past the tile's last real query row
    // contribute nothing
    const int last_q = min(q0 + BQ, t_q) - 1;
    n_k = min(n_k, last_q / BK + 1);
  }

  for (int t = 0; t < n_k; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's k_s/v_s reads are done
    for (int idx = tid; idx < BK * DHP; idx += NT) {
      const int kk = idx / DHP, d = idx % DHP;
      const int kj = k0 + kk;
      const bool ok = kj < t_k && d < dh;
      const size_t off = kv_base + (size_t)kj * dh + d;
      k_s[kk * LD + d] = ok ? to_f32(k[off]) : 0.f;
      v_s[kk * LD + d] = ok ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int c = 0; c < KPT; ++c) s[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DHP; ++d) {
      const float qd = q_s[r * LD + d];
#pragma unroll
      for (int c = 0; c < KPT; ++c) s[c] += qd * k_s[(j + GROUP * c) * LD + d];
    }

    float m_tile = NEG_INF;
#pragma unroll
    for (int c = 0; c < KPT; ++c) {
      const int kj = k0 + j + GROUP * c;
      bool ok = kj < t_k;
      if (causal) ok = ok && qrow >= kj;
      if (mask_row != nullptr) ok = ok && mask_row[kj] != 0;
      s[c] = ok ? s[c] * scale : NEG_INF;
      m_tile = fmaxf(m_tile, s[c]);
    }
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 2));
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    // a row with no visible key yet has m_new == NEG_INF, where
    // exp(s - m_new) would be exp(0) = 1: keep its probabilities at 0
    const bool live = m_new > 0.5f * NEG_INF;
    float row_sum = 0.f;
#pragma unroll
    for (int c = 0; c < KPT; ++c) {
      const float p = live ? expf(s[c] - m_new) : 0.f;
      row_sum += p;
      p_s[r * LDP + j + GROUP * c] = p;
    }
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
    l = l * alpha + row_sum;
    m = m_new;
    __syncwarp();  // the row's strip is written and read by one warp

#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] *= alpha;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float p = p_s[r * LDP + kk];
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] += p * v_s[kk * LD + j + GROUP * i];
    }
    __syncwarp();
  }

  if (qrow < t_q) {
    const float denom = fmaxf(l, 1e-20f);
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int d = j + GROUP * i;
      if (d < dh) out[q_base + (size_t)qrow * dh + d] = from_f32<T>(acc[i] / denom);
    }
    // the row's four threads hold the same m and l after the shuffles
    if (lse != nullptr && j == 0)
      lse[(size_t)bh * t_q + qrow] = m + logf(denom);
  }
}

template <typename T, int DHP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_mask, void* out, float* lse, int bh,
                   int heads, int t_q, int t_k, int dh, int causal,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DHP>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fwd_kernel<T, DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(bh, (t_q + BQ - 1) / BQ);
  fwd_kernel<T, DHP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(kv_mask),
      static_cast<T*>(out), lse, heads, t_q, t_k, dh, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* kv_mask, void* out, float* lse, int bh,
                     int heads, int t_q, int t_k, int dh, int causal,
                     float scale, cudaStream_t stream) {
#define PERSIA_FWD_LAUNCH(DHP)                                            \
  return launch<T, DHP>(q, k, v, kv_mask, out, lse, bh, heads, t_q, t_k, \
                        dh, causal, scale, stream)
  if (dh <= 4) PERSIA_FWD_LAUNCH(4);
  if (dh <= 8) PERSIA_FWD_LAUNCH(8);
  if (dh <= 16) PERSIA_FWD_LAUNCH(16);
  if (dh <= 32) PERSIA_FWD_LAUNCH(32);
  if (dh <= 64) PERSIA_FWD_LAUNCH(64);
  PERSIA_FWD_LAUNCH(128);
#undef PERSIA_FWD_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q is (bh, t_q, dh), k/v (bh, t_k, dh),
// out like q, all contiguous; kv_mask is null or (bh / heads, t_k) uint8;
// lse is null (serving) or (bh, t_q) f32. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int persia_flash_attention_fwd(const void* q, const void* k,
                                          const void* v, const void* kv_mask,
                                          void* out, float* lse, int bh,
                                          int heads, int t_q, int t_k, int dh,
                                          int dtype, int causal, float scale,
                                          void* stream) {
  if (bh <= 0 || heads <= 0 || t_q <= 0 || t_k <= 0 || dh <= 0 || dh > 128 ||
      bh % heads != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, kv_mask, out, lse, bh, heads, t_q, t_k, dh, causal, scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, kv_mask, out, lse, bh, heads, t_q, t_k, dh, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* persia_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
