// Flash-attention backward for NVIDIA Hopper (sm_90a): kernels K3 and K4.
//
// Replaces the two Pallas TPU kernels of
// persia_tpu/ops/flash_attention.py:flash_attention_bwd_pallas:
//   K3 = _bwd_dq_kernel  (dq, one pass over the k tiles of a q tile),
//   K4 = _bwd_dkv_kernel (dk and dv, one pass over the q tiles of a k tile).
// Both recompute the softmax block from q, k and the forward's logsumexp
// exactly as _masked_p does: p = exp(s * scale - lse) with s = q.k, keys
// past t_k, query rows past t_q, keys a causal query cannot see and keys
// whose mask byte is 0 give p = 0, and so does every key of a row whose
// lse is at or below -1e30 / 2 (a fully masked row). Then
//   ds = p * (dO.v - delta),   delta = rowsum(dO * O)
//   dq = scale * ds . K,   dk = scale * ds^T . Q,   dv = p^T . dO.
// f32 statistics and accumulation; inputs f32 or bf16, outputs in the
// input dtype. delta is not a separate pass: K3 owns every query row
// exactly once, so its prologue computes the row's delta from dO and O,
// uses it, and writes it to a (B*H, T_q) f32 buffer for K4, which runs
// after it on the same stream.
//
// No atomics: as in the JAX package each output tile belongs to one CTA
// (dq to the CTA of its q tile, dk/dv to the CTA of their k tile), and the
// TPU's sequential grid axis becomes a loop inside the CTA. The gradients
// are deterministic.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at
// the attention-bench shape (B=4, H=8, T=8192, Dh=128, bf16, causal) one
// causal product is ~2.75e11 FLOP (0.28 ms at the tensor-core peak); K3
// does three (q.k, dO.v, ds.K), ~0.83 ms, and K4 four (q.k, dO.v, p^T.dO,
// ds^T.Q), ~1.11 ms, against ~0.1 GB of bytes each: compute-bound. At the
// sequence tower's training shape (B=256, H=4, T=64, Dh=4, bf16) each
// moves ~3-4 MB (~1 us) and does ~0.1 GFLOP: bound by bytes, and in
// practice by the launch.
//
// Design (simple and right first, the layout of K2): 256 threads per CTA,
// 64-row tiles staged in shared memory as f32 with rows padded by one
// float against bank conflicts, four threads per row of the CTA's own
// tile. In K3 a thread scores 16 of a k tile's keys for its query row
// (q.k and dO.v together), the row's ds strip goes through shared memory,
// and the thread accumulates Dh/4 columns of dq in registers. K4 mirrors
// it with the roles of queries and keys swapped and accumulates Dh/4
// columns of both dk and dv. The products run on the f32 CUDA cores;
// mma/wgmma, TMA and warp specialisation are for a later change. Any
// Dh <= 128 is taken by instantiating padded widths 4..128 and
// zero-filling the pad columns (the scale uses the true Dh). At Dh = 128
// K3 needs ~149 KB and K4 ~166 KB of shared memory, above the 48 KB
// default, so the launcher raises the kernel's dynamic limit first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // query rows per tile
constexpr int BK = 64;            // keys per tile
constexpr int GROUP = 4;          // threads per row of the CTA's own tile
constexpr int NT = 64 * GROUP;    // threads per CTA
constexpr int KPT = BK / GROUP;   // keys a K3 thread scores per k tile
constexpr int QPT = BQ / GROUP;   // queries a K4 thread scores per q tile
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

// rows x DHP f32 tile of a (t, dh) matrix starting at row0, into shared
// memory with leading dimension DHP + 1; rows past t and pad columns are 0
template <typename T, int DHP>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int rows, int t, int dh) {
  constexpr int LD = DHP + 1;
  for (int idx = threadIdx.x; idx < rows * DHP; idx += NT) {
    const int rr = idx / DHP, d = idx % DHP;
    const int row = row0 + rr;
    dst[rr * LD + d] =
        (row < t && d < dh) ? to_f32(src[(size_t)row * dh + d]) : 0.f;
  }
}

template <int DHP>
constexpr size_t dq_smem_bytes() {
  // q, dO, k, v tiles and the per-row ds strips
  return sizeof(float) * (size_t)(2 * BQ * (DHP + 1) + 2 * BK * (DHP + 1) +
                                  BQ * (BK + 1));
}

template <int DHP>
constexpr size_t dkv_smem_bytes() {
  // k, v, q, dO tiles, the per-key p and ds strips, the q tile's lse/delta
  return sizeof(float) * (size_t)(2 * BK * (DHP + 1) + 2 * BQ * (DHP + 1) +
                                  2 * BK * (BQ + 1) + 2 * BQ);
}

// K3: one CTA per (batch*head, 64-row q tile); loops over the k tiles
template <typename T, int DHP>
__global__ void __launch_bounds__(NT)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ out,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const uint8_t* __restrict__ kv_mask, T* __restrict__ dq,
              float* __restrict__ delta, int heads, int t_q, int t_k, int dh,
              int causal, float scale) {
  static_assert(DHP % GROUP == 0, "padded head dim must divide by GROUP");
  constexpr int LD = DHP + 1;
  constexpr int LDS = BK + 1;
  constexpr int NACC = DHP / GROUP;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BQ * LD;
  float* k_s = do_s + BQ * LD;
  float* v_s = k_s + BK * LD;
  float* ds_s = v_s + BK * LD;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int r = tid / GROUP;  // query row within the tile
  const int j = tid % GROUP;  // this thread's lane within the row's group
  const int qrow = q0 + r;
  const bool row_ok = qrow < t_q;
  const size_t q_base = (size_t)bh * t_q * dh;
  const size_t kv_base = (size_t)bh * t_k * dh;
  const uint8_t* mask_row =
      kv_mask != nullptr ? kv_mask + (size_t)(bh / heads) * t_k : nullptr;

  load_tile<T, DHP>(q_s, q + q_base, q0, BQ, t_q, dh);
  load_tile<T, DHP>(do_s, dout + q_base, q0, BQ, t_q, dh);

  // delta = rowsum(dO * O): each of the row's four threads sums its share
  // of the columns, the shuffles stay inside the four-lane group
  float part = 0.f;
  if (row_ok) {
    for (int d = j; d < dh; d += GROUP) {
      const size_t off = q_base + (size_t)qrow * dh + d;
      part += to_f32(dout[off]) * to_f32(out[off]);
    }
  }
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  const float delta_r = part;
  if (row_ok && j == 0) delta[(size_t)bh * t_q + qrow] = delta_r;
  const float lse_r = row_ok ? lse[(size_t)bh * t_q + qrow] : NEG_INF;
  const bool live = lse_r > 0.5f * NEG_INF;

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  int n_k = (t_k + BK - 1) / BK;
  if (causal) {
    // k tiles whose first key lies past the tile's last real query row
    const int last_q = min(q0 + BQ, t_q) - 1;
    n_k = min(n_k, last_q / BK + 1);
  }

  for (int t = 0; t < n_k; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's k_s/v_s reads are done
    load_tile<T, DHP>(k_s, k + kv_base, k0, BK, t_k, dh);
    load_tile<T, DHP>(v_s, v + kv_base, k0, BK, t_k, dh);
    __syncthreads();

    float s[KPT], dp[KPT];
#pragma unroll
    for (int c = 0; c < KPT; ++c) s[c] = dp[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DHP; ++d) {
      const float qd = q_s[r * LD + d];
      const float od = do_s[r * LD + d];
#pragma unroll
      for (int c = 0; c < KPT; ++c) {
        const int kk = (j + GROUP * c) * LD + d;
        s[c] += qd * k_s[kk];
        dp[c] += od * v_s[kk];
      }
    }
#pragma unroll
    for (int c = 0; c < KPT; ++c) {
      const int kj = k0 + j + GROUP * c;
      bool ok = live && kj < t_k;
      if (causal) ok = ok && qrow >= kj;
      if (mask_row != nullptr) ok = ok && mask_row[kj] != 0;
      const float p = ok ? expf(s[c] * scale - lse_r) : 0.f;
      ds_s[r * LDS + j + GROUP * c] = p * (dp[c] - delta_r);
    }
    __syncwarp();  // the row's strip is written and read by one warp

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float ds = ds_s[r * LDS + kk];
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] += ds * k_s[kk * LD + j + GROUP * i];
    }
    __syncwarp();
  }

  if (row_ok) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int d = j + GROUP * i;
      if (d < dh) dq[q_base + (size_t)qrow * dh + d] = from_f32<T>(acc[i] * scale);
    }
  }
}

// K4: one CTA per (batch*head, 64-key k tile); loops over the q tiles
template <typename T, int DHP>
__global__ void __launch_bounds__(NT)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const uint8_t* __restrict__ kv_mask, T* __restrict__ dk,
               T* __restrict__ dv, int heads, int t_q, int t_k, int dh,
               int causal, float scale) {
  static_assert(DHP % GROUP == 0, "padded head dim must divide by GROUP");
  constexpr int LD = DHP + 1;
  constexpr int LDS = BQ + 1;
  constexpr int NACC = DHP / GROUP;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + BK * LD;
  float* q_s = v_s + BK * LD;
  float* do_s = q_s + BQ * LD;
  float* p_s = do_s + BQ * LD;
  float* ds_s = p_s + BK * LDS;
  float* lse_s = ds_s + BK * LDS;
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int r = tid / GROUP;  // key row within the tile
  const int j = tid % GROUP;
  const int krow = k0 + r;
  const size_t q_base = (size_t)bh * t_q * dh;
  const size_t kv_base = (size_t)bh * t_k * dh;
  bool key_ok = krow < t_k;
  if (key_ok && kv_mask != nullptr)
    key_ok = kv_mask[(size_t)(bh / heads) * t_k + krow] != 0;

  load_tile<T, DHP>(k_s, k + kv_base, k0, BK, t_k, dh);
  load_tile<T, DHP>(v_s, v + kv_base, k0, BK, t_k, dh);

  float dk_acc[NACC], dv_acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  const int n_q = (t_q + BQ - 1) / BQ;
  // causal: q tile qt sees key k0 iff its last row (qt+1)*BQ-1 >= k0, so
  // the first such tile is floor(k0 / BQ)
  const int q_first = causal ? k0 / BQ : 0;

  for (int qt = q_first; qt < n_q; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's q_s/do_s/lse_s reads are done
    load_tile<T, DHP>(q_s, q + q_base, q0, BQ, t_q, dh);
    load_tile<T, DHP>(do_s, dout + q_base, q0, BQ, t_q, dh);
    for (int idx = tid; idx < BQ; idx += NT) {
      const int qi = q0 + idx;
      // a row past t_q reads as fully masked
      lse_s[idx] = qi < t_q ? lse[(size_t)bh * t_q + qi] : NEG_INF;
      delta_s[idx] = qi < t_q ? delta[(size_t)bh * t_q + qi] : 0.f;
    }
    __syncthreads();

    float s[QPT], dp[QPT];
#pragma unroll
    for (int c = 0; c < QPT; ++c) s[c] = dp[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DHP; ++d) {
      const float kd = k_s[r * LD + d];
      const float vd = v_s[r * LD + d];
#pragma unroll
      for (int c = 0; c < QPT; ++c) {
        const int qq = (j + GROUP * c) * LD + d;
        s[c] += q_s[qq] * kd;
        dp[c] += do_s[qq] * vd;
      }
    }
#pragma unroll
    for (int c = 0; c < QPT; ++c) {
      const int qq = j + GROUP * c;
      const float l = lse_s[qq];
      bool ok = key_ok && l > 0.5f * NEG_INF;
      if (causal) ok = ok && q0 + qq >= krow;
      const float p = ok ? expf(s[c] * scale - l) : 0.f;
      p_s[r * LDS + qq] = p;
      ds_s[r * LDS + qq] = p * (dp[c] - delta_s[qq]);
    }
    __syncwarp();  // the key row's strips are written and read by one warp

#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      const float p = p_s[r * LDS + qq];
      const float ds = ds_s[r * LDS + qq];
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int col = qq * LD + j + GROUP * i;
        dv_acc[i] += p * do_s[col];
        dk_acc[i] += ds * q_s[col];
      }
    }
    __syncwarp();
  }

  if (krow < t_k) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int d = j + GROUP * i;
      if (d < dh) {
        const size_t off = kv_base + (size_t)krow * dh + d;
        dk[off] = from_f32<T>(dk_acc[i] * scale);
        dv[off] = from_f32<T>(dv_acc[i]);
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;
  float* delta;
  const void* kv_mask;
  void* dq;
  void* dk;
  void* dv;
  int bh, heads, t_q, t_k, dh, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int DHP>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<DHP>();
  const cudaError_t e = allow_smem(bwd_dq_kernel<T, DHP>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.bh, (a.t_q + BQ - 1) / BQ);
  bwd_dq_kernel<T, DHP><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.out),
      static_cast<const T*>(a.dout), a.lse,
      static_cast<const uint8_t*>(a.kv_mask), static_cast<T*>(a.dq), a.delta,
      a.heads, a.t_q, a.t_k, a.dh, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int DHP>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_bytes<DHP>();
  const cudaError_t e = allow_smem(bwd_dkv_kernel<T, DHP>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.bh, (a.t_k + BK - 1) / BK);
  bwd_dkv_kernel<T, DHP><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<const uint8_t*>(a.kv_mask), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.heads, a.t_q, a.t_k, a.dh, a.causal, a.scale);
  return cudaGetLastError();
}

// kernel 0 = K3 (dq), 1 = K4 (dk, dv); dtype 0 = float32, 1 = bfloat16
template <typename T>
cudaError_t dispatch(int kernel, const Args& a) {
#define PERSIA_BWD_LAUNCH(DHP) \
  return kernel == 0 ? launch_dq<T, DHP>(a) : launch_dkv<T, DHP>(a)
  if (a.dh <= 4) PERSIA_BWD_LAUNCH(4);
  if (a.dh <= 8) PERSIA_BWD_LAUNCH(8);
  if (a.dh <= 16) PERSIA_BWD_LAUNCH(16);
  if (a.dh <= 32) PERSIA_BWD_LAUNCH(32);
  if (a.dh <= 64) PERSIA_BWD_LAUNCH(64);
  PERSIA_BWD_LAUNCH(128);
#undef PERSIA_BWD_LAUNCH
}

int run(int kernel, int dtype, const Args& a) {
  if (a.bh <= 0 || a.heads <= 0 || a.t_q <= 0 || a.t_k <= 0 || a.dh <= 0 ||
      a.dh > 128 || a.bh % a.heads != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch<float>(kernel, a);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(kernel, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K3. q, out, dout and dq are (bh, t_q, dh), k/v (bh, t_k, dh), all
// contiguous in one dtype (0 = float32, 1 = bfloat16); lse is (bh, t_q)
// f32 from the forward; kv_mask is null or (bh / heads, t_k) uint8. Writes
// dq and the (bh, t_q) f32 delta = rowsum(dout * out) that K4 reads.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int persia_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, const void* kv_mask, void* dq,
    float* delta, int bh, int heads, int t_q, int t_k, int dh, int dtype,
    int causal, float scale, void* stream) {
  Args a{q, k, v, out, dout, lse, delta, kv_mask, dq, nullptr, nullptr,
         bh, heads, t_q, t_k, dh, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return run(0, dtype, a);
}

// K4. Shapes as for K3; delta is K3's output. Writes dk and dv, each
// (bh, t_k, dh) in the input dtype.
extern "C" int persia_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const void* kv_mask, void* dk,
    void* dv, int bh, int heads, int t_q, int t_k, int dh, int dtype,
    int causal, float scale, void* stream) {
  Args a{q, k, v, nullptr, dout, lse, const_cast<float*>(delta), kv_mask,
         nullptr, dk, dv, bh, heads, t_q, t_k, dh, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return run(1, dtype, a);
}

extern "C" const char* persia_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
