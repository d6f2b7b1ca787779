// Flash-attention backward for NVIDIA Hopper (sm_90a): kernels K3 and K4.
//
// Replaces the two Pallas TPU kernels of
// persia_tpu/ops/flash_attention.py:flash_attention_bwd_pallas:
//   K3 = _bwd_dq_kernel  (:237, dq, one pass over the k tiles of a q tile),
//   K4 = _bwd_dkv_kernel (:280, dk and dv, one pass over the q tiles of a
//        k tile).
// Both recompute the softmax block from q, k and the forward's logsumexp
// exactly as _masked_p does: p = exp(s * scale - lse) with s = q.k, keys
// past t_k, query rows past t_q, keys a causal query cannot see and keys
// whose mask byte is 0 give p = 0, and so does every key of a row whose
// lse is at or below -1e30 / 2 (a fully masked row): a select, never
// arithmetic, since exp(s + 1e30) is inf and inf * 0 is NaN. Then
//   ds = p * (dO.v - delta),   delta = rowsum(dO * O)
//   dq = scale * ds . K,   dk = scale * ds^T . Q,   dv = p^T . dO.
// f32 statistics and accumulation, outputs in the input dtype. delta is
// not a separate pass: K3 owns every query row exactly once, so its
// prologue computes the row's delta from dO and O, uses it, and writes it
// to a (B*H, T_q) f32 buffer for K4, which runs after it on the same
// stream. No atomics: each output tile belongs to one CTA (dq to the CTA
// of its q tile, dk/dv to the CTA of their k tile), and the TPU's
// sequential grid axis becomes a loop inside the CTA, so the gradients are
// deterministic, bit for bit, run to run.
//
// Two bodies, chosen by the caller (ops/flash_attention.py:bwd_plan):
//
// bf16: the tensor-core bodies (namespace tc). What bounds them on an H100
// SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the attention-bench shape
// (B=4, H=8, T=8192, Dh=128, causal) one causal product is ~2.75e11 FLOP;
// K3 does three (q.k, dO.v, ds.K), a 0.83 ms floor, and K4 four (q.k,
// dO.v, p^T.dO, ds^T.Q), 1.11 ms, against ~0.1 GB of operands each:
// compute-bound, so every product runs on the tensor cores. At the
// sequence tower's training shape (B=256, H=4, T=64, Dh=4) each moves
// ~3-4 MB (~1 us) and does ~0.1 GFLOP: launch-bound, whatever the body.
// Design, the tile machinery of K2 (sm90.cuh):
// - K3: a CTA owns 64 or 128 query rows of one (batch, head), one or two
//   consumer warpgroups of 64 rows. Q and dO are loaded once; K/V tiles of
//   64 keys arrive in a ring of three stages. Per tile, S = Q K^T and
//   dP = dO V^T are two chains of wgmma m64n64k16 with every operand read
//   from shared memory (K and V K-major); P = exp2(S scale log2e -
//   lse log2e) and dS = P (dP - delta) are computed on the accumulator
//   fragment, with each row's lse and delta in the thread's registers; dS
//   is rounded to bf16 in registers (as the TPU kernel rounds ds to k's
//   dtype), and that fragment is the A operand of dQ += dS K, a chain of
//   register-A wgmma m64nDHPk16 with K read MN-major. dQ of tile t - 1 is
//   issued behind S and dP of tile t, so the tensor cores finish it while
//   the warpgroup computes dS of tile t (why the ring has three stages).
//   A warpgroup skips the k tiles wholly above its diagonal, and the
//   causal grid starts with the longest q tiles.
// - K4 works on the transpose, so that its fragments are A operands: a
//   CTA owns 64 or 128 keys (one or two consumer warpgroups of 64), loads
//   K and V once, and streams Q and dO tiles of 64 queries, with their 64
//   lse and delta values, through the ring. Per tile, S^T = K Q^T and
//   dP^T = V dO^T (ss, both K-major), P^T = exp2(S^T scale log2e -
//   lse_col log2e), dV += bf16(P^T) dO and dK += bf16(dS^T) Q (rs, dO and Q
//   read MN-major; p and ds rounded as the TPU kernel rounds them). The
//   key mask is per fragment row: a masked key's p^T row only reaches its
//   own dk/dv rows, so those rows are stored as zeros, not masked per
//   tile. A warpgroup starts at the first q tile that can see its keys,
//   floor(k0 / 64); the causal grid's first CTAs have the smallest k0 and
//   the most work. K4 keeps 128 accumulators (dK, dV) and 64 scores (S^T,
//   dP^T) a thread, so it waits for each tile's products instead of
//   overlapping them with the next tile's: the two warpgroups of a CTA
//   overlap each other instead.
// - A producer warpgroup, one warp of which issues the TMA loads (3-D
//   tensor maps over (Dh, T, B*H), zero fill past T and Dh) and stages the
//   key-mask bytes (K3) or the lse/delta rows (K4); tiles complete on
//   mbarriers, and a second mbarrier per stage tells the producer that
//   every consumer is done with it. With two consumer warpgroups the
//   producer gives its registers to them (setmaxnreg, 24 and 240 a
//   thread): a CTA of 288 or 384 threads gets 168, and K4 at Dh = 128
//   needs ~240 (one warpgroup a CTA ran 1.4x slower at the bench shape).
//   TMA needs rows that are a multiple of 16 bytes: for other Dh (the
//   sequence tower's Dh=4) the consumer threads load the same swizzled
//   layout with cp.async, zero-padded to a depth of 16 (the wgmma depth),
//   and meet at a CTA barrier per tile. Masks are branch-free and touch
//   only the tiles they cross.
// Left on the table: overlapping K4's next tile with its products (the
// registers are spent), ping-pong between the two warpgroups, 128-wide
// tiles, TMA stores of the gradients, a persistent grid.
//
// f32: the CUDA-core bodies (namespace cc), kept for f32 inputs, whose
// agreement gates need f32 products (the tensor cores give TF32): 256
// threads per CTA, 64-row tiles staged in shared memory as f32, four
// threads per row of the CTA's own tile, products on the CUDA cores. At
// Dh = 128 K3 needs ~149 KB and K4 ~166 KB of shared memory, so the
// launcher raises the kernel's dynamic limit first.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

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
  int piece;  // bf16 values per cp.async copy (the cp.async body)
  cudaStream_t stream;
};

// --- f32 bodies on the CUDA cores -------------------------------------------

namespace cc {

constexpr int BQ = 64;            // query rows per tile
constexpr int BK = 64;            // keys per tile
constexpr int GROUP = 4;          // threads per row of the CTA's own tile
constexpr int NT = 64 * GROUP;    // threads per CTA
constexpr int KPT = BK / GROUP;   // keys a K3 thread scores per k tile
constexpr int QPT = BQ / GROUP;   // queries a K4 thread scores per q tile

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

// kernel 0 = K3 (dq), 1 = K4 (dk, dv); instantiated for float only (bf16
// runs on the tensor cores)
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

}  // namespace cc

// --- bf16 bodies on the tensor cores ----------------------------------------

namespace tc {

using namespace sm90;  // wgmma, descriptors, mbarriers, TMA (sm90.cuh)

constexpr int BT = 64;       // rows of a streamed tile: keys (K3), queries (K4)
constexpr int STAGES = 3;    // depth of the ring
constexpr int WG_ROWS = 64;  // rows a consumer warpgroup owns
// a staged lse (times log2 e) at or below this marks a fully masked row
constexpr float DEAD_LSE2 = 0.5f * NEG_INF * LOG2E;

// The threads of a CTA: the consumer warpgroups, and with TMA a producer
// warpgroup, one warp of which keeps the ring full. A CTA of 384 threads
// gets 168 registers a thread, too few for K4's accumulators at Dh = 128
// (a producer of one warp, 288 threads, gets the same: it spilled), so
// with two consumer warpgroups the producer hands its registers to them
// (setmaxnreg): 24 for the producer, 240 for each consumer thread.
template <bool TMA>
constexpr int cta_threads(int nwg) {
  return nwg * 128 + (TMA ? 128 : 0);
}
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

// the producer warpgroup's first step: give up registers (two consumer
// warpgroups only)
template <int NWG>
__device__ __forceinline__ void producer_regs() {
  if (NWG == 2)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
}
// the consumer warpgroups' first step: take them
template <int NWG>
__device__ __forceinline__ void consumer_regs() {
  if (NWG == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
}

// Tile rows of DHP bf16 columns: ROWB bytes, swizzled over ROWB, in NCH
// chunks of 64 columns.
template <int DHP>
struct Rows {
  static constexpr int ROWB = DHP >= 64 ? 128 : DHP * 2;
  static constexpr int NCH = DHP * 2 / ROWB;
};

// Raises a kernel's dynamic shared-memory limit once on each device (bit
// `device` of `sized`).
template <typename K>
cudaError_t size_once(K kernel, size_t smem, unsigned long long& sized) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 64 && ((sized >> device) & 1ull)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess && device < 64) sized |= 1ull << device;
  return e;
}

// rowsum(a * b) over the columns j, j + 4, ... of a row (VEC: columns
// 8 j .. 8 j + 7, then + 32, ..., 16-byte loads; dh % 8 == 0 and rows
// 16-byte aligned): this thread's quarter of a row's delta
template <bool VEC>
__device__ __forceinline__ float row_dot(const __nv_bfloat16* a,
                                         const __nv_bfloat16* b, int dh,
                                         int j) {
  float s = 0.f;
  if (VEC) {
    for (int x = 8 * j; x < dh; x += 32) {
      const uint4 va = *reinterpret_cast<const uint4*>(a + x);
      const uint4 vb = *reinterpret_cast<const uint4*>(b + x);
      const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&va);
      const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&vb);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 fa = __bfloat1622float2(pa[i]);
        const float2 fb = __bfloat1622float2(pb[i]);
        s = fmaf(fa.x, fb.x, s);
        s = fmaf(fa.y, fb.y, s);
      }
    }
  } else {
    for (int x = j; x < dh; x += 4)
      s = fmaf(__bfloat162float(a[x]), __bfloat162float(b[x]), s);
  }
  return s;
}

// Row h (0: the quad's row, 1: eight below) of a 64 x DHP accumulator
// fragment, times `mul`, into `dst` in bf16 (zeros unless `keep`); columns
// at or past dh are not stored.
template <int DHP>
__device__ __forceinline__ void store_row(__nv_bfloat16* dst,
                                          const float (&acc)[DHP / 2], int h,
                                          float mul, bool keep, int dh,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < DHP / 8; ++j) {
    const int col = j * 8 + 2 * (lane % 4);
    const float x0 = keep ? acc[j * 4 + h * 2] * mul : 0.f;
    const float x1 = keep ? acc[j * 4 + h * 2 + 1] * mul : 0.f;
    if (col + 1 < dh && dh % 2 == 0) {
      *reinterpret_cast<__nv_bfloat162*>(dst + col) =
          __floats2bfloat162_rn(x0, x1);
    } else {
      if (col < dh) dst[col] = __float2bfloat16(x0);
      if (col + 1 < dh) dst[col + 1] = __float2bfloat16(x1);
    }
  }
}

// --- K3 ---------------------------------------------------------------------

template <int DHP, int NWG>
struct DqShape {
  static constexpr int ROWB = Rows<DHP>::ROWB, NCH = Rows<DHP>::NCH;
  static constexpr int BQ = NWG * WG_ROWS;  // query rows of a CTA
  static constexpr int NC = NWG * 128;      // consumer threads
  static constexpr int Q_BYTES = BQ * DHP * 2;   // Q (or dO)
  static constexpr int KV_BYTES = BT * DHP * 2;  // K (or V) of one stage
  static constexpr int MASK_OFF = 2 * Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int BAR_OFF = MASK_OFF + STAGES * BT;
  // 1024 bytes of slack to align the tiles for the 128-byte swizzle; the
  // barriers: Q/dO, then full and empty of each stage
  static constexpr size_t SMEM = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
};

template <int DHP, int NWG, bool TMA>
__global__ void __launch_bounds__(cta_threads<TMA>(NWG), 1)
bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
              const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v,
              const __grid_constant__ CUtensorMap map_do,
              const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ out,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse,
              const uint8_t* __restrict__ kv_mask,
              __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
              int heads, int t_q, int t_k, int dh, int causal, float scale,
              int piece) {
  using S = DqShape<DHP, NWG>;
  constexpr int ROWB = S::ROWB, NCH = S::NCH, BQ = S::BQ, NC = S::NC;
  constexpr int NS = BT / 2;   // S (and dP) accumulators of a thread
  constexpr int ND = DHP / 2;  // dQ accumulators of a thread

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;
  uint8_t* const base = smem_raw + (sq - raw);
  const uint32_t sdo = sq + S::Q_BYTES;
  const uint32_t sk = sdo + S::Q_BYTES;
  const uint32_t sv = sk + STAGES * S::KV_BYTES;
  uint8_t* const mask_s = base + S::MASK_OFF;
  const uint32_t bar_q = sq + S::BAR_OFF;
  const uint32_t bar_full = bar_q + 8;                // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;  // + 8 * stage

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x;
  // the causal grid runs its longest q tiles first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int qw = q0 + wg * WG_ROWS;                // this warpgroup's first row
  const int wg_last = min(qw + WG_ROWS, t_q) - 1;  // < qw: no rows here
  const int row0 = qw + warp * 16 + lane / 4;  // row of h = 0; h = 1 is + 8
  const size_t q_base = (size_t)bh * t_q * dh;
  const uint8_t* mask_row =
      kv_mask != nullptr ? kv_mask + (size_t)(bh / heads) * t_k : nullptr;

  int n_k = (t_k + BT - 1) / BT;
  if (causal) n_k = min(n_k, (min(q0 + BQ, t_q) - 1) / BT + 1);
  // producer lanes that arrive on a stage's full barrier: the TMA issuer,
  // and with a key mask all 32, which stage its bytes
  const int stagers = mask_row != nullptr ? 32 : 1;

  if (!TMA) {
    // the copies never write the padding columns: zero the tiles once
    for (int i = tid * 16; i < S::MASK_OFF; i += NC * 16)
      *reinterpret_cast<uint4*>(base + i) = make_uint4(0, 0, 0, 0);
  }
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, stagers);
      mbar_init(bar_empty + 8 * s, NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the key-mask bytes of tile t, bytes i0, i0 + step, ...
  auto stage_mask = [&](int t, int i0, int step) {
    const int k0 = t * BT;
    for (int i = i0; i < BT; i += step)
      mask_s[(t % STAGES) * BT + i] =
          k0 + i < t_k ? mask_row[k0 + i] : (uint8_t)0;
  };

  if (TMA && tid >= NC) {
    // the producer warp: Q and dO once, then each K/V tile into its stage
    // as soon as every consumer is done with the tile that held it
    producer_regs<NWG>();
    const int p = tid - NC;
    if (p >= stagers) return;
    if (p == 0) {
      mbar_arrive_tx(bar_q, 2 * S::Q_BYTES);
      for (int w = 0; w < NWG; ++w)
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const uint32_t off = c * BQ * ROWB + w * WG_ROWS * ROWB;
          tma_load(sq + off, &map_q, bar_q, c * 64, q0 + w * WG_ROWS, bh);
          tma_load(sdo + off, &map_do, bar_q, c * 64, q0 + w * WG_ROWS, bh);
        }
    }
    for (int t = 0; t < n_k; ++t) {
      const int s = t % STAGES;
      if (t >= STAGES) mbar_wait(bar_empty + 8 * s, (t / STAGES - 1) & 1);
      if (mask_row != nullptr) stage_mask(t, p, 32);
      if (p == 0) {
        mbar_arrive_tx(bar_full + 8 * s, 2 * S::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const uint32_t off = s * S::KV_BYTES + c * BT * ROWB;
          tma_load(sk + off, &map_k, bar_full + 8 * s, c * 64, t * BT, bh);
          tma_load(sv + off, &map_v, bar_full + 8 * s, c * 64, t * BT, bh);
        }
      } else {
        mbar_arrive(bar_full + 8 * s);
      }
    }
    return;
  }

  if (TMA) consumer_regs<NWG>();

  // TMA: this consumer thread is done with tile t (every consumer releases
  // every tile, in order)
  auto release = [&](int t) { mbar_arrive(bar_empty + 8 * (t % STAGES)); };
  // cp.async: tile t into its stage, by every thread
  auto load = [&](int t) {
    const int s = t % STAGES;
    const size_t kv_base = (size_t)bh * t_k * dh;
    load_rows<ROWB, NCH, BT>(sk + s * S::KV_BYTES, k + kv_base, t * BT, t_k,
                             dh, piece, tid, NC);
    load_rows<ROWB, NCH, BT>(sv + s * S::KV_BYTES, v + kv_base, t * BT, t_k,
                             dh, piece, tid, NC);
    if (mask_row != nullptr) stage_mask(t, tid, NC);
  };

  if (!TMA) {
    load_rows<ROWB, NCH, BQ>(sq, q + q_base, q0, t_q, dh, piece, tid, NC);
    load_rows<ROWB, NCH, BQ>(sdo, dout + q_base, q0, t_q, dh, piece, tid, NC);
    load(0);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // this thread's rows h = 0, 1: delta = rowsum(dO * O), written once for
  // K4 (the quad's four threads sum a quarter each), and the lse; a row
  // past t_q reads as fully masked
  float dlt[2], lse2[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const size_t off = q_base + (size_t)row * dh;
    float part = row < t_q ? row_dot<TMA>(dout + off, out + off, dh, lane % 4)
                           : 0.f;
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    dlt[h] = part;
    if (row < t_q && lane % 4 == 0) delta[(size_t)bh * t_q + row] = part;
    const float l = row < t_q ? lse[(size_t)bh * t_q + row] : NEG_INF;
    live[h] = l > 0.5f * NEG_INF;
    lse2[h] = l * LOG2E;
  }
  if (TMA) mbar_wait(bar_q, 0);

  // the tiles this warpgroup multiplies: none without rows, and none
  // wholly above its diagonal
  const int n_wg = wg_last < qw ? 0
                   : causal     ? min(n_k, wg_last / BT + 1)
                                : n_k;
  float dqa[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) dqa[i] = 0.f;
  float sc[NS];             // S, then P, then dS in f32, of the newest tile
  float dp[NS];             // dP of the newest tile
  uint32_t da[BT / 16][4];  // dS in bf16 of the tile before it
  const float scale_log2 = scale * LOG2E;
  const int quad_col = 2 * (lane % 4);  // first column of this thread

  // tile t has arrived, for every thread: by TMA, or by cp.async (then
  // every thread is also done with tile t - 2, whose stage takes t + 1)
  auto arrive = [&](int t) {
    if (TMA) {
      mbar_wait(bar_full + 8 * (t % STAGES), (t / STAGES) & 1);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      // the copies, made visible to the tensor cores (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (t + 1 < n_k) load(t + 1);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  };
  // S = Q K^T and dP = dO V^T of tile t, issued and committed as one group
  auto s_products = [&](int t) {
    const uint32_t k_tile = sk + (t % STAGES) * S::KV_BYTES;
    const uint32_t v_tile = sv + (t % STAGES) * S::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk) {
      const uint32_t c = kk * 32 / ROWB, in = kk * 32 % ROWB;
      const uint32_t a = c * BQ * ROWB + wg * WG_ROWS * ROWB + in;
      const uint32_t b = c * BT * ROWB + in;
      Mma<BT>::ss(sc, desc<ROWB>(sq + a, 16, 8 * ROWB),
                  desc<ROWB>(k_tile + b, 16, 8 * ROWB), kk > 0);
      Mma<BT>::ss(dp, desc<ROWB>(sdo + a, 16, 8 * ROWB),
                  desc<ROWB>(v_tile + b, 16, 8 * ROWB), kk > 0);
    }
    wgmma_commit();
  };
  // dQ += dS K of tile t with the dS in da, issued and committed
  auto dq_product = [&](int t) {
    const uint32_t k_tile = sk + (t % STAGES) * S::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
      Mma<DHP>::rs(dqa, da[kk],
                   desc<ROWB>(k_tile + kk * 16 * ROWB, BT * ROWB, 8 * ROWB));
    wgmma_commit();
  };
  // P and dS of tile t on the fragments: sc[j * 4 + h * 2 + e] is row
  // row0 + 8 h, column k0 + 8 j + quad_col + e. Leaves dS (f32) in sc.
  auto grad = [&](int t) {
    const int k0 = t * BT;
    // the masks, only on tiles they cross: keys at or past t_k, keys past
    // the row (causal), key-mask zeros, and rows past t_q or fully masked
    // (only with a key mask can a row before t_q be fully masked)
    if (mask_row != nullptr || k0 + BT > t_k ||
        (causal && k0 + BT - 1 > qw) || qw + WG_ROWS > t_q) {
      int lim[2];  // columns of the tile row h may see: [0, lim)
      uint32_t bits = 0xffffffffu;  // bit 2 j + e: key-mask byte
#pragma unroll
      for (int h = 0; h < 2; ++h)
        lim[h] = !live[h] ? 0
                 : causal ? min(t_k, row0 + 8 * h + 1) - k0
                          : t_k - k0;
      if (mask_row != nullptr) {
        const uint8_t* tile_mask = mask_s + (t % STAGES) * BT + quad_col;
        bits = 0;
#pragma unroll
        for (int j = 0; j < BT / 8; ++j)
          bits |= (uint32_t)(tile_mask[8 * j] != 0) << (2 * j) |
                  (uint32_t)(tile_mask[8 * j + 1] != 0) << (2 * j + 1);
      }
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[j * 4 + h * 2 + e];
            const bool ok = 8 * j + quad_col + e < lim[h] &&
                            ((bits >> (2 * j + e)) & 1u);
            const float p = ex2(fmaf(x, scale_log2, -lse2[h]));
            x = ok ? p : 0.f;
          }
    } else {
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[j * 4 + h * 2 + e];
            x = ex2(fmaf(x, scale_log2, -lse2[h]));
          }
    }
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = j * 4 + h * 2 + e;
          sc[i] *= dp[i] - dlt[h];
        }
  };
  // dS in bf16: the fragment of keys [16 kk, 16 kk + 16) is the A fragment
  // of the kk-th k16 step
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        da[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
  };

  if (n_wg > 0) {  // warpgroup-uniform
    arrive(0);
    wgmma_fence();
    s_products(0);
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
    grad(0);
    pack();
    for (int t = 1; t < n_wg; ++t) {
      // S and dP of tile t, then dQ of tile t - 1 behind them: dS of tile
      // t is computed while the tensor cores finish dQ
      arrive(t);
      wgmma_fence();
      s_products(t);
      dq_product(t - 1);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_regs(sc);
      fence_regs(dp);
      grad(t);
      wgmma_wait_all();
      fence_regs(dqa);
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk)
        asm volatile("" : "+r"(da[kk][0]), "+r"(da[kk][1]), "+r"(da[kk][2]),
                     "+r"(da[kk][3])::"memory");
      if (TMA) release(t - 1);
      pack();
    }
    wgmma_fence();
    dq_product(n_wg - 1);
    wgmma_wait_all();
    fence_regs(dqa);
    if (TMA) release(n_wg - 1);
  }
  // the tiles past this warpgroup's diagonal: arrive and release only
  for (int t = n_wg; t < n_k; ++t) {
    arrive(t);
    if (TMA) release(t);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row < t_q)
      store_row<DHP>(dq + q_base + (size_t)row * dh, dqa, h, scale, true, dh,
                     lane);
  }
}

// --- K4 ---------------------------------------------------------------------

template <int DHP, int NWG>
struct DkvShape {
  static constexpr int ROWB = Rows<DHP>::ROWB, NCH = Rows<DHP>::NCH;
  static constexpr int BKV = NWG * WG_ROWS;  // keys of a CTA
  static constexpr int NC = NWG * 128;       // consumer threads
  static constexpr int KV_BYTES = BKV * DHP * 2;  // K (or V), loaded once
  static constexpr int Q_BYTES = BT * DHP * 2;    // Q (or dO) of one stage
  // per stage BT lse values (times log2 e), then BT delta values, f32
  static constexpr int ROW_OFF = 2 * KV_BYTES + 2 * STAGES * Q_BYTES;
  static constexpr int BAR_OFF = ROW_OFF + STAGES * 2 * BT * 4;
  // the barriers: K/V, then full and empty of each stage
  static constexpr size_t SMEM = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
};

template <int DHP, int NWG, bool TMA>
__global__ void __launch_bounds__(cta_threads<TMA>(NWG), 1)
bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_do,
               const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta,
               const uint8_t* __restrict__ kv_mask,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               int heads, int t_q, int t_k, int dh, int causal, float scale,
               int piece) {
  using S = DkvShape<DHP, NWG>;
  constexpr int ROWB = S::ROWB, NCH = S::NCH, BKV = S::BKV, NC = S::NC;
  constexpr int NS = BT / 2;   // S^T (and dP^T) accumulators of a thread
  constexpr int ND = DHP / 2;  // dK (and dV) accumulators of a thread

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sk = (raw + 1023u) & ~1023u;
  uint8_t* const base = smem_raw + (sk - raw);
  const uint32_t sv = sk + S::KV_BYTES;
  const uint32_t sq = sv + S::KV_BYTES;
  const uint32_t sdo = sq + STAGES * S::Q_BYTES;
  float* const rows_s = reinterpret_cast<float*>(base + S::ROW_OFF);
  const uint32_t bar_kv = sk + S::BAR_OFF;
  const uint32_t bar_full = bar_kv + 8;               // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;  // + 8 * stage

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x;
  // the causal grid's first CTAs hold the smallest k0, with the most work
  const int k0 = blockIdx.y * BKV;
  const int kw = k0 + wg * WG_ROWS;            // this warpgroup's first key
  const int row0 = kw + warp * 16 + lane / 4;  // key of h = 0; h = 1 is + 8
  const size_t q_base = (size_t)bh * t_q * dh;
  const size_t kv_base = (size_t)bh * t_k * dh;
  const uint8_t* mask_row =
      kv_mask != nullptr ? kv_mask + (size_t)(bh / heads) * t_k : nullptr;

  const int n_q = (t_q + BT - 1) / BT;
  // causal: q tile t sees key k0 iff its last query (t + 1) BT - 1 >= k0,
  // so the first such tile is floor(k0 / BT); tiles are counted from it
  const int t_first = causal ? min(k0 / BT, n_q) : 0;

  if (!TMA) {
    // the copies never write the padding columns: zero the tiles once
    for (int i = tid * 16; i < S::ROW_OFF; i += NC * 16)
      *reinterpret_cast<uint4*>(base + i) = make_uint4(0, 0, 0, 0);
  }
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 32);  // the producer warp's lanes
      mbar_init(bar_empty + 8 * s, NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the lse (times log2 e) and delta of q tile t into its stage, entries
  // i0, i0 + step, ...; a query past t_q reads as fully masked
  auto stage_rows = [&](int t, int i0, int step) {
    float* r = rows_s + (t - t_first) % STAGES * 2 * BT;
    for (int i = i0; i < BT; i += step) {
      const int qi = t * BT + i;
      const bool ok = qi < t_q;
      r[i] = ok ? lse[(size_t)bh * t_q + qi] * LOG2E : NEG_INF * LOG2E;
      r[BT + i] = ok ? delta[(size_t)bh * t_q + qi] : 0.f;
    }
  };

  if (TMA && tid >= NC) {
    // the producer warp: K and V once, then each Q/dO tile and its rows
    // into its stage as soon as every consumer is done with the stage
    producer_regs<NWG>();
    const int p = tid - NC;
    if (p >= 32) return;
    if (p == 0) {
      mbar_arrive_tx(bar_kv, 2 * S::KV_BYTES);
      for (int w = 0; w < NWG; ++w)
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const uint32_t off = c * BKV * ROWB + w * WG_ROWS * ROWB;
          tma_load(sk + off, &map_k, bar_kv, c * 64, k0 + w * WG_ROWS, bh);
          tma_load(sv + off, &map_v, bar_kv, c * 64, k0 + w * WG_ROWS, bh);
        }
    }
    for (int t = t_first; t < n_q; ++t) {
      const int i = t - t_first, s = i % STAGES;
      if (i >= STAGES) mbar_wait(bar_empty + 8 * s, (i / STAGES - 1) & 1);
      stage_rows(t, p, 32);
      if (p == 0) {
        mbar_arrive_tx(bar_full + 8 * s, 2 * S::Q_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const uint32_t off = s * S::Q_BYTES + c * BT * ROWB;
          tma_load(sq + off, &map_q, bar_full + 8 * s, c * 64, t * BT, bh);
          tma_load(sdo + off, &map_do, bar_full + 8 * s, c * 64, t * BT, bh);
        }
      } else {
        mbar_arrive(bar_full + 8 * s);
      }
    }
    return;
  }

  if (TMA) consumer_regs<NWG>();

  // TMA: this consumer thread is done with tile t
  auto release = [&](int t) {
    mbar_arrive(bar_empty + 8 * ((t - t_first) % STAGES));
  };
  // cp.async: tile t into its stage, by every thread
  auto load = [&](int t) {
    const int s = (t - t_first) % STAGES;
    load_rows<ROWB, NCH, BT>(sq + s * S::Q_BYTES, q + q_base, t * BT, t_q, dh,
                             piece, tid, NC);
    load_rows<ROWB, NCH, BT>(sdo + s * S::Q_BYTES, dout + q_base, t * BT, t_q,
                             dh, piece, tid, NC);
    stage_rows(t, tid, NC);
  };
  // tile t has arrived, for every thread (cp.async: see K3)
  auto arrive = [&](int t) {
    const int i = t - t_first;
    if (TMA) {
      mbar_wait(bar_full + 8 * (i % STAGES), (i / STAGES) & 1);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (t + 1 < n_q) load(t + 1);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  };

  if (TMA) {
    mbar_wait(bar_kv, 0);
  } else {
    load_rows<ROWB, NCH, BKV>(sk, k + kv_base, k0, t_k, dh, piece, tid, NC);
    load_rows<ROWB, NCH, BKV>(sv, v + kv_base, k0, t_k, dh, piece, tid, NC);
    if (t_first < n_q) load(t_first);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  float dka[ND], dva[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) dka[i] = dva[i] = 0.f;
  float sc[NS];                        // S^T, then P^T, in f32
  float dp[NS];                        // dP^T, then dS^T, in f32
  uint32_t pa[BT / 16][4], da[BT / 16][4];  // P^T and dS^T in bf16
  const float scale_log2 = scale * LOG2E;
  const int quad_col = 2 * (lane % 4);  // first column of this thread

  // P^T and dS^T of tile t (stage s) on the fragments: sc[j * 4 + h * 2 +
  // e] is key row0 + 8 h, query q0 + 8 j + quad_col + e, whose lse and
  // delta sit in the stage's rows
  auto grad = [&](int t, int s, bool masked) {
    const int q0 = t * BT;
    const float* r = rows_s + s * 2 * BT;
    int lo[2];  // columns of the tile key h is seen by: [lo, BT)
#pragma unroll
    for (int h = 0; h < 2; ++h) lo[h] = causal ? row0 + 8 * h - q0 : 0;
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(r + 8 * j + quad_col);
      const float2 d2 =
          *reinterpret_cast<const float2*>(r + BT + 8 * j + quad_col);
      const float lc[2] = {l2.x, l2.y};
      const float dc[2] = {d2.x, d2.y};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = j * 4 + h * 2 + e;
          float p = ex2(fmaf(sc[i], scale_log2, -lc[e]));
          if (masked) {
            const bool ok = lc[e] > DEAD_LSE2 && 8 * j + quad_col + e >= lo[h];
            p = ok ? p : 0.f;
          }
          sc[i] = p;
          dp[i] = p * (dp[i] - dc[e]);
        }
      // in bf16 at once, freeing the f32 values: columns [16 kk, 16 kk +
      // 16) are the A fragment of the kk-th k16 step
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = j * 4 + h * 2;
        pa[j / 2][2 * (j % 2) + h] = pack_bf16(sc[i], sc[i + 1]);
        da[j / 2][2 * (j % 2) + h] = pack_bf16(dp[i], dp[i + 1]);
      }
    }
  };

  // the first tile this warpgroup multiplies: the first that can see its
  // keys; none without keys
  const int t_begin =
      kw >= t_k ? n_q : causal ? max(t_first, min(kw / BT, n_q)) : t_first;
  // tiles before it: arrive and release only
  for (int t = t_first; t < t_begin; ++t) {
    arrive(t);
    if (TMA) release(t);
  }
  for (int t = t_begin; t < n_q; ++t) {
    arrive(t);
    const int s = (t - t_first) % STAGES;
    const uint32_t q_tile = sq + s * S::Q_BYTES;
    const uint32_t do_tile = sdo + s * S::Q_BYTES;
    // K's and V's descriptors are the same every tile: hidden from the
    // compiler, so that it recomputes them (a few integer operations)
    // rather than hold 16 of them across the loop, which at Dh = 128 with
    // two warpgroups spilled
    uint32_t kv_s = sk;
    asm volatile("" : "+r"(kv_s));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk) {
      const uint32_t c = kk * 32 / ROWB, in = kk * 32 % ROWB;
      const uint32_t a = c * BKV * ROWB + wg * WG_ROWS * ROWB + in;
      const uint32_t b = c * BT * ROWB + in;
      Mma<BT>::ss(sc, desc<ROWB>(kv_s + a, 16, 8 * ROWB),
                  desc<ROWB>(q_tile + b, 16, 8 * ROWB), kk > 0);
      Mma<BT>::ss(dp, desc<ROWB>(kv_s + S::KV_BYTES + a, 16, 8 * ROWB),
                  desc<ROWB>(do_tile + b, 16, 8 * ROWB), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
    // the masks, only on tiles they cross: a key mask (fully masked
    // queries), queries past t_q, queries before the key (causal)
    const int q0 = t * BT;
    if (mask_row != nullptr || q0 + BT > t_q ||
        (causal && q0 < kw + WG_ROWS - 1))
      grad(t, s, true);
    else
      grad(t, s, false);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
      Mma<DHP>::rs(dva, pa[kk],
                   desc<ROWB>(do_tile + kk * 16 * ROWB, BT * ROWB, 8 * ROWB));
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
      Mma<DHP>::rs(dka, da[kk],
                   desc<ROWB>(q_tile + kk * 16 * ROWB, BT * ROWB, 8 * ROWB));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dva);
    fence_regs(dka);
    if (TMA) release(t);
  }
  if (!TMA) asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // a masked key's p^T row reaches only its own dk/dv rows: zeros
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = row0 + 8 * h;
    if (key >= t_k) continue;
    const bool keep = mask_row == nullptr || mask_row[key] != 0;
    const size_t off = kv_base + (size_t)key * dh;
    store_row<DHP>(dk + off, dka, h, scale, keep, dh, lane);
    store_row<DHP>(dv + off, dva, h, 1.f, keep, dh, lane);
  }
}

// --- launchers --------------------------------------------------------------

template <int DHP, int NWG, bool TMA>
cudaError_t launch_dq(const Args& a) {
  using S = DqShape<DHP, NWG>;
  static unsigned long long sized = 0;
  const cudaError_t e = size_once(bwd_dq_kernel<DHP, NWG, TMA>, S::SMEM, sized);
  if (e != cudaSuccess) return e;
  CUtensorMap maps[4] = {};
  if (TMA && !(make_map(&maps[0], a.q, a.bh, a.t_q, a.dh, S::ROWB) &&
               make_map(&maps[1], a.k, a.bh, a.t_k, a.dh, S::ROWB) &&
               make_map(&maps[2], a.v, a.bh, a.t_k, a.dh, S::ROWB) &&
               make_map(&maps[3], a.dout, a.bh, a.t_q, a.dh, S::ROWB)))
    return cudaErrorNotSupported;
  const dim3 grid(a.bh, (a.t_q + S::BQ - 1) / S::BQ);
  bwd_dq_kernel<DHP, NWG, TMA><<<grid, cta_threads<TMA>(NWG), S::SMEM,
                                 a.stream>>>(
      maps[0], maps[1], maps[2], maps[3],
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.out),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse,
      static_cast<const uint8_t*>(a.kv_mask),
      static_cast<__nv_bfloat16*>(a.dq), a.delta, a.heads, a.t_q, a.t_k, a.dh,
      a.causal, a.scale, a.piece);
  return cudaGetLastError();
}

template <int DHP, int NWG, bool TMA>
cudaError_t launch_dkv(const Args& a) {
  using S = DkvShape<DHP, NWG>;
  static unsigned long long sized = 0;
  const cudaError_t e =
      size_once(bwd_dkv_kernel<DHP, NWG, TMA>, S::SMEM, sized);
  if (e != cudaSuccess) return e;
  CUtensorMap maps[4] = {};
  if (TMA && !(make_map(&maps[0], a.q, a.bh, a.t_q, a.dh, S::ROWB) &&
               make_map(&maps[1], a.k, a.bh, a.t_k, a.dh, S::ROWB) &&
               make_map(&maps[2], a.v, a.bh, a.t_k, a.dh, S::ROWB) &&
               make_map(&maps[3], a.dout, a.bh, a.t_q, a.dh, S::ROWB)))
    return cudaErrorNotSupported;
  const dim3 grid(a.bh, (a.t_k + S::BKV - 1) / S::BKV);
  bwd_dkv_kernel<DHP, NWG, TMA><<<grid, cta_threads<TMA>(NWG), S::SMEM,
                                  a.stream>>>(
      maps[0], maps[1], maps[2], maps[3],
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta,
      static_cast<const uint8_t*>(a.kv_mask),
      static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv),
      a.heads, a.t_q, a.t_k, a.dh, a.causal, a.scale, a.piece);
  return cudaGetLastError();
}

// kernel 0 = K3 (dq), 1 = K4 (dk, dv)
template <int NWG, bool TMA>
cudaError_t dispatch_dh(int kernel, const Args& a) {
#define PERSIA_TC_LAUNCH(DHP)                      \
  return kernel == 0 ? launch_dq<DHP, NWG, TMA>(a) \
                     : launch_dkv<DHP, NWG, TMA>(a)
  if (a.dh <= 16) PERSIA_TC_LAUNCH(16);
  if (a.dh <= 32) PERSIA_TC_LAUNCH(32);
  if (a.dh <= 64) PERSIA_TC_LAUNCH(64);
  PERSIA_TC_LAUNCH(128);
#undef PERSIA_TC_LAUNCH
}

template <int DHP>
size_t smem_of(int kernel, int nwg) {
  return kernel == 0 ? (nwg == 1 ? DqShape<DHP, 1>::SMEM
                                 : DqShape<DHP, 2>::SMEM)
                     : (nwg == 1 ? DkvShape<DHP, 1>::SMEM
                                 : DkvShape<DHP, 2>::SMEM);
}

size_t smem_bytes(int kernel, int rows, int dh) {
  const int nwg = rows / WG_ROWS;
  if (dh <= 16) return smem_of<16>(kernel, nwg);
  if (dh <= 32) return smem_of<32>(kernel, nwg);
  if (dh <= 64) return smem_of<64>(kernel, nwg);
  return smem_of<128>(kernel, nwg);
}

}  // namespace tc

// The bodies, as ops/flash_attention.py:bwd_plan names them (the values of
// K2's enum Body).
enum Body { F32_CUDA_CORES = 0, BF16_CP_ASYNC = 1, BF16_TMA = 2 };

// kernel 0 = K3, 1 = K4; rows: the query rows (K3) or keys (K4) of a CTA
// of the bf16 bodies, 64 or 128
int run(int kernel, int body, int rows, Args a) {
  if (a.bh <= 0 || a.heads <= 0 || a.t_q <= 0 || a.t_k <= 0 || a.dh <= 0 ||
      a.dh > 128 || a.bh % a.heads != 0)
    return (int)cudaErrorInvalidValue;
  if (body == F32_CUDA_CORES) return (int)cc::dispatch<float>(kernel, a);
  if (rows != 64 && rows != 128) return (int)cudaErrorInvalidValue;
  // the operands the tiles are copied from; K3's delta also reads out
  const uintptr_t align = reinterpret_cast<uintptr_t>(a.q) |
                          reinterpret_cast<uintptr_t>(a.k) |
                          reinterpret_cast<uintptr_t>(a.v) |
                          reinterpret_cast<uintptr_t>(a.dout);
  if (body == BF16_TMA) {
    const uintptr_t out = kernel == 0 ? reinterpret_cast<uintptr_t>(a.out) : 0;
    if (a.dh % 8 != 0 || (align | out) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return (int)(rows == 64 ? tc::dispatch_dh<1, true>(kernel, a)
                            : tc::dispatch_dh<2, true>(kernel, a));
  }
  if (body != BF16_CP_ASYNC) return (int)cudaErrorInvalidValue;
  // bf16 values a copy: 8-byte cp.async where rows and pointers allow
  a.piece = (a.dh % 4 == 0 && align % 8 == 0)   ? 4
            : (a.dh % 2 == 0 && align % 4 == 0) ? 2
                                                : 1;
  return (int)(rows == 64 ? tc::dispatch_dh<1, false>(kernel, a)
                          : tc::dispatch_dh<2, false>(kernel, a));
}

}  // namespace

// K3. q, out, dout and dq are (bh, t_q, dh), k/v (bh, t_k, dh), all
// contiguous, f32 for body 0 and bf16 for bodies 1 and 2; lse is (bh, t_q)
// f32 from the forward; kv_mask is null or (bh / heads, t_k) uint8. rows
// (64 or 128) is the query rows of a CTA of the bf16 bodies; body 2 needs
// dh % 8 == 0 and 16-byte aligned q, k, v, out and dout. Writes dq and the
// (bh, t_q) f32 delta = rowsum(dout * out) that K4 reads. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int persia_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, const void* kv_mask, void* dq,
    float* delta, int bh, int heads, int t_q, int t_k, int dh, int body,
    int rows, int causal, float scale, void* stream) {
  const Args a{q, k, v, out, dout, lse, delta, kv_mask, dq, nullptr, nullptr,
               bh, heads, t_q, t_k, dh, causal, scale, 0,
               static_cast<cudaStream_t>(stream)};
  return run(0, body, rows, a);
}

// K4. Shapes as for K3; delta is K3's output; rows is the keys of a CTA
// of the bf16 bodies, and body 2 needs 16-byte aligned q, k, v and dout.
// Writes dk and dv, each (bh, t_k, dh) in the input dtype.
extern "C" int persia_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const void* kv_mask, void* dk,
    void* dv, int bh, int heads, int t_q, int t_k, int dh, int body, int rows,
    int causal, float scale, void* stream) {
  const Args a{q, k, v, nullptr, dout, lse, const_cast<float*>(delta),
               kv_mask, nullptr, dk, dv, bh, heads, t_q, t_k, dh, causal,
               scale, 0, static_cast<cudaStream_t>(stream)};
  return run(1, body, rows, a);
}

// Dynamic shared memory of a launch of the bf16 bodies (kernel 0 = K3,
// 1 = K4), for reports.
extern "C" int persia_flash_attention_bwd_smem(int kernel, int rows, int dh) {
  return (int)tc::smem_bytes(kernel, rows, dh);
}

extern "C" const char* persia_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
