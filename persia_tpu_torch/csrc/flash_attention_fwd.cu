// Flash-attention forward for NVIDIA Hopper (sm_90a): kernel K2.
//
// Replaces the Pallas TPU kernel persia_tpu/ops/flash_attention.py:_fwd_kernel
// (driven by flash_attention_fwd_pallas). Same function: online-softmax
// attention over (B*H, T, Dh) with scale 1/sqrt(Dh) of the true Dh, f32
// statistics and accumulation, mask value -1e30 (not -inf), keys past the
// true length masked, optional causal masking (query i sees keys <= i; tiles
// wholly above the diagonal are skipped), an optional (B, T_k) key mask
// broadcast over heads, and a fully masked query row giving 0, not NaN.
// Output in the input dtype. Optionally (the training path) it also writes
// the (B*H, T_q) f32 logsumexp m + log(max(l, 1e-20)) that the backward
// kernels K3/K4 read; a fully masked row keeps m = -1e30, so its lse stays
// <= -1e30 / 2 and the backward forces its probabilities to 0. The serving
// path passes no lse buffer and writes nothing more, as the JAX kernel does.
//
// Two bodies, chosen by the caller (ops/flash_attention.py:fwd_plan):
//
// bf16: the tensor-core body (namespace tc). What bounds it on an H100 SXM
// (989 TFLOP/s bf16 dense, 3.35 TB/s): at the attention-bench shape (B=4,
// H=8, T=8192, Dh=128, causal) the two products are ~5.5e11 FLOP, a 0.56 ms
// floor, against ~0.27 GB of q/k/v/out, 0.08 ms: compute-bound, so both
// products must run on the tensor cores. At the sequence tower's shape
// (B=256, H=4, T=64, Dh=4) it moves ~2.1 MB (0.6 us) and does ~67 MFLOP:
// launch-bound, whatever the body.
// Design: a CTA owns 64 or 128 query rows of one (batch, head): one or two
// consumer warpgroups of 128 threads, 64 rows each. S = Q K^T is a chain of
// wgmma.mma_async m64n64k16 (bf16 in, f32 accumulators in registers) with
// Q and K read from shared memory by descriptor; K is stored (keys, Dh),
// K-major for the B operand. The online softmax runs on the accumulator
// fragment itself (a row's values sit in one quad of threads: two
// shuffles), branch-free, with one ex2 a score. P is rounded to bf16 in
// registers, as the TPU kernel rounds p to v's dtype, and l sums the f32
// p; the fragment is already the A-operand layout of O += P V, a chain of
// register-A wgmma m64nDHPk16 with V read MN-major (the B-transpose bit).
// P V of tile t - 1 is issued right behind S of tile t, so the tensor
// cores finish it while the warpgroup does the softmax of tile t. K/V
// tiles of 64 keys arrive in a ring of three stages (P V keeps a stage
// into the next iteration): one producer warp issues the TMA loads (3-D
// tensor maps over (Dh, T, B*H), zero fill past T and Dh) and stages the
// key-mask bytes; the tiles complete on mbarriers, and a second mbarrier
// per stage tells the producer that every consumer is done with it. Q is
// loaded once. Tiles are stored with the 128-byte swizzle the descriptors
// name (rows of 64 bf16; a 128-wide tile is two 64-column boxes), or the
// 64/32-byte swizzle for Dh <= 32. TMA needs rows that are a multiple of
// 16 bytes; for other Dh (the sequence tower's Dh=4) the consumer threads
// load the same swizzled layout with cp.async, zero-filling the padding
// columns up to a multiple of 16 (the wgmma depth; zero columns leave the
// scores unchanged), and meet at a CTA barrier per tile. The causal mask,
// the T_k edge and the key mask (staged per tile as bytes beside K) are
// applied only on the tiles they cross; a warpgroup skips tiles wholly
// above its diagonal, and the causal grid starts with the longest q-tiles.
// Left on the table: a producer warpgroup with setmaxnreg (more registers
// for the consumers), ping-pong between the two warpgroups so that one's
// softmax always hides under the other's products, 128-key tiles, a TMA
// store of O, a persistent grid.
//
// f32: the CUDA-core body (namespace cc), kept for f32 inputs, whose
// agreement gates need f32 products (TF32 keeps ~3 digits): one CTA of 256
// threads per (batch*head, 64-row q-tile), 64-key tiles staged in shared
// memory as f32, four threads a query row, products on the CUDA cores.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// --- f32 body on the CUDA cores ---------------------------------------------

namespace cc {

constexpr int BQ = 64;            // query rows per CTA
constexpr int BK = 64;            // keys per k-tile
constexpr int GROUP = 4;          // threads per query row
constexpr int NT = BQ * GROUP;    // threads per CTA
constexpr int KPT = BK / GROUP;   // keys each thread scores per tile

template <int DHP>
constexpr size_t smem_bytes() {
  // q tile, k tile, v tile (rows padded by one float against bank
  // conflicts) and the per-row probability strips
  return sizeof(float) *
         (size_t)(BQ * (DHP + 1) + 2 * BK * (DHP + 1) + BQ * (BK + 1));
}

template <int DHP>
__global__ void __launch_bounds__(NT)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const uint8_t* __restrict__ kv_mask,
           float* __restrict__ out, float* __restrict__ lse, int heads,
           int t_q, int t_k, int dh, int causal, float scale) {
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
    q_s[rr * LD + d] = (qi < t_q && d < dh) ? q[q_base + (size_t)qi * dh + d]
                                            : 0.f;
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
      k_s[kk * LD + d] = ok ? k[off] : 0.f;
      v_s[kk * LD + d] = ok ? v[off] : 0.f;
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
      if (d < dh) out[q_base + (size_t)qrow * dh + d] = acc[i] / denom;
    }
    // the row's four threads hold the same m and l after the shuffles
    if (lse != nullptr && j == 0)
      lse[(size_t)bh * t_q + qrow] = m + logf(denom);
  }
}

template <int DHP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_mask, void* out, float* lse, int bh,
                   int heads, int t_q, int t_k, int dh, int causal,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DHP>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fwd_kernel<DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(bh, (t_q + BQ - 1) / BQ);
  fwd_kernel<DHP><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(kv_mask),
      static_cast<float*>(out), lse, heads, t_q, t_k, dh, causal, scale);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* kv_mask, void* out, float* lse, int bh,
                     int heads, int t_q, int t_k, int dh, int causal,
                     float scale, cudaStream_t stream) {
#define PERSIA_FWD_LAUNCH(DHP)                                            \
  return launch<DHP>(q, k, v, kv_mask, out, lse, bh, heads, t_q, t_k, dh, \
                     causal, scale, stream)
  if (dh <= 4) PERSIA_FWD_LAUNCH(4);
  if (dh <= 8) PERSIA_FWD_LAUNCH(8);
  if (dh <= 16) PERSIA_FWD_LAUNCH(16);
  if (dh <= 32) PERSIA_FWD_LAUNCH(32);
  if (dh <= 64) PERSIA_FWD_LAUNCH(64);
  PERSIA_FWD_LAUNCH(128);
#undef PERSIA_FWD_LAUNCH
}

}  // namespace cc

// --- bf16 body on the tensor cores ------------------------------------------

namespace tc {

constexpr int BK = 64;         // keys per k-tile
constexpr int STAGES = 3;      // depth of the K/V ring
constexpr int WG_ROWS = 64;    // query rows of one consumer warpgroup

using namespace sm90;  // wgmma, descriptors, mbarriers, TMA (sm90.cuh)

template <int DHP, int NWG>
struct Shape {
  static constexpr int ROWB = DHP >= 64 ? 128 : DHP * 2;  // tile row bytes
  static constexpr int NCH = DHP * 2 / ROWB;  // 64-column chunks of a row
  static constexpr int BQ = NWG * WG_ROWS;
  static constexpr int NC = NWG * 128;  // consumer threads
  static constexpr int Q_BYTES = BQ * DHP * 2;
  static constexpr int KV_BYTES = BK * DHP * 2;  // K (or V) of one stage
  static constexpr int MASK_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int BAR_OFF = MASK_OFF + STAGES * BK;
  // 1024 bytes of slack to align the tiles for the 128-byte swizzle; the
  // barriers: Q, then full and empty of each stage
  static constexpr size_t SMEM = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
};

// The threads of a CTA: the consumer warpgroups, and with TMA one producer
// warp that keeps the ring full.
template <bool TMA>
constexpr int cta_threads(int nwg) {
  return nwg * 128 + (TMA ? 32 : 0);
}

template <int DHP, int NWG, bool TMA>
__global__ void __launch_bounds__(cta_threads<TMA>(NWG), 1)
fwd_kernel(const __grid_constant__ CUtensorMap map_q,
           const __grid_constant__ CUtensorMap map_k,
           const __grid_constant__ CUtensorMap map_v,
           const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v,
           const uint8_t* __restrict__ kv_mask,
           __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
           int heads, int t_q, int t_k, int dh, int causal, float scale,
           int piece) {
  using S = Shape<DHP, NWG>;
  constexpr int ROWB = S::ROWB, NCH = S::NCH, BQ = S::BQ, NC = S::NC;
  constexpr int NS = BK / 2;   // S accumulators of a thread
  constexpr int NO = DHP / 2;  // O accumulators of a thread

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;
  uint8_t* const base = smem_raw + (sq - raw);
  const uint32_t sk = sq + S::Q_BYTES;
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
  // the causal grid runs its longest q-tiles first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int qw = q0 + wg * WG_ROWS;           // this warpgroup's first row
  const int wg_last = min(qw + WG_ROWS, t_q) - 1;  // < qw: no rows here
  const int row0 = qw + warp * 16 + lane / 4;  // row of h = 0; h = 1 is + 8
  const uint8_t* mask_row =
      kv_mask != nullptr ? kv_mask + (size_t)(bh / heads) * t_k : nullptr;

  int n_k = (t_k + BK - 1) / BK;
  if (causal) n_k = min(n_k, (min(q0 + BQ, t_q) - 1) / BK + 1);
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
    const int k0 = t * BK;
    for (int i = i0; i < BK; i += step)
      mask_s[(t % STAGES) * BK + i] =
          k0 + i < t_k ? mask_row[k0 + i] : (uint8_t)0;
  };

  if (TMA && tid >= NC) {
    // the producer warp: Q once, then each K/V tile into its stage as soon
    // as every consumer is done with the tile that held it
    const int p = tid - NC;
    if (p >= stagers) return;
    if (p == 0) {
      mbar_arrive_tx(bar_q, S::Q_BYTES);
      for (int w = 0; w < NWG; ++w)
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          tma_load(sq + c * BQ * ROWB + w * WG_ROWS * ROWB, &map_q, bar_q,
                   c * 64, q0 + w * WG_ROWS, bh);
    }
    for (int t = 0; t < n_k; ++t) {
      const int s = t % STAGES;
      if (t >= STAGES) mbar_wait(bar_empty + 8 * s, (t / STAGES - 1) & 1);
      if (mask_row != nullptr) stage_mask(t, p, 32);
      if (p == 0) {
        mbar_arrive_tx(bar_full + 8 * s, 2 * S::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const uint32_t off = s * S::KV_BYTES + c * BK * ROWB;
          tma_load(sk + off, &map_k, bar_full + 8 * s, c * 64, t * BK, bh);
          tma_load(sv + off, &map_v, bar_full + 8 * s, c * 64, t * BK, bh);
        }
      } else {
        mbar_arrive(bar_full + 8 * s);
      }
    }
    return;
  }

  // TMA: this consumer thread is done with tile t (every consumer releases
  // every tile, in order)
  auto release = [&](int t) { mbar_arrive(bar_empty + 8 * (t % STAGES)); };
  // cp.async: tile t into its stage, by every thread
  auto load = [&](int t) {
    const int s = t % STAGES;
    const size_t kv_base = (size_t)bh * t_k * dh;
    load_rows<ROWB, NCH, BK>(sk + s * S::KV_BYTES, k + kv_base, t * BK, t_k,
                             dh, piece, tid, NC);
    load_rows<ROWB, NCH, BK>(sv + s * S::KV_BYTES, v + kv_base, t * BK, t_k,
                             dh, piece, tid, NC);
    if (mask_row != nullptr) stage_mask(t, tid, NC);
  };

  if (TMA) {
    mbar_wait(bar_q, 0);
  } else {
    load_rows<ROWB, NCH, BQ>(sq, q + (size_t)bh * t_q * dh, q0, t_q, dh,
                             piece, tid, NC);
    load(0);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // the tiles this warpgroup multiplies: none without rows, and none
  // wholly above its diagonal
  const int n_wg = wg_last < qw ? 0
                   : causal     ? min(n_k, wg_last / BK + 1)
                                : n_k;
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  // running max of rows h = 0, 1, in units of the raw scores q.k
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's share of the running sums
  float sc[NS];             // S, then P in f32, of the newest tile
  uint32_t pa[BK / 16][4];  // P in bf16 of the tile before it
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
  // S = Q K^T of tile t, issued and committed
  auto s_product = [&](int t) {
    const uint32_t k_tile = sk + (t % STAGES) * S::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk) {
      const uint32_t c = kk * 32 / ROWB, in = kk * 32 % ROWB;
      Mma<BK>::ss(sc,
                  desc<ROWB>(sq + c * BQ * ROWB + wg * WG_ROWS * ROWB + in,
                             16, 8 * ROWB),
                  desc<ROWB>(k_tile + c * BK * ROWB + in, 16, 8 * ROWB),
                  kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of tile t with the P in pa, issued and committed
  auto pv_product = [&](int t) {
    const uint32_t v_tile = sv + (t % STAGES) * S::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Mma<DHP>::rs(o, pa[kk],
                   desc<ROWB>(v_tile + kk * 16 * ROWB, BK * ROWB, 8 * ROWB));
    wgmma_commit();
  };
  // the online softmax of tile t on the S fragment: sc[j * 4 + h * 2 + e]
  // is row row0 + 8 h, column k0 + 8 j + quad_col + e. Leaves P (f32) in
  // sc and returns the factors that rescale O.
  auto softmax = [&](int t, float (&alpha)[2]) {
    const int k0 = t * BK;
    // the masks, only on tiles they cross: keys at or past t_k, keys
    // past the row (causal), key-mask zeros
    if (mask_row != nullptr || k0 + BK > t_k ||
        (causal && k0 + BK - 1 > qw)) {
      int lim[2];  // columns of the tile row h may see: [0, lim)
      uint32_t bits = 0xffffffffu;  // bit 2 j + e: key-mask byte
#pragma unroll
      for (int h = 0; h < 2; ++h)
        lim[h] = causal ? min(t_k, row0 + 8 * h + 1) - k0 : t_k - k0;
      if (mask_row != nullptr) {
        const uint8_t* tile_mask = mask_s + (t % STAGES) * BK + quad_col;
        bits = 0;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          bits |= (uint32_t)(tile_mask[8 * j] != 0) << (2 * j) |
                  (uint32_t)(tile_mask[8 * j + 1] != 0) << (2 * j + 1);
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok = 8 * j + quad_col + e < lim[h] &&
                            ((bits >> (2 * j + e)) & 1u);
            sc[j * 4 + h * 2 + e] = ok ? sc[j * 4 + h * 2 + e] : NEG_INF;
          }
    }
    float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mt[h] = fmaxf(mt[h], fmaxf(sc[j * 4 + h * 2], sc[j * 4 + h * 2 + 1]));
    float m_off[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      const float m_new = fmaxf(m[h], mt[h]);
      alpha[h] = ex2((m[h] - m_new) * scale_log2);
      m[h] = m_new;
      // a row with no visible key yet has m == NEG_INF: with an offset of
      // 0, its masked scores give exp2(-1e30 scale) = 0, not exp2(0) = 1
      m_off[h] = m_new > 0.5f * NEG_INF ? m_new * scale_log2 : 0.f;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[j * 4 + h * 2 + e];
          x = ex2(fmaf(x, scale_log2, -m_off[h]));
          rs[h] += x;
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
  };
  // O *= alpha, and P in bf16: the S fragment of keys [16 kk, 16 kk + 16)
  // is the A fragment of the kk-th k16 step
  auto rescale_and_pack = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int j = 0; j < DHP / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[j * 4 + h * 2] *= alpha[h];
        o[j * 4 + h * 2 + 1] *= alpha[h];
      }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
  };

  if (n_wg > 0) {  // warpgroup-uniform
    float alpha[2];
    arrive(0);
    wgmma_fence();
    s_product(0);
    wgmma_wait_all();
    fence_regs(sc);
    softmax(0, alpha);
    rescale_and_pack(alpha);
    for (int t = 1; t < n_wg; ++t) {
      // S of tile t, then P V of tile t - 1 behind it: the softmax of
      // tile t runs while the tensor cores finish P V
      arrive(t);
      wgmma_fence();
      s_product(t);
      pv_product(t - 1);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_regs(sc);
      softmax(t, alpha);
      wgmma_wait_all();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        asm volatile("" : "+r"(pa[kk][0]), "+r"(pa[kk][1]), "+r"(pa[kk][2]),
                     "+r"(pa[kk][3])::"memory");
      if (TMA) release(t - 1);
      rescale_and_pack(alpha);
    }
    wgmma_fence();
    pv_product(n_wg - 1);
    wgmma_wait_all();
    fence_regs(o);
    if (TMA) release(n_wg - 1);
  }
  // the tiles past this warpgroup's diagonal: arrive and release only
  for (int t = n_wg; t < n_k; ++t) {
    arrive(t);
    if (TMA) release(t);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = row0 + 8 * h;
    if (row >= t_q) continue;
    const float denom = fmaxf(l[h], 1e-20f);
    const float inv = 1.f / denom;
    __nv_bfloat16* orow = out + ((size_t)bh * t_q + row) * dh;
#pragma unroll
    for (int j = 0; j < DHP / 8; ++j) {
      const int col = j * 8 + 2 * (lane % 4);
      const float x0 = o[j * 4 + h * 2] * inv, x1 = o[j * 4 + h * 2 + 1] * inv;
      if (col + 1 < dh && dh % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < dh) orow[col] = __float2bfloat16(x0);
        if (col + 1 < dh) orow[col + 1] = __float2bfloat16(x1);
      }
    }
    // the quad's four threads hold the row's m and l
    if (lse != nullptr && lane % 4 == 0)
      lse[(size_t)bh * t_q + row] =
          (m[h] > 0.5f * NEG_INF ? m[h] * scale : NEG_INF) + logf(denom);
  }
}


template <int DHP, int NWG, bool TMA>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_mask, void* out, float* lse, int bh,
                   int heads, int t_q, int t_k, int dh, int causal,
                   float scale, int piece, cudaStream_t stream) {
  using S = Shape<DHP, NWG>;
  // the shared-memory limit is set once on each device (bit `device`)
  static unsigned long long sized = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device >= 64 || !((sized >> device) & 1ull)) {
    e = cudaFuncSetAttribute(fwd_kernel<DHP, NWG, TMA>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)S::SMEM);
    if (e != cudaSuccess) return e;
    if (device < 64) sized |= 1ull << device;
  }
  CUtensorMap maps[3] = {};
  if (TMA && !(make_map(&maps[0], q, bh, t_q, dh, S::ROWB) &&
               make_map(&maps[1], k, bh, t_k, dh, S::ROWB) &&
               make_map(&maps[2], v, bh, t_k, dh, S::ROWB)))
    return cudaErrorNotSupported;
  const dim3 grid(bh, (t_q + S::BQ - 1) / S::BQ);
  fwd_kernel<DHP, NWG, TMA><<<grid, cta_threads<TMA>(NWG), S::SMEM,
                              stream>>>(
      maps[0], maps[1], maps[2], static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const uint8_t*>(kv_mask), static_cast<__nv_bfloat16*>(out),
      lse, heads, t_q, t_k, dh, causal, scale, piece);
  return cudaGetLastError();
}

template <int NWG, bool TMA>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v,
                        const void* kv_mask, void* out, float* lse, int bh,
                        int heads, int t_q, int t_k, int dh, int causal,
                        float scale, int piece, cudaStream_t stream) {
#define PERSIA_TC_LAUNCH(DHP)                                          \
  return launch<DHP, NWG, TMA>(q, k, v, kv_mask, out, lse, bh, heads, \
                               t_q, t_k, dh, causal, scale, piece, stream)
  if (dh <= 16) PERSIA_TC_LAUNCH(16);
  if (dh <= 32) PERSIA_TC_LAUNCH(32);
  if (dh <= 64) PERSIA_TC_LAUNCH(64);
  PERSIA_TC_LAUNCH(128);
#undef PERSIA_TC_LAUNCH
}

size_t smem_bytes(int block_q, int dh) {
  const int nwg = block_q / WG_ROWS;
#define PERSIA_TC_SMEM(DHP) \
  return nwg == 1 ? Shape<DHP, 1>::SMEM : Shape<DHP, 2>::SMEM
  if (dh <= 16) PERSIA_TC_SMEM(16);
  if (dh <= 32) PERSIA_TC_SMEM(32);
  if (dh <= 64) PERSIA_TC_SMEM(64);
  PERSIA_TC_SMEM(128);
#undef PERSIA_TC_SMEM
}

}  // namespace tc

}  // namespace

// The bodies, as ops/flash_attention.py:fwd_plan names them.
enum Body { F32_CUDA_CORES = 0, BF16_CP_ASYNC = 1, BF16_TMA = 2 };

// q is (bh, t_q, dh), k/v (bh, t_k, dh), out like q, all contiguous, f32
// for body 0 and bf16 for bodies 1 and 2; kv_mask is null or
// (bh / heads, t_k) uint8; lse is null (serving) or (bh, t_q) f32. block_q
// (64 or 128) is the query rows of a CTA of the bf16 bodies. Body 2 needs
// dh % 8 == 0 and 16-byte aligned q, k, v. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int persia_flash_attention_fwd(const void* q, const void* k,
                                          const void* v, const void* kv_mask,
                                          void* out, float* lse, int bh,
                                          int heads, int t_q, int t_k, int dh,
                                          int body, int block_q, int causal,
                                          float scale, void* stream) {
  if (bh <= 0 || heads <= 0 || t_q <= 0 || t_k <= 0 || dh <= 0 || dh > 128 ||
      bh % heads != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == F32_CUDA_CORES)
    return (int)cc::dispatch(q, k, v, kv_mask, out, lse, bh, heads, t_q, t_k,
                             dh, causal, scale, s);
  if (block_q != 64 && block_q != 128) return (int)cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  if (body == BF16_TMA) {
    if (dh % 8 != 0 || align % 16 != 0) return (int)cudaErrorInvalidValue;
    return (int)(block_q == 64
                     ? tc::dispatch_dh<1, true>(q, k, v, kv_mask, out, lse,
                                                bh, heads, t_q, t_k, dh,
                                                causal, scale, 0, s)
                     : tc::dispatch_dh<2, true>(q, k, v, kv_mask, out, lse,
                                                bh, heads, t_q, t_k, dh,
                                                causal, scale, 0, s));
  }
  if (body != BF16_CP_ASYNC) return (int)cudaErrorInvalidValue;
  // bf16 values a copy: 8-byte cp.async where rows and pointers allow
  const int piece = (dh % 4 == 0 && align % 8 == 0)   ? 4
                    : (dh % 2 == 0 && align % 4 == 0) ? 2
                                                      : 1;
  return (int)(block_q == 64
                   ? tc::dispatch_dh<1, false>(q, k, v, kv_mask, out, lse, bh,
                                               heads, t_q, t_k, dh, causal,
                                               scale, piece, s)
                   : tc::dispatch_dh<2, false>(q, k, v, kv_mask, out, lse, bh,
                                               heads, t_q, t_k, dh, causal,
                                               scale, piece, s));
}

// Dynamic shared memory of a launch of the bf16 bodies, for reports.
extern "C" int persia_flash_attention_fwd_smem(int block_q, int dh) {
  return (int)tc::smem_bytes(block_q, dh);
}

extern "C" const char* persia_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
