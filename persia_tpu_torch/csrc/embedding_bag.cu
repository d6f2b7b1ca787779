// Embedding bag (gather + weighted pool) for NVIDIA Hopper (sm_90a): K1.
//
// Replaces the Pallas TPU kernel persia_tpu/ops/embedding_bag.py:
// _packed_bag_kernel (driven by pallas_embedding_bag_packed). Same function:
//   out[b, :] = sum_s w[b, s] * table[row(ids[b, s]), :]
// over a (V, D) f32 table and (B, S) integer ids. The TPU kernel lane-packs
// the table into (ceil(V/P), 128) rows (P = 128 / D) because Mosaic cannot
// DMA a sub-(8, 128) row; that packing is TPU tiling only, so this kernel
// reads the plain (V, D) table, takes any D >= 1 and any B.
//
// One launch pools several slots (tables) at once: the slots travel as an
// array of descriptors in the kernel's parameters (at most MAX_SLOTS a
// launch; the caller splits above that), and the output is (B, slots, D),
// so one sample's slots sit side by side. Two modes, one body:
// - clip (the Pallas kernel's function, one slot): row = clip(id, 0, V-1)
//   and the caller's f32 weights, f32 output;
// - hash (device mode's DeviceEmbeddingCollection,
//   persia_tpu/parallel/device_embedding.py:70-78, fused in): mask = id > 0,
//   row = mask ? id % (V - 1) + 1 : 0, w = mask; the output is the f32 sum
//   rounded once to bf16 (or kept f32), and the rows read are written as
//   int32 for the backward's scatter-add. A padding id (0 or negative)
//   reads row 0 with weight 0, so every row is in range.
// Either mode takes a shard window (lo, n): the table holds the global rows
// [lo, lo + n) of a vocab-row table (device mode's tables row-sharded over
// a mesh's model axis, persia_tpu/parallel/device_embedding.py:40-46). The
// row is computed over the global vocab as above; a row outside the window
// contributes nothing and is recorded as -1, a row inside reads local row
// row - lo and is recorded as such. A padding id reads global row 0, so it is
// local row 0 (weight 0) on the shard that holds row 0 and -1 on the others.
// The output is then this shard's partial sum (the caller sums the shards
// and casts). The whole table is the window (0, vocab): the unsharded call.
// Products and sums are rounded one by one in s order (no fused
// multiply-add), as the plain version rounds them: bit-equal at S = 1.
//
// What bounds it on an H100 SXM (3.35 TB/s): 2 FLOP per 4-byte table
// element read, so bytes. Device mode's call (26 tables of 2^20 x 16, B =
// 4096, S = 1) reads ~26 x 4096 scattered 64-byte rows, the ids, and
// writes the rows and the bf16 output: ~11 MB, ~3.3 us, while a launch
// costs ~2 us. So the call is one launch instead of 26, and within it the
// time is DRAM latency of scattered rows, which only memory-level
// parallelism hides.
//
// Design: a CTA owns one slot and a tile of samples (grid = slots x sample
// tiles, plus a column-chunk dimension for rows wider than a CTA). Where D
// % 4 == 0 and the tables are 16-byte aligned a row is read as float4s: a
// 64-byte row is four neighbouring threads, one 16-byte load each, and a
// warp covers eight rows. Each thread keeps ITEMS = 4 independent row loads
// in flight before it accumulates: four samples at one s when the bags are
// short (device mode, S = 1), one sample at four consecutive s otherwise.
// Registers are capped at 64 a thread (four CTAs of 256 an SM), so that
// device mode's 416 CTAs run in one wave. The launcher shrinks the CTA
// and the tile until the grid has two CTAs per SM, so a single short
// table still spreads over the card. Other D,
// or unaligned tables, take the scalar body: one float a thread. No shared
// memory, no atomics, deterministic. Left for later: staging rows with
// cp.async / TMA gathers, and sorting ids to read each distinct row once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MIN_THREADS = 64;
constexpr int ITEMS = 4;  // independent row loads in flight a thread
constexpr int MAX_SLOTS = 64;
constexpr int DESC_WORDS = 9;  // int64 words of one slot's descriptor
// CTAs of MAX_THREADS resident per SM: registers are capped so that
// device mode's 26 x 16 CTAs fit the 132 SMs in one wave
constexpr int MIN_CTAS_PER_SM = 4;

struct Slot {
  const float* table;    // (vocab, dim) f32
  const void* ids;       // (batch, bag) int32 or int64
  const float* weights;  // (batch, bag) f32 (clip mode); unused in hash mode
  int32_t* rows;         // (batch, bag) int32 rows read, or null
  int vocab;  // the global rows the ids hash or clip into
  int bag;
  int ids64;
  int lo;  // the window: this table holds global rows [lo, lo + n)
  int n;
};

struct Params {
  Slot slot[MAX_SLOTS];
  void* out;     // (batch, out_cols, dim) f32 or bf16
  int out_cols;  // slots in one sample's output row
  int slot0;     // output column of slot[0]
  int batch;
  int dim;
  int lanes;  // threads that share one row (vectors or floats of it)
  int tiles;  // sample tiles per slot
};
// kernel parameters are limited to 4 KB
static_assert(sizeof(Params) <= 4096, "descriptors exceed 4 KB of params");

template <bool VEC>
struct Row;
template <>
struct Row<true> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T axpy(T acc, float w, T x) {
    return make_float4(__fadd_rn(acc.x, __fmul_rn(w, x.x)),
                       __fadd_rn(acc.y, __fmul_rn(w, x.y)),
                       __fadd_rn(acc.z, __fmul_rn(w, x.z)),
                       __fadd_rn(acc.w, __fmul_rn(w, x.w)));
  }
};
template <>
struct Row<false> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static T axpy(T acc, float w, T x) {
    return __fadd_rn(acc, __fmul_rn(w, x));
  }
};

__device__ __forceinline__ void store(float* out, float4 v) {
  *reinterpret_cast<float4*>(out) = v;
}
__device__ __forceinline__ void store(float* out, float v) { *out = v; }
__device__ __forceinline__ void store(__nv_bfloat16* out, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 packed;
  packed.x = *reinterpret_cast<const uint32_t*>(&lo);
  packed.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out) = packed;
}
__device__ __forceinline__ void store(__nv_bfloat16* out, float v) {
  *out = __float2bfloat16_rn(v);
}

// The global row an id reads (in [0, vocab - 1], so it fits an int) and its
// weight. Hash mode does its arithmetic in the ids' own width (an int32
// id's modulo stays 32-bit).
template <bool HASH>
__device__ __forceinline__ int global_row(const Slot& sd, int64_t i,
                                          float* w) {
  if (sd.ids64) {
    const int64_t id = static_cast<const int64_t*>(sd.ids)[i];
    if (HASH) {
      *w = id > 0 ? 1.f : 0.f;
      return id > 0 ? static_cast<int>(id % (sd.vocab - 1)) + 1 : 0;
    }
    *w = sd.weights[i];
    return id < 0 ? 0
                  : (id >= sd.vocab ? sd.vocab - 1 : static_cast<int>(id));
  }
  const int32_t id = static_cast<const int32_t*>(sd.ids)[i];
  if (HASH) {
    *w = id > 0 ? 1.f : 0.f;
    return id > 0 ? id % (sd.vocab - 1) + 1 : 0;
  }
  *w = sd.weights[i];
  return min(max(id, 0), sd.vocab - 1);
}

// The local row of the window an id reads, or -1 for a row outside it.
template <bool HASH>
__device__ __forceinline__ int row_of(const Slot& sd, int64_t i, float* w) {
  const int local = global_row<HASH>(sd, i, w) - sd.lo;
  return static_cast<unsigned>(local) < static_cast<unsigned>(sd.n) ? local
                                                                    : -1;
}

// SAMPLES x SPAN == ITEMS: each thread keeps SAMPLES samples and SPAN
// consecutive s of each in flight.
template <bool HASH, typename OutT, bool VEC, int SAMPLES>
__global__ void __launch_bounds__(MAX_THREADS, MIN_CTAS_PER_SM)
    bag_kernel(const __grid_constant__ Params p) {
  constexpr int SPAN = ITEMS / SAMPLES;
  using R = Row<VEC>;
  using T = typename R::T;
  const int slot = blockIdx.x / p.tiles;
  const int tile = blockIdx.x - slot * p.tiles;
  const Slot& sd = p.slot[slot];
  const int lanes = p.lanes;
  const int per_pass = blockDim.x / lanes;  // samples side by side
  const int r = threadIdx.x / lanes;
  if (r >= per_pass) return;
  const int width = VEC ? p.dim / 4 : p.dim;  // vectors (floats) in a row
  const int col = blockIdx.y * lanes + (threadIdx.x - r * lanes);
  if (col >= width) return;
  const bool write_rows = sd.rows != nullptr && col == 0;
  const T* table = reinterpret_cast<const T*>(sd.table);
  const int64_t b0 =
      static_cast<int64_t>(tile) * per_pass * SAMPLES + r;

  T acc[SAMPLES];
#pragma unroll
  for (int u = 0; u < SAMPLES; ++u) acc[u] = R::zero();
  for (int s = 0; s < sd.bag; s += SPAN) {
    int row[SAMPLES][SPAN];
    float w[SAMPLES][SPAN];
#pragma unroll
    for (int u = 0; u < SAMPLES; ++u) {
      const int64_t b = b0 + static_cast<int64_t>(u) * per_pass;
#pragma unroll
      for (int k = 0; k < SPAN; ++k) {
        row[u][k] = -1;
        if (b < p.batch && s + k < sd.bag) {
          const int64_t i = b * sd.bag + s + k;
          row[u][k] = row_of<HASH>(sd, i, &w[u][k]);
          if (write_rows) sd.rows[i] = row[u][k];
        }
      }
    }
    // every load first, then the sums in s order
    T x[SAMPLES][SPAN];
#pragma unroll
    for (int u = 0; u < SAMPLES; ++u)
#pragma unroll
      for (int k = 0; k < SPAN; ++k)
        if (row[u][k] >= 0)
          x[u][k] =
              __ldg(table + static_cast<int64_t>(row[u][k]) * width + col);
#pragma unroll
    for (int u = 0; u < SAMPLES; ++u)
#pragma unroll
      for (int k = 0; k < SPAN; ++k)
        if (row[u][k] >= 0) acc[u] = R::axpy(acc[u], w[u][k], x[u][k]);
  }
  OutT* out = static_cast<OutT*>(p.out);
  const int64_t row_stride = static_cast<int64_t>(p.out_cols) * p.dim;
  const int64_t at = static_cast<int64_t>(p.slot0 + slot) * p.dim +
                     static_cast<int64_t>(col) * (VEC ? 4 : 1);
#pragma unroll
  for (int u = 0; u < SAMPLES; ++u) {
    const int64_t b = b0 + static_cast<int64_t>(u) * per_pass;
    if (b < p.batch) store(out + b * row_stride + at, acc[u]);
  }
}

template <bool HASH, typename OutT>
cudaError_t launch(const Params& p, bool vec, bool wide, dim3 grid,
                   int threads, cudaStream_t stream) {
  if (vec) {
    if (wide)
      bag_kernel<HASH, OutT, true, ITEMS><<<grid, threads, 0, stream>>>(p);
    else
      bag_kernel<HASH, OutT, true, 1><<<grid, threads, 0, stream>>>(p);
  } else {
    if (wide)
      bag_kernel<HASH, OutT, false, ITEMS><<<grid, threads, 0, stream>>>(p);
    else
      bag_kernel<HASH, OutT, false, 1><<<grid, threads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// Pool n_slots slots into out (batch, out_cols, dim), f32 or (out_bf16)
// bf16, columns slot0 .. slot0 + n_slots - 1, and (rows not null) write
// each slot's int32 local rows read (-1: outside the window) into rows. desc holds
// DESC_WORDS int64 words a slot: table pointer, ids pointer, weights
// pointer (0 in hash mode), the slot's offset in rows (elements), vocab,
// bag, ids element size (4 or 8), and the window's lo and n (the table's
// rows; 0 and vocab for a whole table). hash selects the device-mode hash and mask; otherwise
// ids are clipped and the weights read, and the output must be f32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int persia_embedding_bag_slots(const int64_t* desc, int n_slots,
                                          int batch, int dim, void* out,
                                          void* rows, int out_cols,
                                          int slot0, int out_bf16, int hash,
                                          void* stream) {
  if (desc == nullptr || out == nullptr || n_slots <= 0 ||
      n_slots > MAX_SLOTS || batch <= 0 || dim <= 0 || slot0 < 0 ||
      slot0 + n_slots > out_cols || (out_bf16 && !hash))
    return (int)cudaErrorInvalidValue;
  Params p;
  int max_bag = 0;
  bool aligned = dim % 4 == 0 &&
                 reinterpret_cast<uintptr_t>(out) % (out_bf16 ? 8 : 16) == 0;
  for (int i = 0; i < n_slots; ++i) {
    const int64_t* d = desc + static_cast<int64_t>(i) * DESC_WORDS;
    Slot& s = p.slot[i];
    s.table = reinterpret_cast<const float*>(d[0]);
    s.ids = reinterpret_cast<const void*>(d[1]);
    s.weights = reinterpret_cast<const float*>(d[2]);
    s.rows = rows == nullptr ? nullptr : static_cast<int32_t*>(rows) + d[3];
    if (d[3] < 0 || d[4] < (hash ? 2 : 1) || d[4] > 0x7fffffff || d[5] < 0 ||
        d[5] > 0x7fffffff || (d[6] != 4 && d[6] != 8) ||
        s.table == nullptr || (d[5] > 0 && s.ids == nullptr) ||
        (!hash && d[5] > 0 && s.weights == nullptr) || d[7] < 0 ||
        d[8] < 1 || d[7] + d[8] > d[4])
      return (int)cudaErrorInvalidValue;
    s.vocab = static_cast<int>(d[4]);
    s.bag = static_cast<int>(d[5]);
    s.ids64 = d[6] == 8;
    s.lo = static_cast<int>(d[7]);
    s.n = static_cast<int>(d[8]);
    max_bag = std::max(max_bag, s.bag);
    aligned = aligned && reinterpret_cast<uintptr_t>(s.table) % 16 == 0;
  }
  p.out = out;
  p.out_cols = out_cols;
  p.slot0 = slot0;
  p.batch = batch;
  p.dim = dim;
  const int width = aligned ? dim / 4 : dim;
  p.lanes = std::min(width, MAX_THREADS);
  const int chunks = (width + p.lanes - 1) / p.lanes;
  // short bags keep ITEMS samples in flight a thread, long ones ITEMS s
  const bool wide = max_bag < ITEMS;
  const int samples = wide ? ITEMS : 1;
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return (int)cudaGetLastError();
  int threads = MAX_THREADS;
  auto tiles_for = [&](int t) {
    const int64_t tile = static_cast<int64_t>(t / p.lanes) * samples;
    return (batch + tile - 1) / tile;
  };
  // smaller CTAs (never narrower than a row) until there are two per SM
  while (threads > MIN_THREADS && threads / 2 >= p.lanes &&
         tiles_for(threads) * n_slots * chunks < 2 * sms)
    threads /= 2;
  const int64_t tiles = tiles_for(threads);
  if (tiles * n_slots > 0x7fffffff || chunks > 65535)
    return (int)cudaErrorInvalidValue;
  p.tiles = static_cast<int>(tiles);
  const dim3 grid(static_cast<unsigned>(tiles * n_slots),
                  static_cast<unsigned>(chunks));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!hash)
    return (int)launch<false, float>(p, aligned, wide, grid, threads, s);
  if (out_bf16)
    return (int)launch<true, __nv_bfloat16>(p, aligned, wide, grid, threads, s);
  return (int)launch<true, float>(p, aligned, wide, grid, threads, s);
}

extern "C" int persia_embedding_bag_max_slots() { return MAX_SLOTS; }

extern "C" const char* persia_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
