// Row-wise Adagrad for NVIDIA Hopper (sm_90a): optax.adagrad's update of
// only the rows a sparse (row) gradient holds.
//
// Replaces no TPU kernel: the JAX package updates its tables with XLA's
// dense optax.adagrad, and the port's OptaxAdagrad did the same with five
// foreach passes over every table, ~52 bytes an element a step, though a
// step touches a sliver of the rows. A row without a gradient gets exactly
// no change (s + 0 = s, p - lr * 0 * rsqrt(s + eps) = p), so updating only
// the touched rows is the same function.
//
// The gradient of table t is an uncoalesced list of (row, D-float vector)
// ids, one per id the forward pooled (K1's backward,
// persia_tpu_torch/ops/embedding_bag.py), many on one row. Per distinct row
// the update is, in f32 and rounded op by op as the foreach passes are:
//   g = sum of the row's vectors
//   s <- s + g * g
//   p <- p + (-lr) * (rsqrt(s + eps) * g)
// elementwise, and an element whose g is exactly 0 is left alone (its
// update is exactly none).
//
// Two entries, a sort between them (torch.sort, stable, in the wrapper):
// - persia_rowwise_adagrad_keys writes one int32 key per id, the table's
//   first key plus the row (keys of all tables in one space: table t owns
//   [key0_t, key0_t + rows_t)); an id outside its table gets the key
//   `total`, past every table, and is dropped;
// - persia_rowwise_adagrad_update takes the stably sorted keys and the
//   permutation, sums each key's vectors and updates its row.
//
// The sum is a segmented reduction by levels. At each level the items
// (keys sorted) are cut into chunks of CHUNK; one team of threads (one
// float4 of the row a thread) walks its chunk in order and sums each run
// of equal keys. A run that lies wholly in the chunk is a row's whole
// gradient: the team updates the row. A run that continues into the
// neighbouring chunk is a partial: the chunk hands its first and its last
// run on as two items (key, partial sum) of the next level, in order, so
// the next level's keys are sorted again (a slot with nothing to hand on
// carries its key and zeros, which add nothing and update nothing). The
// levels shrink the items 16-fold each until one chunk holds them all. So
// a run of any length (the multi-hot benchmark's ~800k padding ids on row
// 0, a Zipf head's thousands) costs time linear in its ids, spread over many teams, with no
// atomics; the order of every sum is fixed by the number of ids alone, so
// the result repeats bit for bit from run to run.
//
// What bounds it on an H100 (3.35 TB/s): bytes. Each id's vector is read
// once (level 0 gathers it through the permutation), each touched row's
// parameter and accumulator are read and written once; the later levels
// move 1/16 of the first's bytes and less. No shared memory; up to
// MAX_TABLES tables a launch, their descriptors in the kernel's parameters.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 32;  // items a team sums in order at each level
constexpr int ITEMS = 4;   // independent loads in flight a thread
constexpr int MAX_TABLES = 64;
constexpr int DESC_WORDS = 7;  // int64 words of one table's descriptor

struct Table {
  float* param;         // (rows, dim) f32
  float* sum;           // (rows, dim) f32 accumulator
  const float* values;  // (count, dim) f32 gradient vectors, one an id
  const int64_t* idx;   // (count,) rows of the ids
  int64_t start;        // the table's first id among all tables' ids
  int key0;             // the table's first key
  int rows;
};

struct Params {
  Table t[MAX_TABLES];
  int n_tables;
  int width;  // vectors (float4s or floats) in a row
  int lanes;  // threads of one team: one vector of the row each
  int total;  // the keys of all tables; the key of a dropped id
  float neg_lr;
  float eps;
};
// kernel parameters are limited to 4 KB
static_assert(sizeof(Params) + 64 <= 4096, "descriptors exceed 4 KB");

struct Level {
  const int32_t* keys;  // (n,) sorted
  const int64_t* perm;  // level 0: each sorted item's id
  const float* vals;    // later levels: (n, dim) partial sums
  int32_t* out_keys;    // (2 * teams,) or null on the last level
  float* out_vals;      // (2 * teams, dim)
  int64_t n;
  int64_t teams;
};

template <bool VEC>
struct Vec;
template <>
struct Vec<true> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T add(T a, T b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                       __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
  }
  __device__ static bool is_zero(T a) {
    return a.x == 0.f && a.y == 0.f && a.z == 0.f && a.w == 0.f;
  }
};
template <>
struct Vec<false> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static T add(T a, T b) { return __fadd_rn(a, b); }
  __device__ static bool is_zero(T a) { return a == 0.f; }
};

// The last table whose first id is at or before id i (an empty table shares
// its start with the next one, which is the one that holds i).
__device__ __forceinline__ int table_of_id(const Params& p, int64_t i) {
  int lo = 0, hi = p.n_tables - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (p.t[mid].start <= i)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// The table that owns key k (< total): the last whose key0 is at most k.
__device__ __forceinline__ int table_of_key(const Params& p, int k) {
  int lo = 0, hi = p.n_tables - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (p.t[mid].key0 <= k)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

__global__ void keys_kernel(const __grid_constant__ Params p, int64_t n,
                            int32_t* keys) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const Table& t = p.t[table_of_id(p, i)];
  const int64_t r = t.idx[i - t.start];
  keys[i] = r >= 0 && r < t.rows ? t.key0 + static_cast<int>(r) : p.total;
}

__device__ __forceinline__ void adagrad(float& s, float& w, float g,
                                        float neg_lr, float eps) {
  if (g != 0.f) {
    s = __fadd_rn(s, __fmul_rn(g, g));
    w = __fadd_rn(w, __fmul_rn(neg_lr, __fmul_rn(rsqrtf(__fadd_rn(s, eps)),
                                                 g)));
  }
}
__device__ __forceinline__ void adagrad(float4& s, float4& w, float4 g,
                                        float neg_lr, float eps) {
  adagrad(s.x, w.x, g.x, neg_lr, eps);
  adagrad(s.y, w.y, g.y, neg_lr, eps);
  adagrad(s.z, w.z, g.z, neg_lr, eps);
  adagrad(s.w, w.w, g.w, neg_lr, eps);
}

// Key k's whole gradient g (this thread's vector of it): update its row.
template <bool VEC>
__device__ __forceinline__ void update(const Params& p, int k, int col,
                                       typename Vec<VEC>::T g) {
  using T = typename Vec<VEC>::T;
  if (k >= p.total || Vec<VEC>::is_zero(g)) return;
  const Table& t = p.t[table_of_key(p, k)];
  const int64_t at = static_cast<int64_t>(k - t.key0) * p.width + col;
  T* s = reinterpret_cast<T*>(t.sum) + at;
  T* w = reinterpret_cast<T*>(t.param) + at;
  T sv = *s, wv = *w;
  adagrad(sv, wv, g, p.neg_lr, p.eps);
  *s = sv;
  *w = wv;
}

// Item j's vector: at level 0 its id's gradient vector (a dropped id's is
// zero), later the partial sum the level below handed on.
template <bool FIRST, bool VEC>
__device__ __forceinline__ typename Vec<VEC>::T load(const Params& p,
                                                     const Level& l,
                                                     int64_t j, int k,
                                                     int col) {
  using T = typename Vec<VEC>::T;
  if (FIRST) {
    if (k >= p.total) return Vec<VEC>::zero();
    const Table& t = p.t[table_of_key(p, k)];
    const int64_t id = l.perm[j] - t.start;
    return __ldg(reinterpret_cast<const T*>(t.values) + id * p.width + col);
  }
  return __ldg(reinterpret_cast<const T*>(l.vals) + j * p.width + col);
}

template <bool FIRST, bool VEC>
__global__ void __launch_bounds__(THREADS)
    level_kernel(const __grid_constant__ Params p, const Level l) {
  using R = Vec<VEC>;
  using T = typename R::T;
  const int lanes = p.lanes;
  const int per_cta = THREADS / lanes;
  const int member = threadIdx.x / lanes;
  if (member >= per_cta) return;
  const int64_t team = static_cast<int64_t>(blockIdx.x) * per_cta + member;
  if (team >= l.teams) return;
  const int col = blockIdx.y * lanes + (threadIdx.x - member * lanes);
  if (col >= p.width) return;
  const int64_t a = team * CHUNK;
  const int64_t b = a + CHUNK < l.n ? a + CHUNK : l.n;
  // keys are >= 0: -1 continues nothing
  const int before = a > 0 ? l.keys[a - 1] : -1;
  const int after = b < l.n ? l.keys[b] : -1;
  int cur = l.keys[a];
  T acc = R::zero(), head = R::zero(), tail = R::zero();
  bool first = true;  // cur is the chunk's first run
  for (int64_t j0 = a; j0 < b; j0 += ITEMS) {
    int k[ITEMS];
    T v[ITEMS];
    // every load first, then the sums in order
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      k[u] = j0 + u < b ? l.keys[j0 + u] : -1;
      v[u] = k[u] >= 0 ? load<FIRST, VEC>(p, l, j0 + u, k[u], col)
                       : R::zero();
    }
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      if (k[u] < 0) continue;
      if (k[u] != cur) {  // the run of cur ends inside the chunk
        if (first && cur == before)
          head = acc;
        else
          update<VEC>(p, cur, col, acc);
        first = false;
        cur = k[u];
        acc = R::zero();
      }
      acc = R::add(acc, v[u]);
    }
  }
  if (cur == after) {
    if (first)
      head = acc;
    else
      tail = acc;
  } else if (first && cur == before) {
    head = acc;
  } else {
    update<VEC>(p, cur, col, acc);
  }
  if (l.out_keys == nullptr) return;  // the last level: nothing continues
  const int64_t slot = 2 * team;
  if (col == 0) {
    l.out_keys[slot] = l.keys[a];
    l.out_keys[slot + 1] = l.keys[b - 1];
  }
  T* out = reinterpret_cast<T*>(l.out_vals);
  out[slot * p.width + col] = head;
  out[(slot + 1) * p.width + col] = tail;
}

template <bool FIRST>
cudaError_t launch_level(const Params& p, const Level& l, bool vec,
                         int chunks, cudaStream_t stream) {
  const int per_cta = THREADS / p.lanes;
  const int64_t ctas = (l.teams + per_cta - 1) / per_cta;
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(ctas), static_cast<unsigned>(chunks));
  if (vec)
    level_kernel<FIRST, true><<<grid, THREADS, 0, stream>>>(p, l);
  else
    level_kernel<FIRST, false><<<grid, THREADS, 0, stream>>>(p, l);
  return cudaGetLastError();
}

// Reads n_tables descriptors of DESC_WORDS int64 words: param, accumulator,
// values and rows pointers, the table's first id, its first key and its
// rows. Checks them (the first ids in order from 0, at most n; the keys
// back to back from 0 up to total) and fills p; *aligned says whether every
// row can be read as float4s.
bool read_tables(const int64_t* desc, int n_tables, int dim, int64_t n,
                 int total, Params* p, bool* aligned) {
  if (desc == nullptr || n_tables <= 0 || n_tables > MAX_TABLES ||
      dim <= 0 || n < 0 || total <= 0)
    return false;
  *aligned = dim % 4 == 0;
  int64_t key = 0;
  for (int i = 0; i < n_tables; ++i) {
    const int64_t* d = desc + static_cast<int64_t>(i) * DESC_WORDS;
    const int64_t end = i + 1 < n_tables ? d[DESC_WORDS + 4] : n;
    Table& t = p->t[i];
    t.param = reinterpret_cast<float*>(d[0]);
    t.sum = reinterpret_cast<float*>(d[1]);
    t.values = reinterpret_cast<const float*>(d[2]);
    t.idx = reinterpret_cast<const int64_t*>(d[3]);
    if (t.param == nullptr || t.sum == nullptr || d[4] < 0 || end < d[4] ||
        (i == 0 && d[4] != 0) || d[5] != key || d[6] < 1 ||
        (end > d[4] && (t.values == nullptr || t.idx == nullptr)))
      return false;
    t.start = d[4];
    t.key0 = static_cast<int>(d[5]);
    t.rows = static_cast<int>(d[6]);
    key += d[6];
    for (const void* ptr : {static_cast<const void*>(t.param),
                            static_cast<const void*>(t.sum),
                            static_cast<const void*>(t.values)})
      *aligned = *aligned && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  }
  if (key != total) return false;
  p->n_tables = n_tables;
  p->total = total;
  return true;
}

// A row as float4s (vec) or floats; a team holds one row, a vector a thread
// (rows wider than THREADS vectors take several column chunks).
int set_width(Params* p, int dim, bool vec) {
  p->width = vec ? dim / 4 : dim;
  p->lanes = std::min(p->width, THREADS);
  return (p->width + p->lanes - 1) / p->lanes;
}

}  // namespace

// Write the int32 key of each of the n ids of n_tables tables (ids in table
// order, each table's from its descriptor's start on): key0 + row, or total
// for a row outside its table. Returns the cudaError_t of the launch.
extern "C" int persia_rowwise_adagrad_keys(const int64_t* desc, int n_tables,
                                           int dim, int64_t n, int total,
                                           int32_t* keys, void* stream) {
  Params p;
  bool aligned;
  if (!read_tables(desc, n_tables, dim, n, total, &p, &aligned) ||
      (n > 0 && keys == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int64_t ctas = (n + THREADS - 1) / THREADS;
  if (ctas > 0x7fffffff) return (int)cudaErrorInvalidValue;
  keys_kernel<<<static_cast<unsigned>(ctas), THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(p, n, keys);
  return (int)cudaGetLastError();
}

// The update: skeys (n,) the keys stably sorted, perm (n,) each sorted key's
// id. scratch_keys and scratch_vals hold cap_a + cap_b items of the partial
// levels (int32 keys; dim f32 a vector): cap_a >= 2 * ceil(n / CHUNK), cap_b
// >= 2 * ceil(cap_a / CHUNK) when there is more than one chunk. Launches
// one kernel a level. Returns the cudaError_t of the launches.
extern "C" int persia_rowwise_adagrad_update(
    const int64_t* desc, int n_tables, int dim, float lr, float eps, int total,
    int64_t n, const int32_t* skeys, const int64_t* perm,
    int32_t* scratch_keys, float* scratch_vals, int64_t cap_a, int64_t cap_b,
    void* stream) {
  Params p;
  bool vec;
  if (!read_tables(desc, n_tables, dim, n, total, &p, &vec) ||
      (n > 0 && (skeys == nullptr || perm == nullptr)) || cap_a < 0 ||
      cap_b < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  p.neg_lr = -lr;
  p.eps = eps;
  vec = vec && reinterpret_cast<uintptr_t>(scratch_vals) % 16 == 0;
  const int chunks = set_width(&p, dim, vec);
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Level l;
  l.keys = skeys;
  l.perm = perm;
  l.vals = nullptr;
  l.n = n;
  int32_t* buf_keys[2] = {scratch_keys, scratch_keys + cap_a};
  float* buf_vals[2] = {scratch_vals, scratch_vals + cap_a * dim};
  const int64_t caps[2] = {cap_a, cap_b};
  for (int level = 0;; ++level) {
    l.teams = (l.n + CHUNK - 1) / CHUNK;
    const bool last = l.teams == 1;
    const int which = level % 2;
    if (!last && (2 * l.teams > caps[which] ||
                  buf_keys[which] == nullptr || buf_vals[which] == nullptr))
      return (int)cudaErrorInvalidValue;
    l.out_keys = last ? nullptr : buf_keys[which];
    l.out_vals = last ? nullptr : buf_vals[which];
    const cudaError_t err =
        level == 0 ? launch_level<true>(p, l, vec, chunks, s)
                   : launch_level<false>(p, l, vec, chunks, s);
    if (err != cudaSuccess) return (int)err;
    if (last) break;
    l.keys = l.out_keys;
    l.vals = l.out_vals;
    l.perm = nullptr;
    l.n = 2 * l.teams;
  }
  return (int)cudaSuccess;
}

extern "C" int persia_rowwise_adagrad_chunk() { return CHUNK; }

extern "C" const char* persia_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
