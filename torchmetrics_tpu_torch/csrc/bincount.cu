// Batched weighted bincount for NVIDIA Hopper (sm_90a), bound to Python with ctypes.
//
//   out[s][b] = sum_i w[s][i] * [idx[s or 0][i] == b]   for s in [0, S), b in [0, num_bins)
//
// `idx` is either one (N,) row shared by all S weight rows or S rows of its
// own; w == nullptr counts ones into an int32 histogram (then idx has S
// rows), otherwise weights accumulate into a float32 one. Indices outside
// [0, num_bins) contribute nothing. S == 1 is the 1-D bincount.
//
// Replaces the Pallas TPU kernel torchmetrics_tpu/ops/bincount.py:38
// (`_kernel`, launched by `pl.pallas_call` at :89 through `_bincount_pallas`),
// and, for S > 1, `jax.vmap` over it. That kernel does a sequential
// compare-and-reduce over a (bin tile, n tile) grid, race-free only because a
// TPU runs its grid in order. Blocks on Hopper run in parallel and in no
// order, so each plan below decides who adds into a counter instead.
//
// Bound: the work is one add per (input, weight row), so bytes decide. Each
// input byte read once and the output written once:
//   shared idx   N*4 + S*N*4 + S*bins*4 bytes
//   per-row idx  S*N*8 + S*bins*4 bytes (S*N*4 + S*bins*4 unweighted)
// For sparse calls the output term dominates: writing it once is the bound.
//
// Design: one call is one of three plans, which the host chooses
// (ops/bincount.py `launch_plan`) and this file launches:
//   * Counters that fit one CTA's shared memory (`smem_histogram_kernel`):
//     each CTA holds every counter and counts with shared-memory atomics.
//     One CTA for small calls (it stores `out`); else a persistent grid,
//     about one CTA per SM and sized by the host from the SM count, not from
//     N, each streaming disjoint inputs with 16-byte loads (int4 indices,
//     float4 weights), several vectors a thread in flight before their adds,
//     and adding its counters into the zeroed `out` with bulk reductions
//     (`cp.reduce.async.bulk`, in pieces started at a different place by each
//     CTA) and atomics for ragged ends. The host keeps CTAs x counters x 4
//     bytes of reductions within the input bytes.
//   * Counters that do not fit (the global plan): `out` is zeroed
//     on the same stream and every input is added straight into it with a
//     global reduction (`red.global.add`, native for int32 and float32 on
//     sm_90). Each of these histograms fits in the 50 MB L2 many times over,
//     so the reductions resolve there. `global_vector_kernel`: a
//     grid-stride over 16-byte vectors of the inputs, four vectors a thread
//     in flight, for one or two weight rows an index row;
//     `global_scalar_kernel`: one input a thread, for small calls and more
//     than two weight rows over a shared index, where the sweep measured it
//     faster. Zero weights skipped.
//     Nothing is staged, merged or read twice. This replaced a thread-block
//     cluster plan (the bins spread over the distributed shared memory of up
//     to 16 CTAs, inputs multicast to each by TMA): its
//     per-stage cluster barriers, multicast staging of every stream,
//     compare-and-swap float adds in shared memory and merge of clusters x
//     counters into `out` lost to global reductions at every point of
//     bincount_ablation.py's sweep (PERF.md).
//   * Many float32 weight rows over one shared index (`rows_histogram_kernel`,
//     the per-cluster sums of (N, D) features, passed as the (D, N) view
//     `data.T`): a CTA owns a tile of up to 1,024 weight rows ("columns", 64
//     a warp, two a lane) and a tile of bins, with a bins x columns float32
//     sum in shared memory. It lists the samples of each block of 8,192
//     labels that fall in its bins, in sample order (ballots, a count per
//     warp), and every warp walks that list: for each sample it loads its 64
//     weights and each lane adds its two columns. So every sum has one
//     owner, which adds in sample order, with no atomics, and the CTA reads a
//     sample's weights as one contiguous 4 KB piece when they are the
//     transpose of a contiguous (N, S) matrix (read through its strides as
//     they lie). A warp keeps two batches of 8 samples' loads in flight; the
//     next block's labels load while a list is added. Bins past shared
//     memory take more bin tiles, each reading only its own samples' weights
//     (and every label); where column and bin tiles do not fill the SMs the
//     samples are cut into chunks whose sums a second kernel adds in chunk
//     order. Two runs give the same bits.
//   * Each row's misaligned head and ragged tail, and inputs whose streams
//     are not equally aligned, take a scalar loop (first two plans).
//   * Zero weights are skipped by the first two plans: adding +-0 leaves a
//     float32 sum that started at +0 unchanged, and the metric path's masks
//     are mostly 0.
//
// Exactness: int32 counts are exact. Float32 sums of weights that are
// integers (the 0/1 masks of the metric path) are exact and independent of
// order while every bin stays below 2^24, the ceiling the JAX package
// documents (stat_scores.py:293-297, precision_recall_curve.py:113-118).
// The rows plan adds arbitrary float32 weights in a fixed order: per chunk in
// sample order, then the chunks in order, so its sums are the same bits on
// every run (with one chunk, those of a sequential sum in sample order). The
// first two plans add arbitrary float32 weights by atomics in an order that
// changes from run to run, so such results may differ in the last bits
// between runs.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// Mirrors the ctypes structure `_PlanStruct` in ops/bincount.py. At file
// scope: a type of the unnamed namespace would give tm_bincount internal
// linkage.
struct Plan {
  int n;          // inputs per row
  int rows;       // index rows: 1 (shared by every weight row) or out_rows
  int wrows;      // weight rows per index row: out_rows (shared idx) or 1
  int num_bins;
  int kind;       // 0: counters in shared memory, 1: global reductions, 2: rows plan
  int ctas;       // kinds 0 and 1: CTAs in the grid
  int vectors;    // kinds 0 and 1: 16-byte vectors where aligned (else one input a thread)
  int tiles;      // kind 2: bin tiles
  int tile_bins;  // kind 2: bins per tile
  int chunks;     // kind 2: sample chunks, added in chunk order by a second kernel
  int w_row_stride;  // kind 2: elements between weight rows
  int w_col_stride;  // kind 2: elements between the weights of consecutive inputs
  int device;
};

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most one Hopper block may use
constexpr int kMaxDevices = 64;
constexpr int kReducePiece = 1024;     // counters per bulk reduction
constexpr int kVectors = 4;            // global plan: 16-byte vectors a thread has in flight
constexpr int kRowsWarps = kThreads / 32;
constexpr int kRowsWarpCols = 64;      // rows plan: weight rows ("columns") a warp owns, two a lane
constexpr int kRowsBatch = 8;          // rows plan: samples a warp loads before it adds them
constexpr int kRowsGroups = 16;        // rows plan: groups of 32 labels a warp lists per block
constexpr int kRowsBlock = kThreads * kRowsGroups;  // rows plan: labels a CTA lists per block
constexpr int kRowsShift = 13;         // rows plan: a list entry's block offset bits
static_assert(kRowsBlock == 1 << kRowsShift, "a list entry packs the block offset below the local bin");

enum Kind { kSmem = 0, kGlobal = 1, kRows = 2 };

struct Args {
  const int32_t* idx;
  const float* w;
  void* out;
  float* scratch;  // rows plan with chunks > 1: (chunks, S, num_bins) partial sums
  int n, rows, wrows, out_rows, num_bins, row_stride;
  int head, nv, tail;  // per row: scalar head, 4-input vectors, scalar tail
  int reduce;          // shared-memory plan of several CTAs: add into a zeroed `out`, else store
  int tile_bins, tile_cols, chunk_n;
  long long w_row_stride, w_col_stride;
};

__host__ __device__ constexpr int align_up(int x, int a) { return (x + a - 1) / a * a; }

// counters of output row s and bin b: rows are padded so that every row's
// first counter has the phase mod 16 bytes of its place in `out`
__device__ __forceinline__ int counter(const Args& a, int s, int b) {
  return s * a.row_stride + ((s * a.num_bins) & 3) + b;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void red_local(uint32_t addr, float v) {
  asm volatile("red.shared.add.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void red_local(uint32_t addr, int v) {
  asm volatile("red.shared.add.s32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// No "memory" clobber: nothing in a kernel reads `out` after adding into it,
// so the loads of later inputs may be issued ahead of these reductions.
__device__ __forceinline__ void red_global(float* p, float v) {
  asm volatile("red.global.add.f32 [%0], %1;" ::"l"(p), "f"(v));
}

__device__ __forceinline__ void red_global(int* p, int v) {
  asm volatile("red.global.add.s32 [%0], %1;" ::"l"(p), "r"(v));
}

__device__ __forceinline__ void bulk_reduce(void* gmem, uint32_t smem, int bytes, float) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;" ::"l"(gmem),
               "r"(smem), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_reduce(void* gmem, uint32_t smem, int bytes, int) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.u32 [%0], [%1], %2;" ::"l"(gmem),
               "r"(smem), "r"(bytes) : "memory");
}

__device__ __forceinline__ int lane_of(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The element of vector q: its row, and its offset in the index and in a
// weight row. Row r's vectors start after its scalar head.
__device__ __forceinline__ size_t vector_element(const Args& a, unsigned q, unsigned& r) {
  r = a.rows == 1 ? 0u : q / static_cast<unsigned>(a.nv);
  return r * static_cast<size_t>(a.n) + a.head + 4 * static_cast<size_t>(q - r * a.nv);
}

// The element of scalar input j (each row's head, then its tail).
__device__ __forceinline__ size_t scalar_element(const Args& a, unsigned j, unsigned& r) {
  const int sc = a.head + a.tail;
  r = a.rows == 1 ? 0u : j / static_cast<unsigned>(sc);
  const unsigned t = j - r * sc;
  return r * static_cast<size_t>(a.n) + (t < static_cast<unsigned>(a.head) ? t : t + 4 * static_cast<size_t>(a.nv));
}

// ---------------------------------------------------------------------------
// Counters in shared memory. kK: weight rows per index row when known at
// compile time (1 or 2), 0 for a runtime count. Unweighted launches have kK == 1.
template <typename T, bool kWeighted, int kK>
__global__ void __launch_bounds__(kThreads) smem_histogram_kernel(const __grid_constant__ Args a) {
  constexpr int kUnroll = kK == 1 ? 4 : 2;
  constexpr int kW = kK > 0 ? kK : 1;  // weight vectors held per input vector
  extern __shared__ __align__(16) unsigned char smem[];
  T* hist = reinterpret_cast<T*>(smem);
  const int hist_elems = a.out_rows * a.row_stride;
  const int wrows = kWeighted ? (kK > 0 ? kK : a.wrows) : 0;
  const size_t n = static_cast<size_t>(a.n);
  const unsigned bins = static_cast<unsigned>(a.num_bins);
  const unsigned tid = threadIdx.x;
  auto add = [&](int s, int b, T v) { red_local(smem_addr(hist + counter(a, s, b)), v); };

  for (int j = tid; j < hist_elems; j += kThreads) hist[j] = T(0);
  __syncthreads();

  // a grid-stride over 16-byte vectors, kUnroll of them loaded before their adds
  const unsigned gtid = blockIdx.x * kThreads + tid;
  const unsigned gstride = gridDim.x * kThreads;
  const unsigned nvec = static_cast<unsigned>(a.rows) * static_cast<unsigned>(a.nv);
  for (unsigned q0 = gtid; q0 < nvec; q0 += gstride * kUnroll) {
    int4 iv[kUnroll];
    float4 wv[kUnroll][kW];
    int row[kUnroll];
    size_t e[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned q = q0 + u * gstride;
      row[u] = -1;
      if (q < nvec) {
        unsigned r;
        e[u] = vector_element(a, q, r);
        row[u] = static_cast<int>(r);
        iv[u] = __ldg(reinterpret_cast<const int4*>(a.idx + e[u]));
        if (kWeighted && kK > 0) {
#pragma unroll
          for (int k = 0; k < kW; ++k) wv[u][k] = __ldg(reinterpret_cast<const float4*>(a.w + e[u] + k * n));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (row[u] < 0) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int b = lane_of(iv[u], i);
        if (static_cast<unsigned>(b) >= bins) continue;
        if (!kWeighted) {
          add(row[u], b, T(1));
        } else if (kK > 0) {
#pragma unroll
          for (int k = 0; k < kW; ++k) {
            const float v = lane_of(wv[u][k], i);
            if (v != 0.0f) add(row[u] + k, b, T(v));
          }
        } else {
          for (int k = 0; k < wrows; ++k) {
            const float v = __ldg(a.w + e[u] + k * n + i);
            if (v != 0.0f) add(row[u] + k, b, T(v));
          }
        }
      }
    }
  }

  // scalar inputs: each row's head and tail, or every input without vectors
  const unsigned nsc = static_cast<unsigned>(a.rows) * static_cast<unsigned>(a.head + a.tail);
  for (unsigned j = gtid; j < nsc; j += gstride) {
    unsigned r;
    const size_t e = scalar_element(a, j, r);
    const int b = __ldg(a.idx + e);
    if (static_cast<unsigned>(b) >= bins) continue;
    if (kWeighted) {
      for (int k = 0; k < wrows; ++k) {
        const float v = __ldg(a.w + e + k * n);
        if (v != 0.0f) add(static_cast<int>(r) + k, b, T(v));
      }
    } else {
      add(static_cast<int>(r), b, T(1));
    }
  }

  __syncthreads();
  T* out = static_cast<T*>(a.out);
  if (!a.reduce) {
    for (int s = 0; s < a.out_rows; ++s) {
      T* dst = out + static_cast<size_t>(s) * a.num_bins;
      for (int j = tid; j < a.num_bins; j += kThreads) dst[j] = hist[counter(a, s, j)];
    }
    return;
  }
  // add this CTA's counters into the zeroed output: a bulk reduction of each
  // row's 16-byte-aligned middle, atomics for its ragged ends
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  for (int s = 0; s < a.out_rows; ++s) {
    const size_t g0 = static_cast<size_t>(s) * a.num_bins;
    const int lead = min(a.num_bins, static_cast<int>((4 - (g0 & 3)) & 3));
    const int body = (a.num_bins - lead) & ~3;
    if (tid == 0 && body > 0) {
      // in pieces, each CTA starting at another piece, so that CTAs adding
      // the same counters spread over the output
      const int pieces = (body + kReducePiece - 1) / kReducePiece;
      const int first = static_cast<int>(blockIdx.x) % pieces;
      for (int p = 0; p < pieces; ++p) {
        const int off = ((p + first) % pieces) * kReducePiece;
        bulk_reduce(out + g0 + lead + off, smem_addr(hist + counter(a, s, lead + off)),
                    min(kReducePiece, body - off) * 4, T(0));
      }
    }
    for (int j = tid; j < a.num_bins; j += kThreads) {
      if (j >= lead && j < lead + body) continue;
      const T v = hist[counter(a, s, j)];
      if (v != T(0)) atomicAdd(out + g0 + j, v);
    }
  }
  if (tid == 0) {
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// Global reductions into the zeroed output: input (row r, bin b) adds into
// out[r][b]; over a shared index, weight row k's into out[k][b].

// One 16-byte vector of indices and their weights (or ones) into `dst`.
template <typename T>
__device__ __forceinline__ void add_vector(T* dst, const int4& iv, const float4& wv, unsigned bins) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = lane_of(iv, i);
    const float v = lane_of(wv, i);
    if (static_cast<unsigned>(b) < bins && v != 0.0f) red_global(dst + b, T(v));
  }
}

// One input a thread: a grid-stride over the (rows, n) index; over a shared
// index input j's weight rows lie n apart, per-row indices have one each.
template <typename T, bool kWeighted>
__global__ void __launch_bounds__(kThreads) global_scalar_kernel(const __grid_constant__ Args a) {
  T* out = static_cast<T*>(a.out);
  const size_t n = static_cast<size_t>(a.n);
  const size_t total = static_cast<size_t>(a.rows) * n;
  const int wrows = kWeighted ? a.wrows : 0;
  for (size_t j = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; j < total;
       j += static_cast<size_t>(gridDim.x) * kThreads) {
    const int b = __ldg(a.idx + j);
    if (static_cast<unsigned>(b) >= static_cast<unsigned>(a.num_bins)) continue;
    T* dst = out + (a.rows == 1 ? 0 : j / n) * a.num_bins + b;
    if constexpr (kWeighted) {
      for (int k = 0; k < wrows; ++k) {
        const float v = __ldg(a.w + j + k * n);
        if (v != 0.0f) red_global(dst + static_cast<size_t>(k) * a.num_bins, v);
      }
    } else {
      red_global(dst, 1);
    }
  }
}

// 16-byte vectors, kK (1 or 2) weight rows per index row: a grid-stride over
// the vectors, then each row's scalar head and tail.
template <typename T, bool kWeighted, int kK>
__global__ void __launch_bounds__(kThreads) global_vector_kernel(const __grid_constant__ Args a) {
  static_assert(kK == 1 || kK == 2, "vectors for one or two weight rows an index row");
  T* out = static_cast<T*>(a.out);
  const size_t n = static_cast<size_t>(a.n);
  const unsigned bins = static_cast<unsigned>(a.num_bins);
  const unsigned gtid = blockIdx.x * kThreads + threadIdx.x;
  const unsigned gthreads = gridDim.x * kThreads;
  const unsigned nvec = static_cast<unsigned>(a.rows) * static_cast<unsigned>(a.nv);
  const float4 ones = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  // a step gives each thread kVectors vectors, gthreads apart (the grid's
  // first vectors before anyone's second), all loaded before their adds
  for (unsigned q0 = gtid; q0 < nvec; q0 += gthreads * kVectors) {
    int4 iv[kVectors];
    float4 wv[kVectors][kK];
    int row[kVectors];
#pragma unroll
    for (int u = 0; u < kVectors; ++u) {
      const unsigned q = q0 + u * gthreads;
      row[u] = -1;
      if (q < nvec) {
        unsigned r;
        const size_t e = vector_element(a, q, r);
        row[u] = static_cast<int>(r);
        iv[u] = __ldg(reinterpret_cast<const int4*>(a.idx + e));
        if constexpr (kWeighted) {
#pragma unroll
          for (int k = 0; k < kK; ++k) wv[u][k] = __ldg(reinterpret_cast<const float4*>(a.w + e + k * n));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kVectors; ++u) {
      if (row[u] < 0) continue;
      T* dst = out + static_cast<size_t>(row[u]) * a.num_bins;
      if constexpr (!kWeighted) {
        add_vector(dst, iv[u], ones, bins);
      } else {
#pragma unroll
        for (int k = 0; k < kK; ++k) add_vector(dst + static_cast<size_t>(k) * a.num_bins, iv[u], wv[u][k], bins);
      }
    }
  }

  // each row's scalar head and tail
  const unsigned nsc = static_cast<unsigned>(a.rows) * static_cast<unsigned>(a.head + a.tail);
  for (unsigned j = gtid; j < nsc; j += gthreads) {
    unsigned r;
    const size_t e = scalar_element(a, j, r);
    const int b = __ldg(a.idx + e);
    if (static_cast<unsigned>(b) >= bins) continue;
    T* dst = out + static_cast<size_t>(r) * a.num_bins + b;
    if constexpr (kWeighted) {
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const float v = __ldg(a.w + e + k * n);
        if (v != 0.0f) red_global(dst + static_cast<size_t>(k) * a.num_bins, v);
      }
    } else {
      red_global(dst, 1);
    }
  }
}

// ---------------------------------------------------------------------------
// Rows plan. CTA (column tile x, bin tile y, sample chunk z): warp w owns
// columns 64w + lane and 64w + 32 + lane of the tile, for every bin of the
// tile; every warp walks the same list of the block's samples in the tile.

struct RowsBatch {
  int entry[kRowsBatch];  // list entry: block offset | local bin << kRowsShift, or -1
  float lo[kRowsBatch], hi[kRowsBatch];
};

__global__ void __launch_bounds__(kThreads) rows_histogram_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* list = reinterpret_cast<int*>(smem);  // the block's samples in the tile, in order
  int* warp_count = list + kRowsBlock;
  float* acc = reinterpret_cast<float*>(warp_count + kRowsWarps);
  const int tile_cols = a.tile_cols;
  const int pitch = tile_cols + 1;
  const int col0 = static_cast<int>(blockIdx.x) * tile_cols;
  const int bin0 = static_cast<int>(blockIdx.y) * a.tile_bins;
  const unsigned nb = static_cast<unsigned>(min(a.tile_bins, a.num_bins - bin0));
  const int i0 = static_cast<int>(blockIdx.z) * a.chunk_n;
  const int i1 = min(a.n, i0 + a.chunk_n);
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int warp = static_cast<int>(threadIdx.x >> 5);
  const int c_lo = warp * kRowsWarpCols + lane;
  const int c_hi = c_lo + 32;
  const bool lo_ok = c_lo < tile_cols && col0 + c_lo < a.wrows;
  const bool hi_ok = c_hi < tile_cols && col0 + c_hi < a.wrows;
  const float* w_lo = a.w + (lo_ok ? col0 + c_lo : 0) * a.w_row_stride;
  const float* w_hi = a.w + (hi_ok ? col0 + c_hi : 0) * a.w_row_stride;

  for (unsigned j = threadIdx.x; j < nb * pitch; j += kThreads) acc[j] = 0.0f;
  // this warp's labels of a block, 32 a step: local bins (>= nb: not in the tile)
  unsigned lb[kRowsGroups];
  auto load_labels = [&](int first) {
#pragma unroll
    for (int j = 0; j < kRowsGroups; ++j) {
      const int i = first + warp * 32 * kRowsGroups + j * 32 + lane;
      lb[j] = i < i1 ? static_cast<unsigned>(__ldg(a.idx + i)) - static_cast<unsigned>(bin0) : 0xffffffffu;
    }
  };
  load_labels(i0);
  for (int first = i0; first < i1; first += kRowsBlock) {
    // the block's samples in the tile, in sample order: each warp counts its
    // 32 * kRowsGroups labels' samples, then writes them after the counts of
    // the warps before it
    unsigned mask[kRowsGroups];
    int total = 0;
#pragma unroll
    for (int j = 0; j < kRowsGroups; ++j) {
      mask[j] = __ballot_sync(0xffffffffu, lb[j] < nb);
      total += __popc(mask[j]);
    }
    if (lane == 0) warp_count[warp] = total;
    __syncthreads();  // the counts, and (first block) the zeroed sums
    int pos = 0, count = 0;
    for (int v = 0; v < kRowsWarps; ++v) {
      const int c = warp_count[v];
      pos += v < warp ? c : 0;
      count += c;
    }
#pragma unroll
    for (int j = 0; j < kRowsGroups; ++j) {
      if (lb[j] < nb) {
        const int offset = warp * 32 * kRowsGroups + j * 32 + lane;
        list[pos + __popc(mask[j] & ((1u << lane) - 1))] = offset | static_cast<int>(lb[j] << kRowsShift);
      }
      pos += __popc(mask[j]);
    }
    __syncthreads();  // the list is whole
    if (first + kRowsBlock < i1) load_labels(first + kRowsBlock);  // in flight while the list is added

    auto fill = [&](RowsBatch& t, int start) {
#pragma unroll
      for (int k = 0; k < kRowsBatch; ++k) {
        t.entry[k] = start + k < count ? list[start + k] : -1;
        t.lo[k] = t.hi[k] = 0.0f;
        if (t.entry[k] >= 0) {
          const long long i = first + (t.entry[k] & (kRowsBlock - 1));
          if (lo_ok) t.lo[k] = __ldg(w_lo + i * a.w_col_stride);
          if (hi_ok) t.hi[k] = __ldg(w_hi + i * a.w_col_stride);
        }
      }
    };
    auto add = [&](const RowsBatch& t) {
#pragma unroll
      for (int k = 0; k < kRowsBatch; ++k) {
        if (t.entry[k] < 0) continue;
        // only a lane's own columns: past the tile's, `row` would be the next bin's
        float* row = acc + (t.entry[k] >> kRowsShift) * pitch;
        if (lo_ok) row[c_lo] += t.lo[k];
        if (hi_ok) row[c_hi] += t.hi[k];
      }
    };
    // two batches in turn, the next one's loads in flight while this one is
    // added (no copy between them: a copy would wait for the loads)
    RowsBatch even, odd;
    fill(even, 0);
    for (int start = 0; start < count; start += 2 * kRowsBatch) {
      fill(odd, start + kRowsBatch);
      add(even);
      fill(even, start + 2 * kRowsBatch);
      add(odd);
    }
    __syncthreads();  // every warp is done with the list before the next block's
  }
  __syncthreads();

  float* dst = a.scratch != nullptr ? a.scratch + static_cast<size_t>(blockIdx.z) * a.wrows * a.num_bins
                                    : static_cast<float*>(a.out);
  const int cols = min(tile_cols, a.wrows - col0);
  for (unsigned j = threadIdx.x; j < static_cast<unsigned>(cols) * nb; j += kThreads) {
    const unsigned c = j / nb;
    const unsigned b = j - c * nb;
    dst[static_cast<size_t>(col0 + c) * a.num_bins + bin0 + b] = acc[b * pitch + c];
  }
}

// out = the chunks' partial sums added in chunk order.
__global__ void __launch_bounds__(kThreads) rows_merge_kernel(const float* part, float* out, size_t count,
                                                              int chunks) {
  for (size_t j = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; j < count;
       j += static_cast<size_t>(gridDim.x) * kThreads) {
    float s = part[j];
    for (int c = 1; c < chunks; ++c) s += part[c * count + j];
    out[j] = s;
  }
}

// ---------------------------------------------------------------------------
// Launches.

// Opts `kernel` in to 227 KB of dynamic shared memory. The attribute is per
// device, so each caller keeps its own record of the devices it configured.
cudaError_t configure(void (*kernel)(Args), int device, bool (&configured)[kMaxDevices]) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (configured[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (err == cudaSuccess) configured[device] = true;
  return err;
}

size_t out_bytes(const Args& a, size_t elem) { return static_cast<size_t>(a.out_rows) * a.num_bins * elem; }

template <typename T, bool kWeighted, int kK>
cudaError_t launch_smem(const Plan& p, const Args& a, cudaStream_t stream) {
  auto kernel = smem_histogram_kernel<T, kWeighted, kK>;
  static bool configured[kMaxDevices] = {};  // once per instantiation and device
  cudaError_t err = configure(kernel, p.device, configured);
  if (err != cudaSuccess) return err;
  const size_t smem = align_up(a.out_rows * a.row_stride * static_cast<int>(sizeof(T)), 16);
  if (smem > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  if (a.reduce && (err = cudaMemsetAsync(a.out, 0, out_bytes(a, sizeof(T)), stream)) != cudaSuccess) return err;
  kernel<<<p.ctas, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The global plan: vectors where the host chose them and the inputs allow
// (a.nv > 0), else one input a thread; vectors only for kK of 1 or 2.
template <typename T, bool kWeighted, int kK>
cudaError_t launch_global(const Plan& p, const Args& a, cudaStream_t stream) {
  const cudaError_t err = cudaMemsetAsync(a.out, 0, out_bytes(a, sizeof(T)), stream);
  if (err != cudaSuccess) return err;
  if constexpr (kK == 1 || kK == 2) {
    if (a.nv > 0) {
      global_vector_kernel<T, kWeighted, kK><<<p.ctas, kThreads, 0, stream>>>(a);
      return cudaGetLastError();
    }
  } else {
    if (a.nv > 0) return cudaErrorInvalidValue;
  }
  global_scalar_kernel<T, kWeighted><<<p.ctas, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_rows(const Plan& p, const Args& a, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  cudaError_t err = configure(rows_histogram_kernel, p.device, configured);
  if (err != cudaSuccess) return err;
  const size_t smem = (kRowsBlock + kRowsWarps) * sizeof(int) +
                      static_cast<size_t>(p.tile_bins) * (a.tile_cols + 1) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  const dim3 grid((p.wrows + a.tile_cols - 1) / a.tile_cols, p.tiles, p.chunks);
  rows_histogram_kernel<<<grid, kThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess || p.chunks == 1) return err;
  const size_t count = static_cast<size_t>(a.wrows) * a.num_bins;
  const size_t ctas = (count + kThreads - 1) / kThreads;
  rows_merge_kernel<<<static_cast<unsigned>(ctas < 4096 ? ctas : 4096), kThreads, 0, stream>>>(
      a.scratch, static_cast<float*>(a.out), count, p.chunks);
  return cudaGetLastError();
}

template <typename T, bool kWeighted, int kK>
cudaError_t launch_kind(const Plan& p, const Args& a, cudaStream_t s) {
  return p.kind == kSmem ? launch_smem<T, kWeighted, kK>(p, a, s) : launch_global<T, kWeighted, kK>(p, a, s);
}

cudaError_t dispatch(const Plan& p, const Args& a, cudaStream_t s) {
  if (p.kind == kRows) return a.w == nullptr || a.rows != 1 ? cudaErrorInvalidValue : launch_rows(p, a, s);
  if (a.w == nullptr) return launch_kind<int, false, 1>(p, a, s);
  // one weight row per index row (per-row indices, the 1-D entry) and two
  // (the binned curve) are the metric path's; any other count takes a
  // runtime loop over the rows (the global plan: one input a thread)
  switch (a.wrows) {
    case 1: return launch_kind<float, true, 1>(p, a, s);
    case 2: return launch_kind<float, true, 2>(p, a, s);
    default: return launch_kind<float, true, 0>(p, a, s);
  }
}

}  // namespace

// Launches the plan on `stream` and returns its cudaError_t (0 on success);
// nothing is synchronised. `w == nullptr` counts into int32, else float32
// sums. `out` holds max(rows, wrows) * num_bins elements; `scratch` (rows
// plan with chunks > 1, else unused) chunks * wrows * num_bins floats. The
// caller guarantees n > 0, contiguous index rows (and weight rows, except in
// the rows plan, which reads them through the plan's strides), a
// 16-byte-aligned `out`, shared memory within 227 KB and every count below
// 2^31.
extern "C" int tm_bincount(const Plan* plan, const void* idx, const void* w, void* out, void* scratch,
                           void* stream) {
  const Plan& p = *plan;
  Args a;
  a.idx = static_cast<const int32_t*>(idx);
  a.w = static_cast<const float*>(w);
  a.out = out;
  a.scratch = p.kind == kRows && p.chunks > 1 ? static_cast<float*>(scratch) : nullptr;
  a.n = p.n;
  a.rows = p.rows;
  a.wrows = p.wrows;
  a.out_rows = p.rows > p.wrows ? p.rows : p.wrows;
  a.num_bins = p.num_bins;
  a.row_stride = align_up(p.num_bins, 4) + 4;
  a.reduce = p.ctas > 1;
  a.tile_bins = p.tile_bins;
  // rows plan: the CTA's columns, 64 a warp, at most the weight rows rounded up
  const int cols = align_up(p.wrows, kRowsWarpCols);
  a.tile_cols = cols < kRowsWarps * kRowsWarpCols ? cols : kRowsWarps * kRowsWarpCols;
  a.chunk_n = (p.n + p.chunks - 1) / (p.chunks > 0 ? p.chunks : 1);
  a.w_row_stride = p.w_row_stride;
  a.w_col_stride = p.w_col_stride;
  // Vectors need every stream of a row at one phase mod 16 bytes: the same
  // base phase for idx and w, and rows that start at one phase (n % 4 == 0)
  // unless there is a single stream pair.
  const uintptr_t ip = reinterpret_cast<uintptr_t>(idx);
  const uintptr_t wp = reinterpret_cast<uintptr_t>(w);
  const bool one_pair = p.rows == 1 && p.wrows == 1;
  const bool vec = p.vectors && (w == nullptr || wp % 16 == ip % 16) && (p.n % 4 == 0 || one_pair);
  if (vec) {
    const int head = static_cast<int>(((16 - ip % 16) % 16) / 4);
    a.head = head < p.n ? head : p.n;
    a.nv = (p.n - a.head) / 4;
    a.tail = p.n - a.head - 4 * a.nv;
  } else {
    a.head = p.n;
    a.nv = 0;
    a.tail = 0;
  }

  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != p.device && (err = cudaSetDevice(p.device)) != cudaSuccess) return static_cast<int>(err);
  err = dispatch(p, a, static_cast<cudaStream_t>(stream));
  if (current != p.device) {
    const cudaError_t restore = cudaSetDevice(current);
    if (err == cudaSuccess) err = restore;
  }
  return static_cast<int>(err);
}

extern "C" const char* tm_bincount_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
