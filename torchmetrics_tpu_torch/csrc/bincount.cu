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
// order, so this is a histogram in shared memory instead.
//
// Bound: the work is one add per (input, weight row), so bytes decide. Each
// input byte read once and the output written once:
//   shared idx   N*4 + S*N*4 + S*bins*4 bytes
//   per-row idx  S*N*8 + S*bins*4 bytes (S*N*4 + S*bins*4 unweighted)
// For sparse calls the output term dominates: writing it once is the bound.
//
// Design: one launch of `histogram_kernel` per call (after a memset of
// `out` when several clusters add into it), or of `sparse_histogram_kernel`
// after a memset of `out` for sparse calls.
//   * Small calls (every counter in one CTA, a few thousand inputs): one CTA
//     counts everything with shared-memory atomics and stores `out`.
//   * Counters that fit one CTA, many inputs: a persistent grid of such CTAs,
//     about one per SM and sized by the host plan from the SM count, not
//     from N, each streaming disjoint inputs with 16-byte loads (int4
//     indices, float4 weights), several vectors a thread in flight before
//     their adds.
//   * More counters than one CTA holds: the histogram is spread over the
//     distributed shared memory of a thread-block cluster. CTA `rank` owns
//     bins [rank * bs, (rank + 1) * bs) of every output row. The cluster
//     streams chunks of the inputs: each CTA bulk-copies its part of a chunk
//     (indices and weight rows) with one multicast TMA copy into every CTA
//     of the cluster, so each input byte leaves device memory once, and each
//     CTA counts the inputs whose bins it owns with local atomics. Two
//     stages with mbarriers: the next chunk lands while one is counted, and
//     cluster.sync() frees a stage. Adding into the owner's shared memory
//     from wherever an input is read (`mapa` + `red.shared::cluster`) was
//     measured slower than this on the card (PERF.md) and is kept only for
//     the few scalar inputs below. The bins are tiled over gridDim.y, each
//     tile re-reading the inputs, only past 16 CTAs (the largest cluster
//     Hopper launches, non-portable above 8).
//   * Each row's misaligned head and ragged tail, and inputs whose streams
//     are not equally aligned, take a scalar loop.
//   * Merge: with one cluster per tile, its CTAs store their bins into
//     `out`. With several, `out` is zeroed and each cluster adds its counters
//     with bulk reductions (`cp.reduce.async.bulk`, in pieces started at a
//     different place by each cluster) and atomics for ragged ends: clusters
//     * S * bins * 4 bytes of reductions into `out`, which the plan keeps
//     within the input bytes. No scratch is allocated.
//   * Sparse calls (the host plan's `sparse`: the counters do not fit one
//     CTA and each output row gets far fewer inputs than it has bins, as in
//     a 1,000 x 1,000 confusion matrix of 1,000 samples): `out` is zeroed
//     and `sparse_histogram_kernel` adds every input straight into it with a
//     global atomic (`red.global.add`, native for int32 and float32 on
//     sm_90). No shared-memory histogram is zeroed and flushed, and no bin
//     tile re-reads the inputs, so the time is the output's memset and the
//     launch; the bound there is writing the output once.
//   * Zero weights are skipped: adding +-0 leaves a float32 sum that started
//     at +0 unchanged, and the metric path's masks are mostly 0.
// What it does about each cause of the first design's distance from the
// bound: inputs read once (clusters instead of bin tiles, shared idx, one
// launch for S rows); bytes in flight (persistent grid, 16-byte loads and
// bulk copies); partials (one per cluster, bounded by the plan, added in
// place with no second pass); launches (one per batched call).
// Float32 atomics on shared memory are compare-and-swap loops on sm_90
// (integer ones are native), which bounds the weighted counting.
//
// Exactness: int32 counts are exact. Float32 sums of weights that are
// integers (the 0/1 masks of the metric path) are exact and independent of
// order while every bin stays below 2^24, the ceiling the JAX package
// documents (stat_scores.py:293-297, precision_recall_curve.py:113-118).
// Arbitrary float32 weights are added by shared-memory atomics, and
// clusters' counters by reductions into `out`, in an order that changes from
// run to run, so such results may differ in the last bits between runs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// Mirrors the ctypes structure `_PlanStruct` in ops/bincount.py. At file
// scope: a type of the unnamed namespace would give tm_bincount internal
// linkage.
struct Plan {
  int n;          // inputs per row
  int rows;       // index rows: 1 (shared by every weight row) or out_rows
  int wrows;      // weight rows per index row: out_rows (shared idx) or 1
  int num_bins;
  int clusters;   // clusters per bin tile
  int cluster;    // CTAs per cluster
  int tiles;      // bin tiles over gridDim.y (1 unless 16 CTAs cannot hold the bins)
  int tile_bins;  // bins per tile
  int bs;         // bins each CTA of a cluster owns, for every output row
  int chv;        // 16-byte vectors per CTA and stage streamed by multicast (cluster > 1)
  unsigned long long magic;  // ceil(2^40 / bs): a bin's owner as a multiply
  int device;
  int sparse;     // 1: global atomics into the zeroed output (clusters = CTAs)
};

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most one Hopper block may use
constexpr int kMaxDevices = 64;
constexpr int kBarrierBytes = 16;      // two mbarriers, one per stage
constexpr int kReducePiece = 1024;     // counters per bulk reduction

struct Args {
  const int32_t* idx;
  const float* w;
  void* out;
  int n, rows, wrows, out_rows, num_bins, tile_bins, bs, row_stride, chv;
  unsigned long long magic;
  int head, nv, tail;  // per row: scalar head, 4-input vectors, scalar tail
  int reduce;          // several clusters: add into a zeroed `out`, else store
};

__host__ __device__ constexpr int align_up(int x, int a) { return (x + a - 1) / a * a; }

// counters of output row s and local bin lb: rows are padded so that every
// row's first counter has the phase mod 16 bytes of its place in `out`
__device__ __forceinline__ int counter(const Args& a, int s, int lb) {
  return s * a.row_stride + ((s * a.num_bins) & 3) + lb;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void red_cluster(uint32_t addr, float v) {
  asm volatile("red.relaxed.cluster.shared::cluster.add.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void red_cluster(uint32_t addr, int v) {
  asm volatile("red.relaxed.cluster.shared::cluster.add.s32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void red_local(uint32_t addr, float v) {
  asm volatile("red.shared.add.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void red_local(uint32_t addr, int v) {
  asm volatile("red.shared.add.s32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void red_global(float* p, float v) {
  asm volatile("red.global.add.f32 [%0], %1;" ::"l"(p), "f"(v) : "memory");
}

__device__ __forceinline__ void red_global(int* p, int v) {
  asm volatile("red.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void bulk_reduce(void* gmem, uint32_t smem, int bytes, float) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;" ::"l"(gmem),
               "r"(smem), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_reduce(void* gmem, uint32_t smem, int bytes, int) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.u32 [%0], [%1], %2;" ::"l"(gmem),
               "r"(smem), "r"(bytes) : "memory");
}

// Waits for the barrier's phase of the given parity, polling. A chunk whose
// bytes never arrive would be a bug; trapping after some seconds of polling
// turns it into a launch error instead of a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  unsigned polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ int lane_of(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Counts input (row, b, weight v) where it lands: a local shared-memory
// atomic when this CTA owns bin b, else (scalar inputs only) a remote add
// into the owner's shared memory.
template <typename T>
struct Counter {
  const Args& a;
  T* hist;
  int bin0, my_bins;  // bins [bin0, bin0 + my_bins) are this CTA's
  int tile_bin0, tile_n;

  __device__ __forceinline__ void local(int s, int lb, T v) const { red_local(smem_addr(hist + counter(a, s, lb)), v); }

  __device__ __forceinline__ void any(int s, int b, T v) const {
    const unsigned tb = static_cast<unsigned>(b - tile_bin0);
    if (b < 0 || tb >= static_cast<unsigned>(tile_n)) return;
    const unsigned owner = static_cast<unsigned>((tb * a.magic) >> 40);
    const uint32_t local_addr = smem_addr(hist + counter(a, s, static_cast<int>(tb - owner * a.bs)));
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local_addr), "r"(owner));
    red_cluster(remote, v);
  }
};

// kK: weight rows per index row when known at compile time (1 or 2), 0 for
// a runtime count. Unweighted launches have kK == 1.
template <typename T, bool kWeighted, int kK>
__global__ void __launch_bounds__(kThreads) histogram_kernel(const __grid_constant__ Args a) {
  constexpr int kUnroll = kK == 1 ? 4 : 2;
  constexpr int kW = kK > 0 ? kK : 1;  // weight vectors held per input vector
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  T* hist = reinterpret_cast<T*>(smem + kBarrierBytes);
  const int hist_elems = a.out_rows * a.row_stride;

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile_bin0 = static_cast<int>(blockIdx.y) * a.tile_bins;
  const int tile_n = min(a.tile_bins, a.num_bins - tile_bin0);
  const int bin0 = tile_bin0 + rank * a.bs;
  const int my_bins = max(0, min(a.bs, tile_bin0 + tile_n - bin0));
  const Counter<T> count{a, hist, bin0, my_bins, tile_bin0, tile_n};
  const int wrows = kWeighted ? (kK > 0 ? kK : a.wrows) : 0;
  const size_t n = static_cast<size_t>(a.n);
  const unsigned tid = threadIdx.x;

  for (int j = tid; j < hist_elems; j += kThreads) hist[j] = T(0);
  if (cs > 1 && tid == 0) {
    for (int s = 0; s < 2; ++s) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(full + s)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every CTA of the cluster runs, is zeroed and has its barriers before any
  // multicast or remote add reaches it
  cluster.sync();

  if (cs == 1) {
    // direct: this CTA owns every bin; a grid-stride over 16-byte vectors,
    // kUnroll of them loaded before their adds
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
          const unsigned r = a.rows == 1 ? 0u : q / static_cast<unsigned>(a.nv);
          row[u] = static_cast<int>(r);
          e[u] = r * n + a.head + 4 * static_cast<size_t>(q - r * a.nv);
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
          const int lb = lane_of(iv[u], i) - bin0;
          if (static_cast<unsigned>(lb) >= static_cast<unsigned>(my_bins)) continue;
          if (!kWeighted) {
            count.local(row[u], lb, T(1));
          } else if (kK > 0) {
#pragma unroll
            for (int k = 0; k < kW; ++k) {
              const float v = lane_of(wv[u][k], i);
              if (v != 0.0f) count.local(row[u] + k, lb, T(v));
            }
          } else {
            for (int k = 0; k < wrows; ++k) {
              const float v = __ldg(a.w + e[u] + k * n + i);
              if (v != 0.0f) count.local(row[u] + k, lb, T(v));
            }
          }
        }
      }
    }
  } else {
    // multicast: the cluster streams chunks of cs * chv vectors; each CTA
    // bulk-copies its chv of them (indices and weight rows) into the same
    // place in every CTA of the cluster, so each input byte leaves device
    // memory once, and every CTA counts the chunk's inputs whose bins it
    // owns with local atomics. Two stages: the next chunk lands while this
    // one is counted; cluster.sync() frees a stage for reuse.
    const int streams = 1 + wrows;
    const int chunk_v = cs * a.chv;
    const int stage_bytes = chunk_v * 16 * streams;
    unsigned char* stage0 = smem + kBarrierBytes + align_up(hist_elems * static_cast<int>(sizeof(T)), 16);
    const unsigned nch = (static_cast<unsigned>(a.nv) + chunk_v - 1) / chunk_v;
    const unsigned total = static_cast<unsigned>(a.rows) * nch;
    const unsigned g = blockIdx.x / cs;
    const unsigned G = gridDim.x / cs;
    const uint16_t mask = static_cast<uint16_t>((1u << cs) - 1);

    auto fetch = [&](unsigned c, int st) {
      const unsigned r = c / nch;
      const int v0 = static_cast<int>(c - r * nch) * chunk_v;
      const int vt = min(chunk_v, a.nv - v0);
      const int mine = min(a.chv, max(0, a.nv - v0 - rank * a.chv));
      const uint32_t bar = smem_addr(full + st);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(vt * 16 * streams)
                   : "memory");
      if (mine == 0) return;
      const size_t first = r * n + a.head + 4 * static_cast<size_t>(v0 + rank * a.chv);
      for (int t = 0; t < streams; ++t) {
        const void* src = t == 0 ? static_cast<const void*>(a.idx + first)
                                 : static_cast<const void*>(a.w + first + (t - 1) * n);
        const uint32_t dst = smem_addr(stage0 + st * stage_bytes + t * chunk_v * 16 + rank * a.chv * 16);
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
            "[%0], [%1], %2, [%3], %4;" ::"r"(dst),
            "l"(src), "r"(mine * 16), "r"(bar), "h"(mask)
            : "memory");
      }
    };

    if (tid == 0) {
      if (g < total) fetch(g, 0);
      if (g + G < total) fetch(g + G, 1);
    }
    unsigned i = 0;
    for (unsigned c = g; c < total; c += G, ++i) {
      const int st = static_cast<int>(i & 1);
      mbar_wait(smem_addr(full + st), (i >> 1) & 1);
      const unsigned r = c / nch;
      const int vt = min(chunk_v, a.nv - static_cast<int>(c - r * nch) * chunk_v);
      const int4* sidx = reinterpret_cast<const int4*>(stage0 + st * stage_bytes);
      const float* sw = reinterpret_cast<const float*>(stage0 + st * stage_bytes + chunk_v * 16);
      for (int v = tid; v < vt; v += kThreads) {
        const int4 iv = sidx[v];
#pragma unroll
        for (int i4 = 0; i4 < 4; ++i4) {
          const int lb = lane_of(iv, i4) - bin0;
          if (static_cast<unsigned>(lb) >= static_cast<unsigned>(my_bins)) continue;
          if (!kWeighted) {
            count.local(static_cast<int>(r), lb, T(1));
          } else {
            for (int k = 0; k < wrows; ++k) {
              const float wv = sw[k * chunk_v * 4 + v * 4 + i4];
              if (wv != 0.0f) count.local(static_cast<int>(r) + k, lb, T(wv));
            }
          }
        }
      }
      // every CTA is done with this stage before anyone refills it
      cluster.sync();
      if (tid == 0 && c + 2 * G < total) fetch(c + 2 * G, st);
    }
  }

  // scalar inputs: each row's head and tail, or every input without vectors
  {
    const unsigned gtid = blockIdx.x * kThreads + tid;
    const unsigned gstride = gridDim.x * kThreads;
    const int sc = a.head + a.tail;
    const unsigned nsc = static_cast<unsigned>(a.rows) * static_cast<unsigned>(sc);
    for (unsigned j = gtid; j < nsc; j += gstride) {
      const unsigned r = a.rows == 1 ? 0u : j / static_cast<unsigned>(sc);
      const unsigned t = j - r * sc;
      const size_t e = r * n + (t < static_cast<unsigned>(a.head) ? t : t + 4 * static_cast<size_t>(a.nv));
      const int b = __ldg(a.idx + e);
      if (kWeighted) {
        for (int k = 0; k < wrows; ++k) {
          const float v = __ldg(a.w + e + k * n);
          if (v != 0.0f) count.any(static_cast<int>(r) + k, b, T(v));
        }
      } else {
        count.any(static_cast<int>(r), b, T(1));
      }
    }
  }

  // every add, local or remote, has landed before the flush
  cluster.sync();
  T* out = static_cast<T*>(a.out);
  if (!a.reduce) {
    for (int s = 0; s < a.out_rows; ++s) {
      T* dst = out + static_cast<size_t>(s) * a.num_bins + bin0;
      for (int j = tid; j < my_bins; j += kThreads) dst[j] = hist[counter(a, s, j)];
    }
    return;
  }
  // add this cluster's counters into the zeroed output: a bulk reduction of
  // each row's 16-byte-aligned middle, atomics for its ragged ends
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  for (int s = 0; s < a.out_rows; ++s) {
    const size_t g0 = static_cast<size_t>(s) * a.num_bins + bin0;
    const int lead = min(my_bins, static_cast<int>((4 - (g0 & 3)) & 3));
    const int body = (my_bins - lead) & ~3;
    if (tid == 0 && body > 0) {
      // in pieces, each cluster starting at another piece, so that clusters
      // adding the same counters spread over the output
      const int pieces = (body + kReducePiece - 1) / kReducePiece;
      const int first = static_cast<int>(blockIdx.x / cs) % pieces;
      for (int p = 0; p < pieces; ++p) {
        const int off = ((p + first) % pieces) * kReducePiece;
        bulk_reduce(out + g0 + lead + off, smem_addr(hist + counter(a, s, lead + off)),
                    min(kReducePiece, body - off) * 4, T(0));
      }
    }
    for (int j = tid; j < my_bins; j += kThreads) {
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

// Sparse plan: a grid-stride over the index reads; each in-range input adds
// its weight rows (or a 1) straight into the zeroed output.
template <typename T, bool kWeighted>
__global__ void __launch_bounds__(kThreads) sparse_histogram_kernel(const __grid_constant__ Args a) {
  const size_t n = static_cast<size_t>(a.n);
  const size_t total = static_cast<size_t>(a.rows) * n;
  const int wrows = kWeighted ? a.wrows : 0;
  T* out = static_cast<T*>(a.out);
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

template <typename T, bool kWeighted>
cudaError_t launch_sparse(const Plan& p, const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(a.out, 0, static_cast<size_t>(a.out_rows) * a.num_bins * sizeof(T), stream);
  if (err != cudaSuccess) return err;
  sparse_histogram_kernel<T, kWeighted><<<p.clusters, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// Opts `kernel` in to 227 KB of dynamic shared memory and to clusters of 16.
cudaError_t configure(void (*kernel)(Args)) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <typename T, bool kWeighted, int kK>
cudaError_t launch(const Plan& p, const Args& a, cudaStream_t stream) {
  auto kernel = histogram_kernel<T, kWeighted, kK>;
  // once per instantiation and device: the attributes are per device
  static bool configured[kMaxDevices] = {};
  if (p.device < 0 || p.device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[p.device]) {
    const cudaError_t err = configure(kernel);
    if (err != cudaSuccess) return err;
    configured[p.device] = true;
  }
  const int streams = 1 + (kWeighted ? a.wrows : 0);
  size_t smem = kBarrierBytes + align_up(a.out_rows * a.row_stride * static_cast<int>(sizeof(T)), 16);
  if (p.cluster > 1) smem += 2 * static_cast<size_t>(p.cluster) * p.chv * 16 * streams;
  if (smem > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  if (a.reduce) {
    const cudaError_t err =
        cudaMemsetAsync(a.out, 0, static_cast<size_t>(a.out_rows) * a.num_bins * sizeof(T), stream);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.clusters * p.cluster, p.tiles, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  // one CTA per cluster: an ordinary launch (every CTA is a cluster of one)
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t dispatch(const Plan& p, const Args& a, cudaStream_t s) {
  if (p.sparse) return a.w == nullptr ? launch_sparse<int, false>(p, a, s) : launch_sparse<float, true>(p, a, s);
  if (a.w == nullptr) return launch<int, false, 1>(p, a, s);
  // one weight row per index row (per-row indices, the 1-D entry) and two
  // (the binned curve) are the metric path's; any other count runs generic
  switch (a.wrows) {
    case 1: return launch<float, true, 1>(p, a, s);
    case 2: return launch<float, true, 2>(p, a, s);
    default: return launch<float, true, 0>(p, a, s);
  }
}

}  // namespace

// Launches the plan on `stream` and returns its cudaError_t (0 on success);
// nothing is synchronised. `w == nullptr` counts into int32, else float32
// sums. `out` holds max(rows, wrows) * num_bins elements. The caller
// guarantees n > 0, contiguous buffers, a 16-byte-aligned `out` and the
// plan's limits (shared memory within 227 KB, cluster <= 16, every count
// below 2^31).
extern "C" int tm_bincount(const Plan* plan, const void* idx, const void* w, void* out, void* stream) {
  const Plan& p = *plan;
  Args a;
  a.idx = static_cast<const int32_t*>(idx);
  a.w = static_cast<const float*>(w);
  a.out = out;
  a.n = p.n;
  a.rows = p.rows;
  a.wrows = p.wrows;
  a.out_rows = p.rows > p.wrows ? p.rows : p.wrows;
  a.num_bins = p.num_bins;
  a.tile_bins = p.tile_bins;
  a.bs = p.bs;
  a.row_stride = align_up(p.bs, 4) + 4;
  a.chv = p.chv;
  a.magic = p.magic;
  a.reduce = p.clusters > 1;
  // Vectors need every stream of a row at one phase mod 16 bytes: the same
  // base phase for idx and w, and rows that start at one phase (n % 4 == 0)
  // unless there is a single stream pair.
  const uintptr_t ip = reinterpret_cast<uintptr_t>(idx);
  const uintptr_t wp = reinterpret_cast<uintptr_t>(w);
  const bool one_pair = p.rows == 1 && p.wrows == 1;
  const bool vec = (w == nullptr || wp % 16 == ip % 16) && (p.n % 4 == 0 || one_pair);
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
