// t-digest compression for NVIDIA Hopper (sm_90a), bound to Python with ctypes.
//
//   out[s] = compress(in[s])   for s in [0, S): in (S, M, 2) -> out (S, C, 2), float32
//
// Each in[s] is one digest's centroid multiset [mean, weight] already sorted
// by mean (ties by weight); empty centroids carry weight 0 and sort last.
// The kernel is what torchmetrics_tpu/sketches/tdigest.py:78-96 computes after
// its lexsort: the running weight, the quantile boundaries q_left and
// q_right, the greedy k1-scale slot assignment of the `lax.scan` at :78-88
// (a centroid opens a new slot when k(q_right) - k_start > 1 and q_left > 0),
// slots clamped to C - 1, and the per-slot weight and weighted-mean sums of
// the two `segment_sum`s at :90-96, written as [mean, weight] with +inf for
// an empty slot. It is not a TPU kernel: it stands in for an XLA scan, which
// PyTorch cannot compile; ops/tdigest.py holds the plain PyTorch version.
//
// Arithmetic (the plain version's, so the two agree bitwise on the CPU):
//   cum[i]  = float32(offset[b] + within[i]), b = i / kBlock: a blocked
//             float64 running sum of the weights. within[i] is the float64
//             sum, in order, of block b's weights up to i; offset[b] is the
//             float64 sum, in order, of the totals of blocks 0..b-1
//             (offset[0] = 0 exactly). While the weights are integers below
//             2^24 every partial sum is exact, so cum is then the sequential
//             sum and JAX's float32 cumsum bitwise; non-integer weights can
//             differ from a sequential float64 sum by float64 rounding.
//   total   = cum[M - 1], safe = max(total, 1e-38)
//   q_left  = (cum - w) / safe, q_right = cum / safe
//   k(q)    = asinf(2 * clamp(q, 0, 1) - 1) * float32(delta / (2 pi)), delta = 2 (C - 2)
//   sums    = float32, in sorted order within each slot; mean = sum_mw / max(sum_w, 1e-38)
// Every float operation is an explicit round-to-nearest intrinsic, so nvcc
// contracts nothing into a fused multiply-add.
//
// Bound: the work is a few operations per centroid, so bytes decide: each
// input read once and the output written once, (S * M + S * C) * 8 bytes at
// 3.35 TB/s. What limits the kernel instead is latency: the greedy walk is a
// chain of dependent openings (one per slot) that no design removes, each
// block's running sum a chain of kBlock float64 adds, and each slot's sums
// a chain of float32 adds; the rest is parallel.
//
// Design: one thread-block cluster of K CTAs per digest, one launch for all
// S digests. K = 1 where S digests fill the card, else up to 16 for a few
// large digests (8 where the card cannot place 16); 1,024 threads a CTA for
// M >= 16,384, else 512. The result does not depend on K.
//   * Pass 1, running sum: the cluster's CTAs split the blocks of kBlock
//     weights. A CTA stages its blocks' weights in shared memory (coalesced),
//     and one thread per block runs the block's float64 chain to its total;
//     where they fit, the weights and the float64 prefixes stay in shared
//     memory for pass 2. Rank 0 then turns the totals into offsets, one
//     thread's float64 chain over totals staged in shared memory.
//   * Pass 2, k values: cum from the kept prefixes plus the block's offset
//     (or from the block chains again), then every thread of the cluster
//     computes k(q_left) and k(q_right) for its centroids, k(q_right) stored
//     as -inf where the centroid may not open a slot (weight <= 0 or q_left
//     <= 0), and each warp the maximum of its 32 (one strip), ignoring NaN.
//   * Pass 3, the walk, in rank 0: tiles of kTile centroids' k values and
//     strip maxima are staged in shared memory, the next by warps 1.. while
//     warp 0 walks the current. Warp 0 keeps the scan's state (slot, k_start)
//     and, each round, tests the next 32 centroids one per lane and the next
//     32 strips by their maxima (1,024 centroids): a strip whose maximum m
//     has m - k_start <= 1 holds no opening, since rounded subtraction is
//     monotone, so nothing assumes that k(q_right) grows along the tile
//     (CUDA's asinf is not guaranteed monotone). The first strip that may
//     open is tested one centroid per lane; the first opening sets k_start =
//     k(q_left). That is the sequential scan exactly. Slot starts go to
//     `starts` (scratch); the walk stops when slot C - 1 opens, since every
//     later centroid clamps into it.
//   * Pass 4, per-slot sums: slots are contiguous runs of the sorted order.
//     CTA `rank` takes the slots that start in its share of the centroids,
//     stages them as (weight, mean * weight) pairs in shared memory, and one
//     thread per slot runs the slot's two float32 chains in sorted order,
//     loads issued ahead, with no atomics: the result does not depend on the
//     order of the input rows' multiset (tdigest.py:22-25), and it is the
//     order in which JAX's segment_sum adds on the CPU. A centroid with
//     weight <= 0 adds +0.0, which leaves a chain that starts at +0.0
//     unchanged.

#include <algorithm>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;  // the running sum's block (ops/tdigest.py BLOCK)
constexpr int kMaxThreads = 1024;
constexpr int kTile = 8192;  // centroids of one staged tile of the walk
constexpr int kStrip = 32;   // centroids under one strip maximum
constexpr int kUnroll = 16;  // loads issued ahead of a float64 chain
constexpr int kMaxCluster = 16;
constexpr int kMaxSmem = 232448;  // the most shared memory a CTA may have (227 KB)
constexpr float kTiny = 1e-38f;
constexpr int kScanBytes = 8192;  // block totals rank 0 scans at a time, in shared memory

struct Args {
  const float2* in;
  int m;
  int c;
  float scale;
  double* wsum;   // per digest: the blocks' offsets [nb], then the total
  float* kv;      // per digest (kv_stride): k(q_right) or -inf [mp], k(q_left) [mp], strip maxima
  int* starts;    // per digest: slot starts [C], then the slots used
  float2* out;
  int tile;       // centroids per staged tile of the walk
  int nbuf;       // staged tiles in shared memory (2 when M > tile)
  int smem;       // dynamic shared memory bytes
  int cluster;    // CTAs per digest
  int keep;       // 1: pass 1 keeps the CTA's weights and float64 prefixes for pass 2
};

__host__ __device__ __forceinline__ int round_up(int v, int to) { return (v + to - 1) / to * to; }

// floats of one digest's k-value scratch: M rounded up to whole strips, twice,
// and the strip maxima rounded up to float4s, so every tile is float4-aligned
__host__ __device__ __forceinline__ int kv_stride(int m) {
  return 2 * round_up(m, kStrip) + round_up(round_up(m, kStrip) / kStrip, 4);
}

// floats of one staged tile of the walk: k(q_right), k(q_left), strip maxima
__host__ __device__ __forceinline__ int tile_stride(int tile) { return 2 * tile + round_up(tile / kStrip, 4); }

// max(a, b) that keeps a NaN `a`, as torch.clamp(min=) and jnp.maximum do
__device__ __forceinline__ float max_keep_nan(float a, float b) { return (a != a) ? a : (a < b ? b : a); }

__device__ __forceinline__ float k_scale(float q, float scale) {
  const float qc = (q != q) ? q : fminf(fmaxf(q, 0.0f), 1.0f);
  return __fmul_rn(asinf(__fsub_rn(__fmul_rn(2.0f, qc), 1.0f)), scale);
}

// all CTAs of the digest's cluster; global writes before it are seen after it
__device__ __forceinline__ void digest_sync(int cluster) {
  if (cluster > 1) {
    __threadfence();
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ bool opens(float k_right, float k_start) {
  return __fsub_rn(k_right, k_start) > 1.0f;
}

// A block's float64 chain over its n staged weights, in order, from 0, and
// its total. Each prefix is stored in `within` if given, and with `cum`,
// plus `offset`, rounded to float32. Loads are issued kUnroll ahead.
__device__ __forceinline__ double block_chain(const float* __restrict__ row, int n, double offset,
                                              float* __restrict__ cum, double* __restrict__ within) {
  double acc = 0.0;
  int j = 0;
  for (; j + kUnroll <= n; j += kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = row[j + u];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc = __dadd_rn(acc, static_cast<double>(v[u]));
      if (within) within[j + u] = acc;
      if (cum) cum[j + u] = __double2float_rn(__dadd_rn(offset, acc));
    }
  }
  for (; j < n; ++j) {
    acc = __dadd_rn(acc, static_cast<double>(row[j]));
    if (within) within[j] = acc;
    if (cum) cum[j] = __double2float_rn(__dadd_rn(offset, acc));
  }
  return acc;
}

// Stage blocks [cb, cb + nblk) of weights, a row of kBlock + 1 floats per
// block (thread t reads row t: no bank conflicts); returns the last position + 1.
__device__ __forceinline__ int stage_blocks(const float2* __restrict__ x, int m, int cb, int nblk, float* ws) {
  const int lo = cb * kBlock;
  const int hi = min(m, (cb + nblk) * kBlock);
  for (int i = lo + static_cast<int>(threadIdx.x); i < hi; i += blockDim.x) {
    const int r = i - lo;
    ws[r + r / kBlock] = x[i].y;
  }
  return hi;
}

__global__ void __launch_bounds__(kMaxThreads) compress_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = a.cluster;
  const int rank = k > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const size_t digest = blockIdx.x / k;
  const int m = a.m;
  const int c = a.c;
  const int nb = (m + kBlock - 1) / kBlock;
  const int mp = round_up(m, kStrip);
  const float2* x = a.in + digest * m;
  double* offset = a.wsum + digest * (nb + 1);
  float* kre = a.kv + digest * kv_stride(m);
  float* kl = kre + mp;
  float* smax = kl + mp;
  int* starts = a.starts + digest * (c + 1);
  float2* out = a.out + digest * c;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  // the cluster's CTAs split the blocks; passes 1 and 2 work on CTA `rank`'s
  const int bper = (nb + k - 1) / k;
  const int b_lo = min(nb, rank * bper);
  const int b_hi = min(nb, b_lo + bper);
  float* ws = reinterpret_cast<float*>(smem);
  double* wd = reinterpret_cast<double*>(smem + round_up(bper * (kBlock + 1) * 4, 16));  // with `keep`

  // pass 1: each block's total, one thread's float64 chain over its weights;
  // with `keep`, the CTA's weights and prefixes stay in shared memory
  {
    const int chunk = min(nt, (a.smem - kScanBytes) / static_cast<int>((kBlock + 1) * sizeof(float)));
    for (int cb = b_lo; cb < b_hi; cb += chunk) {
      const int nblk = min(chunk, b_hi - cb);
      stage_blocks(x, m, cb, nblk, ws);
      __syncthreads();
      if (tid < nblk) {
        const int b = cb + tid;
        offset[b] = block_chain(ws + tid * (kBlock + 1), min(kBlock, m - b * kBlock), 0.0, nullptr,
                                a.keep ? wd + tid * (kBlock + 1) : nullptr);
      }
      __syncthreads();
    }
  }
  digest_sync(k);

  // pass 1, continued: rank 0 turns the totals into offsets, one chain in
  // order over totals staged in shared memory; the sum of all is the total
  if (rank == 0) {
    double* sd = reinterpret_cast<double*>(smem + a.smem - kScanBytes);
    const int chunk = kScanBytes / static_cast<int>(sizeof(double));
    double acc = 0.0;
    for (int c0 = 0; c0 < nb; c0 += chunk) {
      const int n = min(chunk, nb - c0);
      for (int i = tid; i < n; i += nt) sd[i] = offset[c0 + i];
      __syncthreads();
      if (tid == 0) {
        int i = 0;
        for (; i + kUnroll <= n; i += kUnroll) {
          double v[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) v[u] = sd[i + u];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            sd[i + u] = acc;
            acc = __dadd_rn(acc, v[u]);
          }
        }
        for (; i < n; ++i) {
          const double total = sd[i];
          sd[i] = acc;
          acc = __dadd_rn(acc, total);
        }
      }
      __syncthreads();
      for (int i = tid; i < n; i += nt) offset[c0 + i] = sd[i];
      __syncthreads();
    }
    if (tid == 0) offset[nb] = acc;  // offset[nb - 1] + the last block's total: cum[M - 1]
  }
  digest_sync(k);

  // pass 2: cum, from the prefixes pass 1 kept or from the blocks' chains
  // again, then k values, one strip of 32 centroids per warp step
  {
    const float safe = max_keep_nan(__double2float_rn(offset[nb]), kTiny);
    const int chunk = a.keep ? bper
                             : min(nt, (a.smem - kScanBytes) / static_cast<int>(2 * (kBlock + 1) * sizeof(float)));
    float* cs = ws + chunk * (kBlock + 1);  // without `keep`: the cum rows, after the weight rows
    for (int cb = b_lo; cb < b_hi; cb += chunk) {
      const int nblk = min(chunk, b_hi - cb);
      const int lo = cb * kBlock;
      const int hi = min(m, (cb + nblk) * kBlock);
      if (!a.keep) {
        stage_blocks(x, m, cb, nblk, ws);
        __syncthreads();
        if (tid < nblk) {
          const int b = cb + tid;
          block_chain(ws + tid * (kBlock + 1), min(kBlock, m - b * kBlock), offset[b], cs + tid * (kBlock + 1),
                      nullptr);
        }
        __syncthreads();
      }
      for (int sidx = lo / kStrip + warp; sidx * kStrip < hi; sidx += nwarps) {
        const int i = sidx * kStrip + lane;
        float r = -INFINITY;
        if (i < hi) {
          const int at = (i - lo) + (i - lo) / kBlock;
          const float w = ws[at];
          const float cm = a.keep ? __double2float_rn(__dadd_rn(offset[i / kBlock], wd[at])) : cs[at];
          const float ql = __fdiv_rn(__fsub_rn(cm, w), safe);
          const float kr = k_scale(__fdiv_rn(cm, safe), a.scale);
          kl[i] = k_scale(ql, a.scale);
          r = (w > 0.0f && ql > 0.0f) ? kr : -INFINITY;
          kre[i] = r;
        }
        float mx = r;  // fmaxf drops NaN, which never opens
#pragma unroll
        for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        if (lane == 0) smax[sidx] = mx;
      }
      __syncthreads();
    }
  }
  digest_sync(k);

  // pass 3: the walk, in rank 0
  if (rank == 0) {
    float* sbuf = reinterpret_cast<float*>(smem);
    const int tile = a.tile;
    const int stride = tile_stride(tile);
    const int ntiles = (m + tile - 1) / tile;
    auto stage = [&](int t, int first) {  // float4 copies of tile t into its buffer
      float4* dst = reinterpret_cast<float4*>(sbuf + (t % a.nbuf) * stride);
      const int t0 = t * tile;
      const int n4 = (min(tile, m - t0) + 3) / 4;
      const int s4 = (min(tile, m - t0) + 4 * kStrip - 1) / (4 * kStrip);
      const float4* kr4 = reinterpret_cast<const float4*>(kre + t0);
      const float4* kl4 = reinterpret_cast<const float4*>(kl + t0);
      const float4* sm4 = reinterpret_cast<const float4*>(smax + t0 / kStrip);
      for (int i = tid - first; i < n4; i += nt - first) {
        dst[i] = kr4[i];
        dst[tile / 4 + i] = kl4[i];
      }
      for (int i = tid - first; i < s4; i += nt - first) dst[tile / 2 + i] = sm4[i];
    };
    stage(0, 0);
    if (tid == 0) starts[0] = 0;
    __syncthreads();
    int slot = 0;  // the scan's state, in warp 0
    float k_start = k_scale(0.0f, a.scale);
    for (int t = 0; t < ntiles; ++t) {
      if (warp == 0 && slot < c - 1) {  // past slot C - 1 every centroid clamps into it
        // 32-bit shared addresses, loads unpredicated at clamped indices: the
        // round's dependent path is two loads, a compare and a ballot
        const uint32_t skr = smem_addr(sbuf + (t % a.nbuf) * stride);
        const uint32_t skl = skr + 4 * tile;
        const uint32_t ssm = skr + 8 * tile;
        const int t0 = t * tile;
        const int n = min(tile, m - t0);
        const int nsn = (n + kStrip - 1) / kStrip;
        int q = 0;  // next centroid of the tile to test
        while (q < n) {
          // the next 32 centroids one per lane, the 32 strips after q's by their maxima
          const int e = q + lane;
          const int s = (q >> 5) + 1 + lane;
          const float ke = lds(skr + 4 * min(e, n - 1));
          const float ks = lds(ssm + 4 * min(s, nsn - 1));
          const unsigned eb = __ballot_sync(0xffffffffu, e < n && opens(ke, k_start));
          const unsigned sb = __ballot_sync(0xffffffffu, s < nsn && opens(ks, k_start));
          int at;
          if (eb) {
            at = q + __ffs(eb) - 1;
          } else if (sb) {
            const int i = (s - lane + __ffs(sb) - 1) * kStrip + lane;
            const float ki = lds(skr + 4 * min(i, n - 1));
            const unsigned hb = __ballot_sync(0xffffffffu, i < n && opens(ki, k_start));
            if (!hb) {  // unreachable: the strip's maximum opens
              q = i - lane + kStrip;
              continue;
            }
            at = i - lane + __ffs(hb) - 1;
          } else {
            q = (s - lane + 32) * kStrip;
            continue;
          }
          ++slot;
          k_start = lds(skl + 4 * at);
          if (lane == 0) starts[slot] = t0 + at;
          q = at + 1;
          if (slot == c - 1) break;
        }
      } else if (warp > 0 && t + 1 < ntiles) {
        stage(t + 1, 32);
      }
      __syncthreads();
    }
    if (tid == 0) starts[c] = slot + 1;  // slots used: the walk stops at C - 1
  }
  digest_sync(k);

  // pass 4: per-slot sums. CTA `rank` takes the slots that start in its
  // share of the positions, stages their centroids as (weight, mean *
  // weight) pairs in shared memory, and one thread per slot runs its two
  // float32 chains in order; a slot longer than the staged chunk carries its
  // partial sums in `out` to the next chunk.
  {
    float2* pairs = reinterpret_cast<float2*>(smem);
    const int cap = a.smem / static_cast<int>(sizeof(float2));
    const int used = starts[c];
    const int pper = (m + k - 1) / k;
    const int p_lo = min(m, rank * pper);
    const int p_hi = min(m, p_lo + pper);
    int j_lo = 0;
    int j_hi = 0;
    for (int j0 = 0; j0 < used; j0 += nt) {
      const int st = j0 + tid < used ? starts[j0 + tid] : m;
      j_lo += __syncthreads_count(st < p_lo);
      j_hi += __syncthreads_count(st < p_hi);
    }
    const int q_lo = j_lo < used ? starts[j_lo] : m;
    const int q_hi = j_hi < used ? starts[j_hi] : m;
    for (int j = j_lo + tid; j < j_hi; j += nt) out[j] = make_float2(0.0f, 0.0f);  // (sum_w, sum_mw)
    for (int c0 = q_lo; c0 < q_hi; c0 += cap) {
      const int c1 = min(q_hi, c0 + cap);
      __syncthreads();
      for (int i = c0 + tid; i < c1; i += nt) {
        const float2 v = x[i];
        pairs[i - c0] = v.y > 0.0f ? make_float2(v.y, __fmul_rn(v.x, v.y)) : make_float2(0.0f, 0.0f);
      }
      __syncthreads();
      for (int j = j_lo + tid; j < j_hi; j += nt) {
        const int a0 = max(starts[j], c0);
        const int a1 = min(j + 1 < used ? starts[j + 1] : m, c1);
        if (a0 >= a1) continue;
        const float2* pv = pairs + (a0 - c0);
        const int n = a1 - a0;
        float2 acc = out[j];
        int i = 0;
        for (; i + kUnroll <= n; i += kUnroll) {  // loads issued ahead of the chains
          float2 v[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) v[u] = pv[i + u];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            acc.x = __fadd_rn(acc.x, v[u].x);
            acc.y = __fadd_rn(acc.y, v[u].y);
          }
        }
        for (; i < n; ++i) {
          acc.x = __fadd_rn(acc.x, pv[i].x);
          acc.y = __fadd_rn(acc.y, pv[i].y);
        }
        out[j] = acc;
      }
    }
    for (int j = j_lo + tid; j < j_hi; j += nt) {
      const float2 acc = out[j];
      out[j] = make_float2(acc.x > 0.0f ? __fdiv_rn(acc.y, max_keep_nan(acc.x, kTiny)) : INFINITY, acc.x);
    }
    if (rank == 0) {
      for (int j = used + tid; j < c; j += nt) out[j] = make_float2(INFINITY, 0.0f);
    }
  }
}

// The launch's shape for digests of M centroids over `cluster` CTAs each.
Args plan(int m, int cluster, int threads) {
  Args a{};
  a.m = m;
  a.cluster = cluster;
  a.tile = std::min(kTile, round_up(m, kStrip));
  a.nbuf = m > a.tile ? 2 : 1;
  const int walk = a.nbuf * tile_stride(a.tile) * 4;
  // a CTA's blocks: kept from pass 1 to pass 2 where their weight rows and
  // float64 prefixes fit, else two float rows each, a chunk at a time
  const int blocks = ((m + kBlock - 1) / kBlock + cluster - 1) / cluster;
  const int kept = round_up(blocks * (kBlock + 1) * 4, 16) + blocks * (kBlock + 1) * 8;
  a.keep = blocks <= threads && kept + kScanBytes <= kMaxSmem;
  const int rows = a.keep ? kept : std::min(blocks, threads) * 2 * (kBlock + 1) * 4;
  a.smem = round_up(std::min(kMaxSmem, std::max(walk, rows) + kScanBytes), 16);
  return a;
}

constexpr int kMaxDevices = 64;
int g_max_cluster[kMaxDevices];  // per card, set by tm_tdigest_prepare

}  // namespace

// Once per card, before the first launch there (never inside a graph
// capture): lets the kernel take its largest shared memory and clusters of
// 16, and records whether the card can place such a cluster.
extern "C" int tm_tdigest_prepare() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(compress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  }
  if (err == cudaSuccess) err = cudaFuncSetAttribute(compress_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess || dev >= kMaxDevices) return static_cast<int>(err);
  // clusters of kMaxCluster where the card can place one of the largest launch's, else 8 (portable)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kMaxCluster);
  cfg.blockDim = dim3(kMaxThreads);
  cfg.dynamicSmemBytes = kMaxSmem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kMaxCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, compress_kernel, &cfg);
  g_max_cluster[dev] = err == cudaSuccess && clusters > 0 ? kMaxCluster : 8;
  return static_cast<int>(err);
}

// in (S, M, 2), out (S, C, 2): float32, contiguous, 8-byte aligned. Scratch:
// wsum (S, ceil(M / 256) + 1) float64, kv (S, kv_stride(M)) float32, starts
// (S, C + 1) int32. `cluster` CTAs (1 to 16; at most what tm_tdigest_prepare
// found the card can place) work on each digest.
// Launches on `stream` and returns cudaGetLastError() (0 on success); does
// not synchronise.
extern "C" int tm_tdigest_compress(const void* in, int s, int m, int c, float scale, int cluster, void* wsum,
                                   void* kv, void* starts, void* out, void* stream) {
  if (s == 0) return 0;
  if (cluster < 1 || cluster > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess && dev < kMaxDevices && g_max_cluster[dev] > 0) {
    cluster = std::min(cluster, g_max_cluster[dev]);
  } else {
    cluster = std::min(cluster, 8);
  }
  const int threads = m >= 16384 ? kMaxThreads : 512;
  Args a = plan(m, cluster, threads);
  a.in = static_cast<const float2*>(in);
  a.c = c;
  a.scale = scale;
  a.wsum = static_cast<double*>(wsum);
  a.kv = static_cast<float*>(kv);
  a.starts = static_cast<int*>(starts);
  a.out = static_cast<float2*>(out);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(s) * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = a.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, compress_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tm_tdigest_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
