// t-digest compression for NVIDIA Hopper (sm_90a), bound to Python with ctypes.
//
//   out[s] = compress(in[s])   for s in [0, S): in (S, M, 2) -> out (S, C, 2), float32
//
// Each in[s] is one digest's centroid multiset [mean, weight] already sorted
// by mean (ties by weight); empty centroids carry weight 0 and sort last.
// The kernel is what torchmetrics_tpu/sketches/tdigest.py:69-96 computes after
// its lexsort: the running weight, the quantile boundaries q_left and
// q_right, the greedy k1-scale slot assignment of the `lax.scan` at :78-88
// (a centroid opens a new slot when k(q_right) - k_start > 1 and q_left > 0),
// slots clamped to C - 1, and the per-slot weight and weighted-mean sums of
// the two `segment_sum`s at :90-96, written as [mean, weight] with +inf for
// an empty slot. It is not a TPU kernel: it stands in for an XLA scan, which
// PyTorch cannot compile; ops/tdigest.py holds the plain PyTorch version.
//
// Arithmetic (the plain version's, so the two agree bitwise on the card):
//   cum[i]  = float32 of a running float64 sum of the weights, in order (what
//             torch.cumsum(w, dtype=float64) computes on the CPU; equal to
//             JAX's float32 cumsum while the weights are integers below 2^24)
//   total   = cum[M - 1], safe = max(total, 1e-38)
//   q_left  = (cum - w) / safe, q_right = cum / safe
//   k(q)    = asinf(2 * clamp(q, 0, 1) - 1) * float32(delta / (2 pi)), delta = 2 (C - 2)
//   sums    = float32, in sorted order within each slot; mean = sum_mw / max(sum_w, 1e-38)
// Every float operation is an explicit round-to-nearest intrinsic, so nvcc
// contracts nothing into a fused multiply-add.
//
// Bound: the work is a few operations per centroid, so bytes decide: each
// input read once and the output written once, (S * M + S * C) * 8 bytes.
// This kernel is far from it: it is latency bound on the two sequential
// chains below, and a later change would have to make them parallel.
//
// Design: one CTA per digest, so a TenantStack's digests, a windowed
// metric's slots and an n-way merge are one launch.
//   * Pass 1: the running sum is one thread's chain of float64 adds over
//     tiles the CTA stages in shared memory; the prefixes go to `cum`
//     (scratch, S * M floats).
//   * Pass 2, per tile: every thread computes k(q_right), k(q_left) and
//     whether its centroid may open a slot; then warp 0 walks the tile with
//     the scan's state (slot, k_start): 32 centroids are tested against the
//     current k_start at once, and the first that opens sets the new k_start
//     and restarts the test after it. That is the sequential scan exactly,
//     with no assumption that k(q_right) grows along the tile (CUDA's asinf
//     is not guaranteed monotone). Slot starts go to `starts` (scratch,
//     S * C ints); slots past C - 1 are not recorded, so the last slot runs
//     to the end (the clamp).
//   * Pass 3: slots are contiguous runs of the sorted order, so each thread
//     sums whole runs in order, with no atomics: the result does not depend
//     on the order of the input rows' multiset (tdigest.py:22-25), and it
//     is the order in which JAX's segment_sum adds on the CPU.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;
constexpr float kTiny = 1e-38f;

// max(a, b) that keeps a NaN `a`, as torch.clamp(min=) and jnp.maximum do
__device__ __forceinline__ float max_keep_nan(float a, float b) { return (a != a) ? a : (a < b ? b : a); }

__device__ __forceinline__ float k_scale(float q, float scale) {
  const float qc = (q != q) ? q : fminf(fmaxf(q, 0.0f), 1.0f);
  return __fmul_rn(asinf(__fsub_rn(__fmul_rn(2.0f, qc), 1.0f)), scale);
}

__global__ void __launch_bounds__(kThreads)
compress_kernel(const float2* __restrict__ in, int m, int c, float scale, float* __restrict__ cum_all,
                int* __restrict__ starts_all, float2* __restrict__ out_all) {
  const float2* x = in + static_cast<size_t>(blockIdx.x) * m;
  float* cum = cum_all + static_cast<size_t>(blockIdx.x) * m;
  int* starts = starts_all + static_cast<size_t>(blockIdx.x) * c;
  float2* out = out_all + static_cast<size_t>(blockIdx.x) * c;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  __shared__ float buf[2 * kTile];  // pass 1: a tile's weights; pass 2: k(q_right), k(q_left)
  __shared__ unsigned char may_open[kTile];
  __shared__ float s_total;
  __shared__ int s_used;

  // pass 1: the running sum
  double acc = 0.0;
  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int n = min(kTile, m - t0);
    for (int i = tid; i < n; i += kThreads) buf[i] = x[t0 + i].y;
    __syncthreads();
    if (tid == 0) {
      for (int i = 0; i < n; ++i) {
        acc += static_cast<double>(buf[i]);
        cum[t0 + i] = static_cast<float>(acc);
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    s_total = static_cast<float>(acc);
    starts[0] = 0;
  }
  __syncthreads();

  // pass 2: the slot walk
  const float safe = max_keep_nan(s_total, kTiny);
  float* kr = buf;
  float* kl = buf + kTile;
  int slot = 0;
  float k_start = k_scale(0.0f, scale);
  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int n = min(kTile, m - t0);
    for (int i = tid; i < n; i += kThreads) {
      const float w = x[t0 + i].y;
      const float cm = cum[t0 + i];
      const float ql = __fdiv_rn(__fsub_rn(cm, w), safe);
      kr[i] = k_scale(__fdiv_rn(cm, safe), scale);
      kl[i] = k_scale(ql, scale);
      may_open[i] = (w > 0.0f) && (ql > 0.0f);
    }
    __syncthreads();
    if (tid < 32) {
      for (int p = 0; p < n;) {
        const int i = p + lane;
        const bool open = i < n && may_open[i] && __fsub_rn(kr[i], k_start) > 1.0f;
        const unsigned hits = __ballot_sync(0xffffffffu, open);
        if (hits == 0u) {
          p += 32;
          continue;
        }
        const int at = p + __ffs(hits) - 1;
        ++slot;
        k_start = kl[at];
        if (lane == 0 && slot < c) starts[slot] = t0 + at;
        p = at + 1;
      }
    }
    __syncthreads();
  }
  if (tid == 0) s_used = min(slot + 1, c);
  __syncthreads();

  // pass 3: per-slot sums over contiguous runs, in order
  const int used = s_used;
  for (int j = tid; j < c; j += kThreads) {
    float sw = 0.0f;
    float smw = 0.0f;
    if (j < used) {
      const int end = j + 1 < used ? starts[j + 1] : m;
      for (int i = starts[j]; i < end; ++i) {
        const float2 v = x[i];
        if (v.y > 0.0f) {
          sw = __fadd_rn(sw, v.y);
          smw = __fadd_rn(smw, __fmul_rn(v.x, v.y));
        }
      }
    }
    out[j] = make_float2(sw > 0.0f ? __fdiv_rn(smw, max_keep_nan(sw, kTiny)) : INFINITY, sw);
  }
}

}  // namespace

// in (S, M, 2), out (S, C, 2): float32, contiguous, 8-byte aligned; cum
// (S, M) float32 and starts (S, C) int32 are scratch. Launches on `stream`
// and returns cudaGetLastError() (0 on success); does not synchronise.
extern "C" int tm_tdigest_compress(const void* in, int s, int m, int c, float scale, void* cum, void* starts,
                                   void* out, void* stream) {
  if (s == 0) return 0;
  compress_kernel<<<s, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(in), m, c, scale, static_cast<float*>(cum), static_cast<int*>(starts),
      static_cast<float2*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tm_tdigest_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
