// Weighted bincount for NVIDIA Hopper (sm_90a), bound to Python with ctypes.
//
//   out[b] = sum_i w[i] * [idx[i] == b]   for b in [0, num_bins)
//
// Indices outside [0, num_bins) contribute nothing; w == nullptr counts ones
// into an int32 histogram, otherwise weights accumulate into a float32 one.
//
// Replaces the Pallas TPU kernel torchmetrics_tpu/ops/bincount.py:38
// (`_kernel`, launched by `pl.pallas_call` at :89 through `_bincount_pallas`).
// That kernel does a sequential compare-and-reduce over a (bin tile, n tile)
// grid, which is race-free only because a TPU runs its grid in order. Blocks
// on Hopper run in parallel and in no order, so this is a histogram instead:
//
//   pass 1  grid (grid_x, bin_tiles). Each block zeroes a private histogram of
//           `tile_bins` bins in dynamic shared memory, strides over its
//           contiguous slice of the N inputs with shared-memory atomics, and
//           writes its partial histogram to `partial[blockIdx.x][bins]`.
//           When num_bins is larger than one block's shared memory the bins
//           are tiled over blockIdx.y, and each tile re-reads the inputs.
//   pass 2  one thread per bin sums the grid_x partials in fixed block order.
//           With grid_x == 1, pass 1 writes straight into `out` and pass 2
//           is skipped.
//
// Bound: the work is N adds, so the bytes decide: N * 8 bytes read (int32
// index + float32 weight; N * 4 unweighted) plus num_bins * 4 written. The
// design moves O(N) bytes, against the O(N * C) one-hot products the JAX
// package uses on the TPU; what it adds on top is the partials
// (grid_x * num_bins * 4 bytes each way), which the host-side plan keeps
// below the input bytes by giving each block at least `tile_bins` inputs,
// and one extra read of the inputs per additional bin tile.
//
// Exactness: int32 counts are exact. Float32 sums of weights that are
// integers (the 0/1 masks of the metric path) are exact and independent of
// order while every bin stays below 2^24, the ceiling the JAX package
// documents (stat_scores.py:293-297, precision_recall_curve.py:113-118).
// Arbitrary float32 weights are added by shared-memory atomics in an order
// that changes from run to run, so such results may differ in the last bits
// between runs; pass 2 itself adds in a fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCountThreads = 512;
constexpr int kSumThreads = 256;

template <typename T, bool kWeighted>
__global__ void __launch_bounds__(kCountThreads)
histogram_tile_kernel(const int32_t* __restrict__ idx, const float* __restrict__ w,
                      long long n, long long chunk, int num_bins, int tile_bins,
                      T* __restrict__ dst) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hist = reinterpret_cast<T*>(smem_raw);

  const int bin0 = blockIdx.y * tile_bins;
  const int nb = min(tile_bins, num_bins - bin0);
  for (int b = threadIdx.x; b < nb; b += blockDim.x) hist[b] = T(0);
  __syncthreads();

  const long long start = static_cast<long long>(blockIdx.x) * chunk;
  const long long end = min(n, start + chunk);
  for (long long i = start + threadIdx.x; i < end; i += blockDim.x) {
    // unsigned difference: negative indices and indices below this tile wrap
    // to values >= nb, so one compare masks both ends of the tile
    const unsigned int b = static_cast<unsigned int>(__ldg(idx + i)) - static_cast<unsigned int>(bin0);
    if (b < static_cast<unsigned int>(nb)) {
      if (kWeighted) {
        atomicAdd(hist + b, static_cast<T>(__ldg(w + i)));
      } else {
        atomicAdd(hist + b, static_cast<T>(1));
      }
    }
  }
  __syncthreads();

  T* row = dst + static_cast<long long>(blockIdx.x) * num_bins + bin0;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) row[b] = hist[b];
}

template <typename T>
__global__ void __launch_bounds__(kSumThreads)
sum_partials_kernel(const T* __restrict__ partial, int grid_x, int num_bins, T* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= num_bins) return;
  T acc = T(0);
  for (int x = 0; x < grid_x; ++x) acc += partial[static_cast<long long>(x) * num_bins + b];
  out[b] = acc;
}

template <typename T, bool kWeighted>
cudaError_t launch(const int32_t* idx, const float* w, long long n, int num_bins, int grid_x,
                   int tile_bins, T* partial, T* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(tile_bins) * sizeof(T);
  auto kernel = histogram_tile_kernel<T, kWeighted>;
  // above 48 KB a block gets dynamic shared memory only after opting in
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int bin_tiles = (num_bins + tile_bins - 1) / tile_bins;
  const long long chunk = (n + grid_x - 1) / grid_x;
  T* dst = grid_x == 1 ? out : partial;
  kernel<<<dim3(grid_x, bin_tiles), kCountThreads, smem, stream>>>(idx, w, n, chunk, num_bins,
                                                                    tile_bins, dst);
  err = cudaGetLastError();
  if (err != cudaSuccess || grid_x == 1) return err;
  const int sum_blocks = (num_bins + kSumThreads - 1) / kSumThreads;
  sum_partials_kernel<T><<<sum_blocks, kSumThreads, 0, stream>>>(partial, grid_x, num_bins, out);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success); nothing is
// synchronised. `w == nullptr` selects the int32 count, else float32 sums.
// `partial` holds grid_x * num_bins elements of the output type and may be
// null when grid_x == 1. The caller guarantees n > 0, 0 < tile_bins,
// tile_bins * 4 bytes fit one block's shared memory, and contiguous buffers.
extern "C" int tm_weighted_bincount(const void* idx, const void* w, long long n, int num_bins,
                                    int grid_x, int tile_bins, void* partial, void* out,
                                    void* stream) {
  const int32_t* idx_p = static_cast<const int32_t*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w == nullptr) {
    return static_cast<int>(launch<int, false>(idx_p, nullptr, n, num_bins, grid_x, tile_bins,
                                               static_cast<int*>(partial), static_cast<int*>(out), s));
  }
  return static_cast<int>(launch<float, true>(idx_p, static_cast<const float*>(w), n, num_bins, grid_x,
                                              tile_bins, static_cast<float*>(partial),
                                              static_cast<float*>(out), s));
}
