// Dense-tile CB-SpMV partials (paper Alg. 4) for Hopper.
//
// Replaces the TPU kernel `block_dense_spmv_batched` of the JAX package
// (src/repro/kernels/cb_block_dense.py): tiles (gd, G*B, B) in the payload
// type, xg (gd, G, B) float32 pre-gathered, out (gd, G, B) float32 with
// out[g, s, r] = sum_c tiles[g, s*B + r, c] * xg[g, s, c].
//
// Bound: memory. Every tile value is read once and used once (2 flops per
// 4 bytes at float32), so the floor is (tiles + xg + out bytes) / HBM rate.
// Design: the group axis carries no meaning for this product — the stream
// is a flat list of gd*G*B tile rows, each dotted with its own tile's x
// slice — so the grid tiles that flat row list and the block size does not
// depend on G. A block stages its rows into shared memory with coalesced
// loads (consecutive threads, consecutive addresses), converting to
// float32 on the way; the row stride is padded to B+1 words so that the
// per-thread row walks that follow hit 32 different banks. Then one thread
// per row takes its B-long dot against the x slice (a broadcast read,
// served by L1). B is a runtime value; 24 needs no padding.
#include "cb_common.cuh"

template <typename T>
__global__ void cb_dense_kernel(const T* __restrict__ tiles, const float* __restrict__ xg,
                                float* __restrict__ out, long long nrows, int B,
                                int rows_per_block) {
  extern __shared__ float smem[];  // rows_per_block * (B + 1)
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int rows = static_cast<int>(min(static_cast<long long>(rows_per_block), nrows - row0));
  const int stride = B + 1;
  const T* src = tiles + row0 * B;
  for (int i = threadIdx.x; i < rows * B; i += blockDim.x) {
    smem[(i / B) * stride + (i % B)] = cb_to_float(src[i]);
  }
  __syncthreads();
  for (int lr = threadIdx.x; lr < rows; lr += blockDim.x) {
    const long long row = row0 + lr;
    const float* xs = xg + (row / B) * B;  // the x slice of this row's tile
    const float* a = smem + lr * stride;
    float acc = 0.f;
    for (int c = 0; c < B; ++c) acc = fmaf(a[c], __ldg(xs + c), acc);
    out[row] = acc;
  }
}

extern "C" int cb_dense_spmv(const void* tiles, const void* xg, void* out, long long nrows,
                             int B, int dtype, void* stream) {
  if (nrows <= 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // as many rows as fit 40 KB of shared memory, at most 256, in whole warps
  int rows_per_block = 40960 / ((B + 1) * static_cast<int>(sizeof(float)));
  rows_per_block = rows_per_block >= 256 ? 256 : (rows_per_block / 32) * 32;
  if (rows_per_block < 32) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(rows_per_block) * (B + 1) * sizeof(float);
  const unsigned grid = static_cast<unsigned>((nrows + rows_per_block - 1) / rows_per_block);
#define LAUNCH(T)                                                                         \
  cb_dense_kernel<T><<<grid, rows_per_block, smem, static_cast<cudaStream_t>(stream)>>>( \
      static_cast<const T*>(tiles), static_cast<const float*>(xg),                        \
      static_cast<float*>(out), nrows, B, rows_per_block)
  CB_DISPATCH_DTYPE(dtype, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
