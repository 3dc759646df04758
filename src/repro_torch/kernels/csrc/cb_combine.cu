// Fixed-order segmented sum: the combine of CB-SpMV on Hopper.
//
// The JAX package adds every format's per-slot partials into the (mb, B)
// result with one XLA scatter-add (src/repro/kernels/ops.py, _combine_into),
// which is deterministic there. Float atomicAdd is not: two runs may
// differ in the last bits. Here the order of every addition is decided on
// the host, once per stream: the slots are sorted by block row (stable),
// and each row's run of slots is cut into chunks of bounded length. One
// level of the sum adds each chunk in its stored order; levels repeat on
// the chunk sums until every row is one chunk, whose sum is added to y.
// A row with very many slots (a hub row, or block row 0, which collects
// the packer's empty slots) is therefore summed by many threads, not one,
// and the result is the same bits on every run.
//
// One level: src (n_src, B) float32; chunk c sums source rows
// perm[ptr[c] .. ptr[c+1]) (perm == nullptr: the positions themselves).
// Inner levels store the sum to dst[c]; the last level adds it to
// dst[rows[c]] and skips elements at or past `limit` (the ragged last
// block row of y).
//
// Bound: memory: (src + index + dst bytes) / HBM rate. One thread per
// (chunk, lane), lane fastest, so a warp reads whole B-float source rows.
#include "cb_common.cuh"

__global__ void cb_segment_sum_kernel(const float* __restrict__ src, const int* __restrict__ perm,
                                      const int* __restrict__ ptr, const int* __restrict__ rows,
                                      float* __restrict__ dst, long long nchunks, int B,
                                      long long limit) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= nchunks * B) return;
  const long long c = t / B;
  const int b = static_cast<int>(t % B);
  const int lo = __ldg(ptr + c), hi = __ldg(ptr + c + 1);
  float acc = 0.f;
  for (int j = lo; j < hi; ++j) {
    const long long s = perm ? __ldg(perm + j) : j;
    acc += __ldg(src + s * B + b);
  }
  if (rows) {
    const long long at = static_cast<long long>(__ldg(rows + c)) * B + b;
    if (at < limit) dst[at] += acc;
  } else {
    dst[c * B + b] = acc;
  }
}

extern "C" int cb_segment_sum(const void* src, const void* perm, const void* ptr,
                              const void* rows, void* dst, long long nchunks, int B,
                              long long limit, void* stream) {
  if (nchunks <= 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const unsigned grid = static_cast<unsigned>((nchunks * B + threads - 1) / threads);
  cb_segment_sum_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const int*>(perm),
      static_cast<const int*>(ptr), static_cast<const int*>(rows), static_cast<float*>(dst),
      nchunks, B, limit);
  return static_cast<int>(cudaGetLastError());
}

// cudaGetErrorString for the Python loader's messages.
extern "C" const char* cb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
