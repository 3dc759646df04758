// Block-COO CB-SpMV partials (paper Alg. 3) for Hopper, x read in place.
//
// Replaces the TPU kernel `coo_spmv_batched` of the JAX package
// (src/repro/kernels/cb_coo.py:71), which takes x pre-gathered: codes
// (gc, W) int32 packed coordinates (col << bits | row), vals (gc, W) in the
// payload type (0 on padding lanes), xidx (gc, W) int32 indices into x (0 on
// padding lanes), x (n,) float32, W a multiple of 8, out (gc, W/8, B)
// float32: every lane adds vals * x[xidx] into row `code & mask` of its slot
// (slot = lane / 8). `mask` is (1 << coord_bits(B)) - 1, never B - 1: B = 24
// has holes.
//
// Bound: memory. The streams cross HBM once: (codes + vals + xidx + out
// bytes) / HBM rate, 4*B bytes of partials leaving for every 8 lanes (each
// 4 + 4 + 4 + sizeof(val) bytes) that come in; besides, every lane reads 4
// bytes of x, which for an x of a few MB comes from L2, not HBM.
// Design: the TPU kernel multiplies by a one-hot matrix because that chip
// cannot scatter; here each slot is one thread that walks its 8 lanes in
// lane order and adds into its own row of a zeroed shared-memory tile. No
// two threads share a slot, so there are no atomics and the order of the
// additions is fixed: the result is deterministic. The TPU path gathers x
// into a stream as large as the indices before the kernel; here the kernel
// reads x itself, by the index it loads, so that intermediate never touches
// HBM. x stays in the 50 MB L2 (the read-only path, __ldg), and each thread
// issues its 8 dependent loads of x together, before its first addition, so
// their L2 latency overlaps. The group axis carries no meaning (slots are a
// flat list of gc * W/8), so a block takes 128 consecutive slots whatever W
// is; the streams load 16 bytes a thread over one contiguous stretch, and the
// (slots, B) tile leaves with a coalesced store. An index outside [0, n)
// stops the kernel (__trap), as a failed bounds check of a gather would.
#include "cb_common.cuh"

#define CB_COO_THREADS 128

template <typename T>
__global__ void cb_coo_kernel(const int* __restrict__ codes, const T* __restrict__ vals,
                              const int* __restrict__ xidx, const float* __restrict__ x,
                              float* __restrict__ out, long long nslots, long long n, int B,
                              int mask) {
  extern __shared__ float tile[];  // CB_COO_THREADS * (B + 1)
  const long long slot0 = static_cast<long long>(blockIdx.x) * CB_COO_THREADS;
  const int slots = static_cast<int>(min(static_cast<long long>(CB_COO_THREADS), nslots - slot0));
  const int stride = B + 1;
  for (int i = threadIdx.x; i < slots * stride; i += blockDim.x) tile[i] = 0.f;
  __syncthreads();
  if (threadIdx.x < slots) {
    const long long lane0 = (slot0 + threadIdx.x) * CB_SLOT;
    int idx[CB_SLOT], code[CB_SLOT];
    float v[CB_SLOT], xv[CB_SLOT];
    cb_load_slot(xidx + lane0, idx);  // first: the loads of x wait for it
    cb_load_slot(codes + lane0, code);
    cb_load_slot(vals + lane0, v);
#pragma unroll
    for (int k = 0; k < CB_SLOT; ++k) {
      if (static_cast<unsigned long long>(static_cast<long long>(idx[k])) >=
          static_cast<unsigned long long>(n)) {
        __trap();
      }
    }
#pragma unroll
    for (int k = 0; k < CB_SLOT; ++k) xv[k] = __ldg(x + idx[k]);  // all 8 in flight at once
    float* mine = tile + threadIdx.x * stride;
#pragma unroll
    for (int k = 0; k < CB_SLOT; ++k) {
      const int row = code[k] & mask;
      if (row < B) mine[row] += v[k] * xv[k];  // rows >= B never occur in valid streams
    }
  }
  __syncthreads();
  float* dst = out + slot0 * B;
  for (int j = threadIdx.x; j < slots * B; j += blockDim.x) {
    dst[j] = tile[(j / B) * stride + j % B];
  }
}

extern "C" int cb_coo_spmv(const void* codes, const void* vals, const void* xidx, const void* x,
                           void* out, long long nslots, long long n, int B, int mask, int dtype,
                           void* stream) {
  if (nslots <= 0 || n <= 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(CB_COO_THREADS) * (B + 1) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((nslots + CB_COO_THREADS - 1) / CB_COO_THREADS);
#define LAUNCH(T)                                                                          \
  cb_coo_kernel<T><<<grid, CB_COO_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(    \
      static_cast<const int*>(codes), static_cast<const T*>(vals),                         \
      static_cast<const int*>(xidx), static_cast<const float*>(x), static_cast<float*>(out), \
      nslots, n, B, mask)
  CB_DISPATCH_DTYPE(dtype, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
