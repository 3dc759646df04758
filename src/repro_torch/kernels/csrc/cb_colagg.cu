// Column-compacted micro-panel CB-SpMV partials for Hopper.
//
// Replaces the TPU kernel `panel_spmv_batched` of the JAX package
// (src/repro/kernels/cb_colagg.py): panels (gp, B, W) in the payload type,
// xg (gp, W) float32 pre-gathered, W a multiple of 8, out (gp, W/8, B)
// float32 with out[g, s, r] = sum_{k<8} panels[g, r, 8s + k] * xg[g, 8s + k].
//
// Bound: memory. Each panel value is read once and used once; the floor is
// (panels + xg + out bytes) / HBM rate.
// Design: one thread block per group. Work items are (row, slot) pairs
// with the slot index fastest, so consecutive threads read consecutive
// 8-value runs of one panel row: every load is 16 bytes a thread and a
// warp covers one contiguous stretch. The x run of a slot is re-read by
// each of the B rows and stays in L1. The result is wanted slot-major
// (S, B) while the work runs row-major (B, S): partial sums go through a
// shared-memory tile (row stride B+1 words, so the transposed writes fall
// on different banks) and leave with one coalesced store. W is a runtime
// value of any size: slots are walked in passes of at most `slots_per_pass`.
#include "cb_common.cuh"

template <typename T>
__global__ void cb_panel_kernel(const T* __restrict__ panels, const float* __restrict__ xg,
                                float* __restrict__ out, int B, int W, int slots_per_pass) {
  extern __shared__ float tile[];  // slots_per_pass * (B + 1)
  const int S = W / CB_SLOT;
  const long long g = blockIdx.x;
  const T* slab = panels + g * B * W;
  const float* xrow = xg + g * W;
  float* dst = out + g * S * B;
  const int stride = B + 1;
  for (int s0 = 0; s0 < S; s0 += slots_per_pass) {
    const int sp = min(slots_per_pass, S - s0);
    for (int i = threadIdx.x; i < B * sp; i += blockDim.x) {
      const int r = i / sp, s = s0 + i % sp;
      float a[CB_SLOT], x[CB_SLOT];
      cb_load_slot(slab + static_cast<long long>(r) * W + s * CB_SLOT, a);
      cb_load_slot(xrow + s * CB_SLOT, x);
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < CB_SLOT; ++k) acc = fmaf(a[k], x[k], acc);
      tile[(s - s0) * stride + r] = acc;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < sp * B; j += blockDim.x) {
      dst[static_cast<long long>(s0) * B + j] = tile[(j / B) * stride + j % B];
    }
    __syncthreads();
  }
}

extern "C" int cb_panel_spmv(const void* panels, const void* xg, void* out, long long groups,
                             int B, int W, int dtype, void* stream) {
  if (groups <= 0 || B <= 0 || W <= 0 || W % CB_SLOT) return static_cast<int>(cudaErrorInvalidValue);
  const int S = W / CB_SLOT;
  // a pass keeps its (slots, B+1) tile within 32 KB of shared memory
  int slots_per_pass = 32768 / ((B + 1) * static_cast<int>(sizeof(float)));
  if (slots_per_pass < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (slots_per_pass > S) slots_per_pass = S;
  const size_t smem = static_cast<size_t>(slots_per_pass) * (B + 1) * sizeof(float);
  const int items = B * slots_per_pass;
  const int threads = items >= 256 ? 256 : ((items + 31) / 32) * 32;
#define LAUNCH(T)                                                                            \
  cb_panel_kernel<T><<<static_cast<unsigned>(groups), threads, smem,                        \
                       static_cast<cudaStream_t>(stream)>>>(                                \
      static_cast<const T*>(panels), static_cast<const float*>(xg), static_cast<float*>(out), \
      B, W, slots_per_pass)
  CB_DISPATCH_DTYPE(dtype, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
