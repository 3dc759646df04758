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

// ---------------------------------------------------------------------------
// Bitmap-compacted panels: the same partials from the panels' non-zeros alone.
//
// Also replaces `panel_spmv_batched` (src/repro/kernels/cb_colagg.py:57), on an
// encoding of the same panels without their padding: mask (gp, B, S) uint8,
// S = W/8, bit k of mask[g, r, s] set iff panels[g, r, 8s + k] != 0; cvals
// (gp, B, E) in the payload type, row (g, r)'s non-zeros in ascending lane
// order, zero-padded to E (the stream's largest row count, rounded up so that
// a row is a multiple of 16 bytes); mask and cvals start 16-byte aligned (the
// wrapper checks both). xg and out are the padded kernel's.
//
// Bound: memory: (cvals + mask + xg + out bytes) / HBM rate. A 27-point
// stencil's panels hold a non-zero in about one lane of six, so this moves
// about a third of the padded kernel's bytes.
// Design: one thread block of CB_BITMAP_THREADS per group, one warp per row at
// a time, a slot a lane. __popc of the lane's mask byte and a warp scan
// (__shfl_up_sync) give the place of its first value in the row, and the lane
// adds value * x for its set bits in ascending lane order, from 0.f: the
// padded kernel's sum without its terms fmaf(0, x, acc) == acc, so for finite
// x the partials are bit-equal to it (an inf or NaN x at a lane the row does
// not hold makes the padded partial NaN, and leaves this one finite). They leave through the padded kernel's
// shared-memory transpose. A group of at most 32 slots whose cvals, mask, x
// and tile fit in CB_BITMAP_STAGE bytes (a stencil's take 6.6 KB) is first
// copied whole to shared memory by cp.async, 16 bytes a thread and all in
// flight at once, so the reads that wait on the mask are shared-memory reads
// and a block's rows are independent of each other. A wider group reads in
// place from global memory, a row's slots 32 at a time, crossing passes of
// `slots_per_pass` slots where its tile passes 32 KB, the row's running place
// in cvals kept in shared memory between them.
#define CB_FULL_WARP 0xffffffffu
#define CB_BITMAP_THREADS 64
#define CB_BITMAP_STAGE 49152

__device__ __forceinline__ void cb_cp_async(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src));
  }
}

// Copy `bytes` from global `src` to shared `dst` with the block's threads, in
// units of `unit` (16 or 4, dividing `bytes` and both addresses' alignment) by
// cp.async, or of 1 by plain loads.
__device__ __forceinline__ void cb_stage(void* dst, const void* src, int bytes, int unit) {
  if (unit == 1) {
    for (int i = threadIdx.x; i < bytes; i += blockDim.x) {
      static_cast<unsigned char*>(dst)[i] = static_cast<const unsigned char*>(src)[i];
    }
    return;
  }
  for (int i = threadIdx.x * unit; i < bytes; i += blockDim.x * unit) {
    cb_cp_async(static_cast<char*>(dst) + i, static_cast<const char*>(src) + i, unit);
  }
}

// A lane's partial for its slot: `m` its mask byte, the row's E values from
// `row`, the slot's x at `xs`, `base` the place of the warp's first value in the
// row. Sets *total to the values the warp's 32 slots hold. A mask that holds
// more lanes than the row has values stops the kernel (__trap), as cb_coo's
// index check does, rather than read past the row.
template <typename T>
__device__ __forceinline__ float cb_bitmap_slot(unsigned m, const T* row, int base, int E,
                                                const float* xs, int lane, int* total) {
  const int pop = __popc(m);
  int incl = pop;  // inclusive scan of the warp's counts
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(CB_FULL_WARP, incl, d);
    if (lane >= d) incl += t;
  }
  *total = __shfl_sync(CB_FULL_WARP, incl, 31);
  if (base + *total > E) __trap();
  int i = base + incl - pop;  // the place of the lane's first value in the row
  float acc = 0.f;
  for (unsigned rest = m; rest; rest &= rest - 1) {
    acc = fmaf(cb_to_float(row[i++]), xs[__ffs(rest) - 1], acc);
  }
  return acc;
}

template <typename T, bool STAGED>
__global__ void cb_panel_kernel_bitmap(const T* __restrict__ cvals,
                                       const unsigned char* __restrict__ mask,
                                       const float* __restrict__ xg, float* __restrict__ out,
                                       int B, int W, int E, int slots_per_pass, int mask_unit) {
  // shared: the tile slots_per_pass * (B + 1), then STAGED x, cvals and mask, else B row places
  extern __shared__ __align__(16) float tile[];
  const int S = W / CB_SLOT;
  const long long g = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  const int stride = B + 1;
  const T* cv = cvals + g * B * E;
  const unsigned char* mk = mask + g * B * S;
  const float* xr = xg + g * W;
  float* dst = out + g * S * B;
  int total;
  if constexpr (STAGED) {  // S <= 32: one pass, one stretch of slots a row
    float* sx = tile + ((S * stride + 3) & ~3);
    T* sv = reinterpret_cast<T*>(sx + W);
    unsigned char* sm = reinterpret_cast<unsigned char*>(sv + B * E);
    cb_stage(sx, xr, W * static_cast<int>(sizeof(float)), 16);
    cb_stage(sv, cv, B * E * static_cast<int>(sizeof(T)), 16);
    cb_stage(sm, mk, B * S, mask_unit);
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    const int s = lane;
    for (int r = warp; r < B; r += warps) {
      const unsigned m = s < S ? sm[r * S + s] : 0u;
      const float acc = cb_bitmap_slot(m, sv + r * E, 0, E, sx + s * CB_SLOT, lane, &total);
      if (s < S) tile[s * stride + r] = acc;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < S * B; j += blockDim.x) {
      dst[j] = tile[(j / B) * stride + j % B];
    }
  } else {
    int* place = reinterpret_cast<int*>(tile + slots_per_pass * stride);
    for (int r = threadIdx.x; r < B; r += blockDim.x) place[r] = 0;
    __syncthreads();
    for (int s0 = 0; s0 < S; s0 += slots_per_pass) {
      const int s1 = min(S, s0 + slots_per_pass);
      for (int r = warp; r < B; r += warps) {
        int base = place[r];
        for (int c = s0; c < s1; c += 32) {
          const int s = c + lane;
          const unsigned m = s < s1 ? mk[r * S + s] : 0u;
          const float acc =
              cb_bitmap_slot(m, cv + r * E, base, E, xr + s * CB_SLOT, lane, &total);
          if (s < s1) tile[(s - s0) * stride + r] = acc;
          base += total;
        }
        if (lane == 0) place[r] = base;
      }
      __syncthreads();
      for (int j = threadIdx.x; j < (s1 - s0) * B; j += blockDim.x) {
        dst[static_cast<long long>(s0) * B + j] = tile[(j / B) * stride + j % B];
      }
      __syncthreads();
    }
  }
}

extern "C" int cb_panel_spmv_bitmap(const void* cvals, const void* mask, const void* xg,
                                    void* out, long long groups, int B, int W, int E, int dtype,
                                    void* stream) {
  if (groups <= 0 || B <= 0 || W <= 0 || W % CB_SLOT || E < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int S = W / CB_SLOT;
  const int item = dtype == CB_BF16 ? 2 : dtype == CB_F64 ? 8 : 4;
  // one stretch of 32 slots a row, its whole tile, x, cvals and mask in shared memory
  const long long staged = (static_cast<long long>(S) * (B + 1) + 3) / 4 * 16 + 4LL * W +
                           static_cast<long long>(B) * E * item + static_cast<long long>(B) * S;
  const bool stage = S <= 32 && staged <= CB_BITMAP_STAGE;
  int slots_per_pass = S;
  if (!stage) {
    // a pass keeps its (slots, B+1) tile and the B row places within 32 KB
    slots_per_pass = (32768 / static_cast<int>(sizeof(float)) - B) / (B + 1);
    if (slots_per_pass < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (slots_per_pass > S) slots_per_pass = S;
  }
  const size_t smem = stage ? static_cast<size_t>(staged)
                            : (static_cast<size_t>(slots_per_pass) * (B + 1) + B) * sizeof(float);
  const int mask_unit = (B * S) % 16 == 0 ? 16 : (B * S) % 4 == 0 ? 4 : 1;
#define LAUNCH_AS(T, STAGED)                                                                  \
  cb_panel_kernel_bitmap<T, STAGED><<<static_cast<unsigned>(groups), CB_BITMAP_THREADS, smem, \
                                      static_cast<cudaStream_t>(stream)>>>(                   \
      static_cast<const T*>(cvals), static_cast<const unsigned char*>(mask),                  \
      static_cast<const float*>(xg), static_cast<float*>(out), B, W, E, slots_per_pass,       \
      mask_unit)
#define LAUNCH(T)            \
  if (stage) {               \
    LAUNCH_AS(T, true);      \
  } else {                   \
    LAUNCH_AS(T, false);     \
  }
  CB_DISPATCH_DTYPE(dtype, LAUNCH)
#undef LAUNCH
#undef LAUNCH_AS
  return static_cast<int>(cudaGetLastError());
}
