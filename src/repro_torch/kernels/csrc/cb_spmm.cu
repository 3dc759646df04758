// CB-SpMM per-slot partials for Hopper: block-sparse weights times dense X.
//
// Replaces the TPU kernel `super_tile_spmm` of the JAX package
// (src/repro/kernels/cb_spmm.py, body `_spmm_group_kernel`): tiles
// (gt, Gt*B, B) in the payload type (float32, bfloat16, float64), bcol
// (gt, Gt) int32, xb (nb, B, N) float32 or bfloat16, out (gt, Gt, B, N)
// float32 with, for the flat slot s = i*Gt + g,
//   out[s, r, n] = sum_c tiles[s*B + r, c] * xb[bcol[s], c, n].
//
// Bound: at B = 128 and N in the thousands, operations: 2*B*B*N flops per
// slot against B*B payload values read once and B*N floats written, so the
// floor is flops / the float32 FMA rate (no tensor cores here: TF32 or bf16
// MMA would change the numbers). At B = 16 and N = 16 (the solver's
// multi-RHS product) it is bytes: tiles + X blocks + partials over HBM.
// Design: the group axis carries no meaning for the product (as in
// cb_block_dense.cu), so a block owns one slot's (B, SPMM_BN) output tile:
// grid = (slots, ceil(N / SPMM_BN)). It stages the slot's tile and the X
// block that bcol names into shared memory SPMM_KC reduction columns at a
// time, converting to float32 on the way (tile row stride padded by one
// word so the row reads below fall in different banks), then each thread
// accumulates an (up to 8 rows) x 4 columns register tile with fmaf, in
// ascending c. Rows are strided by SPMM_TY so B = 8, 16, 24 and 128 all map
// onto the same 256 threads; B is a runtime value up to 128. The N tail and
// rows past B are masked. An empty slot (zero tile, bcol 0) gives exact
// zeros for finite X. 25 KB of static shared memory: no opt-in needed.
#include <climits>

#include "cb_common.cuh"

#define SPMM_THREADS 256
#define SPMM_BN 64  // output columns a block owns
#define SPMM_KC 32  // reduction columns staged per step
#define SPMM_TX 16  // threads across the columns, 4 columns each
#define SPMM_TY 16  // threads across the rows
#define SPMM_RM 8   // rows a thread owns at most: B <= SPMM_TY * SPMM_RM

template <typename T, typename XT>
__global__ void __launch_bounds__(SPMM_THREADS)
    cb_spmm_kernel(const T* __restrict__ tiles, const int* __restrict__ bcol,
                   const XT* __restrict__ xb, float* __restrict__ out, int B, int N) {
  __shared__ float as[SPMM_TY * SPMM_RM][SPMM_KC + 1];
  __shared__ __align__(16) float xs[SPMM_KC][SPMM_BN];
  const long long s = blockIdx.x;
  const int n0 = blockIdx.y * SPMM_BN;
  const int tid = threadIdx.x;
  const int tx = tid % SPMM_TX, ty = tid / SPMM_TX;
  const int rm = (B + SPMM_TY - 1) / SPMM_TY;  // rows this block's threads own
  const T* a = tiles + s * B * B;
  const XT* x = xb + static_cast<long long>(__ldg(bcol + s)) * B * N;

  float acc[SPMM_RM][4];
#pragma unroll
  for (int i = 0; i < SPMM_RM; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < B; k0 += SPMM_KC) {
    const int kc = min(SPMM_KC, B - k0);
    for (int i = tid; i < B * SPMM_KC; i += SPMM_THREADS) {
      const int r = i / SPMM_KC, c = i % SPMM_KC;
      as[r][c] = c < kc ? cb_to_float(a[static_cast<long long>(r) * B + k0 + c]) : 0.f;
    }
    for (int i = tid; i < SPMM_KC * SPMM_BN; i += SPMM_THREADS) {
      const int c = i / SPMM_BN, n = i % SPMM_BN;
      xs[c][n] = (c < kc && n0 + n < N)
                     ? cb_to_float(x[static_cast<long long>(k0 + c) * N + n0 + n])
                     : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < kc; ++c) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[c][tx * 4]);
#pragma unroll
      for (int i = 0; i < SPMM_RM; ++i) {
        if (i < rm) {
          const float av = as[ty + i * SPMM_TY][c];
          acc[i][0] = fmaf(av, xv.x, acc[i][0]);
          acc[i][1] = fmaf(av, xv.y, acc[i][1]);
          acc[i][2] = fmaf(av, xv.z, acc[i][2]);
          acc[i][3] = fmaf(av, xv.w, acc[i][3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < SPMM_RM; ++i) {
    const int r = ty + i * SPMM_TY;
    if (i < rm && r < B) {
      float* o = out + (s * B + r) * static_cast<long long>(N);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (n < N) o[n] = acc[i][j];
      }
    }
  }
}

extern "C" int cb_spmm(const void* tiles, const void* bcol, const void* xb, void* out,
                       long long slots, int B, int N, int tdtype, int xdtype, void* stream) {
  const long long ntiles = (static_cast<long long>(N) + SPMM_BN - 1) / SPMM_BN;
  if (slots <= 0 || slots > INT_MAX || B <= 0 || B > SPMM_TY * SPMM_RM || N <= 0 ||
      ntiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(slots), static_cast<unsigned>(ntiles));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH2(T, XT)                                                                  \
  cb_spmm_kernel<T, XT><<<grid, SPMM_THREADS, 0, st>>>(                                 \
      static_cast<const T*>(tiles), static_cast<const int*>(bcol),                      \
      static_cast<const XT*>(xb), static_cast<float*>(out), B, N)
#define LAUNCH(T)                                                \
  switch (xdtype) {                                              \
    case CB_F32: LAUNCH2(T, float); break;                       \
    case CB_BF16: LAUNCH2(T, __nv_bfloat16); break;              \
    default: return static_cast<int>(cudaErrorInvalidValue);     \
  }
  CB_DISPATCH_DTYPE(tdtype, LAUNCH)
#undef LAUNCH
#undef LAUNCH2
  return static_cast<int>(cudaGetLastError());
}
