// CB-SpMM per-slot partials for Hopper: block-sparse weights times dense X.
//
// Replaces the TPU kernel `super_tile_spmm` of the JAX package
// (src/repro/kernels/cb_spmm.py, body `_spmm_group_kernel`): tiles
// (gt, Gt*B, B) in the payload type (float32, bfloat16, float64), bcol
// (gt, Gt) int32, xb (nb, B, N) float32 or bfloat16, out (gt, Gt, B, N)
// float32 with, for the flat slot s = i*Gt + g,
//   out[s, r, n] = sum_c tiles[s*B + r, c] * xb[bcol[s], c, n].
// B is a runtime value from 1 to 128, N is taken as it is (tail masked),
// an empty slot (zero tile, bcol 0) gives exact zeros for finite X, and no
// atomics are used, so two runs give the same bits. The group axis carries
// no meaning for the product: the kernels walk flat slots.
//
// The launcher picks one of two kernels from B alone.
//
// Wide (B > 32; the sparse MLP's B = 128, N in the thousands): bound by
// operations, 2*B*B*N flops per slot against B*B payload values, B*N X
// values (mostly from L2: many slots share an X block) and B*N partials.
// The Pallas kernel's dot_general is float32-grade, so the products run on
// the tensor cores as 3xTF32 (`mma.sync.m16n8k8` TF32): each operand is
// split with cvt.rna into hi + lo, both TF32, and lo*hi, hi*lo, hi*hi are
// summed in float32 accumulators, c ascending in steps of 8. That keeps
// float32's error (small integers stay exact: their lo halves are 0), and
// its floor is 3 TF32 products per product, 495/3 = 165 TFLOP/s. The split
// is ALU work beside every product, so each value is split as few times as
// it can be. A block owns one slot and WIDE_NB columns of N: it reads the
// slot's tile once (WIDE_NB / WIDE_TN output tiles reuse it), splits it once
// into (hi, lo) pairs in shared memory (rows padded to 132 pairs so the
// 8-byte fragment loads fall in 32 banks), then streams X through a ring of
// 2 cp.async stages of (32 rows of c) x (256 columns of n) (rows padded to
// 264 words); 16 warps each keep a 64 x 32 output tile in registers and
// split their X fragments as they load them. A stage whose m-tiles, n-tiles
// and k-steps are all live (B = 128 away from the N tail) runs without the
// guards. The 16-byte cp.async needs 16-byte aligned X
// rows (N % 4 == 0 and an aligned base); otherwise the launcher takes the
// 4-byte copy. bfloat16 X is converted on the way in by plain loads, and its
// lo half (like a bfloat16 tile's) is 0, so that product is skipped.
// 202,752 B of dynamic shared memory: one block of 512 threads an SM.
//
// Narrow (B <= 32; the solver's B = 8, 16, 24, N = 16): bound by bytes,
// about 2.7 flops a byte at B = N = 16, so float32 fmaf is enough and the
// aim is to keep every lane busy and every load wide. One warp owns one slot
// and 8 slots share a block, with no block-wide barrier: each warp stages
// its tile (rows padded to B+1 words) and NW (16 or 32) columns of its X block
// in its own shared region, 16-byte loads where alignment allows, and syncs
// with __syncwarp. Lanes map onto (row, column): column = lane % NW, rows
// lane / NW + (32 / NW) * i, so at N = 16 all 32 lanes are live; wider N
// loops over column chunks. The sum runs over c in ascending order.
#include <climits>
#include <cstdint>

#include "cb_common.cuh"

#define WIDE_THREADS 512
#define WIDE_NB 2048   // columns of N a wide block owns
#define WIDE_TN 256    // columns per output tile (16 warps: 2 across rows x 8 across columns)
#define WIDE_KC 32     // reduction rows of X per cp.async stage
#define WIDE_SA 132    // tile row stride in (hi, lo) pairs: 132 % 16 == 4, A fragments conflict-free
#define WIDE_SX 264    // X row stride in words: 264 % 32 == 8, B fragments conflict-free
#define WIDE_STAGES 2
#define WIDE_SMEM (128 * WIDE_SA * 8 + WIDE_STAGES * WIDE_KC * WIDE_SX * 4)

#define NARROW_WARPS 8  // slots per block
#define NARROW_MAX_B 32

template <typename T> struct IsBf16 { static constexpr bool value = false; };
template <> struct IsBf16<__nv_bfloat16> { static constexpr bool value = true; };

// ---------------------------------------------------------------------------
// 3xTF32 pieces
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32; lo is left 0 when the caller knows it is exactly 0
template <bool LO>
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = LO ? tf32_rna(x - __uint_as_float(hi)) : 0u;
}

// d += a (16x8, row) * b (8x8, col), TF32 inputs, float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// cp.async with a source size: 0 bytes read fills the destination with zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// ---------------------------------------------------------------------------
// wide: B > 32, tensor cores
// ---------------------------------------------------------------------------

// Stage X rows [k0, k0+32) x columns [n0, n0+256) of one X block into `xs`;
// rows >= B and columns >= N become zeros. VEC: 16-byte copies (X rows
// 16-byte aligned), else 4-byte copies; bfloat16 X goes through registers.
template <typename XT, bool VEC>
__device__ __forceinline__ void wide_stage_x(float* xs, const XT* x, int k0, int n0, int B,
                                             int N) {
  const int tid = threadIdx.x;
  if constexpr (IsBf16<XT>::value) {
#pragma unroll 4
    for (int i = tid; i < WIDE_KC * WIDE_TN; i += WIDE_THREADS) {
      const int r = i / WIDE_TN, n = i % WIDE_TN;
      const bool ok = k0 + r < B && n0 + n < N;
      xs[r * WIDE_SX + n] =
          ok ? cb_to_float(x[static_cast<long long>(k0 + r) * N + n0 + n]) : 0.f;
    }
  } else if constexpr (VEC) {
#pragma unroll
    for (int i = tid; i < WIDE_KC * WIDE_TN / 4; i += WIDE_THREADS) {
      const int r = i / (WIDE_TN / 4), n = (i % (WIDE_TN / 4)) * 4;
      const bool ok = k0 + r < B && n0 + n < N;     // N % 4 == 0: all four or none
      cp_async16(xs + r * WIDE_SX + n,
                 ok ? x + static_cast<long long>(k0 + r) * N + n0 + n : x, ok);
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < WIDE_KC * WIDE_TN; i += WIDE_THREADS) {
      const int r = i / WIDE_TN, n = i % WIDE_TN;
      const bool ok = k0 + r < B && n0 + n < N;
      cp_async4(xs + r * WIDE_SX + n, ok ? x + static_cast<long long>(k0 + r) * N + n0 + n : x,
                ok);
    }
  }
}

// One k-step (8 reduction columns) of one warp's products:
// acc[mi][ni] += A[m-tile mi] * X[n-tile ni], lo*hi, hi*lo, hi*hi in that order.
// `ap` points at the warp's (g, t) (hi, lo) pair, `xp` at its (t, g) X word.
// FULL (every m-tile and n-tile live) drops the guards.
template <bool FULL, bool A_LO, bool X_LO>
__device__ __forceinline__ void wide_mma_kstep(float (&acc)[4][4][4], const uint2* ap,
                                               const float* xp, int mlive, int nlive) {
  uint32_t bh[4][2], bl[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    tf32_split<X_LO>(xp[ni * 8], bh[ni][0], bl[ni][0]);
    tf32_split<X_LO>(xp[4 * WIDE_SX + ni * 8], bh[ni][1], bl[ni][1]);
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    if (FULL || mi < mlive) {
      const uint2* am = ap + mi * 16 * WIDE_SA;
      const uint2 a0 = am[0], a1 = am[8 * WIDE_SA], a2 = am[4], a3 = am[8 * WIDE_SA + 4];
      const uint32_t ah[4] = {a0.x, a1.x, a2.x, a3.x}, al[4] = {a0.y, a1.y, a2.y, a3.y};
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        if (FULL || ni < nlive) {
          if (A_LO) mma_tf32(acc[mi][ni], al, bh[ni]);
          if (X_LO) mma_tf32(acc[mi][ni], ah, bl[ni]);
          mma_tf32(acc[mi][ni], ah, bh[ni]);
        }
      }
    }
  }
}

// One X stage's k-steps for one warp. A full stage (every m-tile, n-tile and
// k-step live: B = 128 away from the N tail) runs unguarded and not unrolled
// across k-steps, which keeps it inside 128 registers with no spills.
template <bool A_LO, bool X_LO>
__device__ __forceinline__ void wide_mma_stage(float (&acc)[4][4][4], const uint2* ap,
                                               const float* xp, int ksteps, int mlive,
                                               int nlive) {
  if (mlive == 4 && nlive == 4 && ksteps == WIDE_KC / 8) {   // warp-uniform
#pragma unroll 1
    for (int ks = 0; ks < WIDE_KC / 8; ++ks)
      wide_mma_kstep<true, A_LO, X_LO>(acc, ap + ks * 8, xp + ks * 8 * WIDE_SX, 4, 4);
  } else {
#pragma unroll
    for (int ks = 0; ks < WIDE_KC / 8; ++ks)
      if (ks < ksteps)
        wide_mma_kstep<false, A_LO, X_LO>(acc, ap + ks * 8, xp + ks * 8 * WIDE_SX, mlive, nlive);
  }
}

template <typename T, typename XT, bool VEC>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
    cb_spmm_wide(const T* __restrict__ tiles, const int* __restrict__ bcol,
                 const XT* __restrict__ xb, float* __restrict__ out, int B, int N) {
  constexpr bool A_LO = !IsBf16<T>::value;   // bfloat16 values are TF32: lo == 0
  constexpr bool X_LO = !IsBf16<XT>::value;
  extern __shared__ __align__(16) float smem[];
  uint2* as = reinterpret_cast<uint2*>(smem);   // [128][WIDE_SA] (hi, lo) TF32 pairs
  float* xring = smem + 128 * WIDE_SA * 2;      // [WIDE_STAGES][WIDE_KC][WIDE_SX]

  const long long s = blockIdx.x;
  const int nbeg = blockIdx.y * WIDE_NB;
  const int nend = min(N, nbeg + WIDE_NB);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;      // mma fragment coordinates
  const int wm = warp / 8, wn = warp % 8;    // warp's 64 rows x 32 columns
  const int kp = (B + 7) / 8 * 8;            // reduction length padded to the mma's 8
  const int kchunks = (kp + WIDE_KC - 1) / WIDE_KC;
  const int ntiles = (nend - nbeg + WIDE_TN - 1) / WIDE_TN;
  const int total = ntiles * kchunks;
  const XT* x = xb + static_cast<long long>(__ldg(bcol + s)) * B * N;

  // first X stage in flight while the tile is split into shared memory, once
  wide_stage_x<XT, VEC>(xring, x, 0, nbeg, B, N);
  cp_async_commit();
  {
    const T* a = tiles + s * B * B;
    const int mp = min(128, (B + 15) / 16 * 16);   // rows the live m-tiles read
    for (int r = warp; r < mp; r += WIDE_THREADS / 32) {
#pragma unroll 4
      for (int c = lane; c < kp; c += 32) {
        uint2 v;
        tf32_split<A_LO>((r < B && c < B) ? cb_to_float(a[static_cast<long long>(r) * B + c]) : 0.f,
                         v.x, v.y);
        as[r * WIDE_SA + c] = v;
      }
    }
  }

  const int mlive = min(4, max(0, (B - wm * 64 + 15) / 16));   // warp's m-tiles with rows < B
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  int kc = 0, n0 = nbeg;
  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) {                    // next stage into the other buffer
      const int kn = kc + 1 == kchunks ? 0 : kc + 1;
      const int nn = kc + 1 == kchunks ? n0 + WIDE_TN : n0;
      wide_stage_x<XT, VEC>(xring + ((it + 1) % WIDE_STAGES) * WIDE_KC * WIDE_SX, x,
                            kn * WIDE_KC, nn, B, N);
    }
    cp_async_commit();                       // possibly empty: keeps the count uniform
    cp_async_wait_one();                     // this iteration's stage has landed
    __syncthreads();

    const float* xs = xring + (it % WIDE_STAGES) * WIDE_KC * WIDE_SX + t * WIDE_SX + wn * 32 + g;
    const uint2* ap = as + (wm * 64 + g) * WIDE_SA + kc * WIDE_KC + t;
    const int nlive = min(4, max(0, (N - n0 - wn * 32 + 7) / 8));   // warp's n-tiles < N
    const int ksteps = min(WIDE_KC, kp - kc * WIDE_KC) / 8;
    wide_mma_stage<A_LO, X_LO>(acc, ap, xs, ksteps, mlive, nlive);
    __syncthreads();                         // the buffer is refilled next iteration

    if (++kc == kchunks) {                   // output tile done: store, reset
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = n0 + wn * 32 + ni * 8 + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm * 64 + mi * 16 + g + 8 * h;
            const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
            acc[mi][ni][2 * h] = acc[mi][ni][2 * h + 1] = 0.f;
            if (r >= B || n >= N) continue;
            float* o = out + (s * B + r) * static_cast<long long>(N) + n;
            if (n + 1 < N && (N & 1) == 0) {
              *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
            } else {
              o[0] = v0;
              if (n + 1 < N) o[1] = v1;
            }
          }
        }
      }
      kc = 0;
      n0 += WIDE_TN;
    }
  }
}

// ---------------------------------------------------------------------------
// narrow: B <= 32, float32 FMA, one warp per slot
// ---------------------------------------------------------------------------

// 16 bytes of payload as float32: 4 floats, 8 bfloat16 or 2 doubles
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load16(const double* p, float* v) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = static_cast<float>(a.x);
  v[1] = static_cast<float>(a.y);
}

template <typename T, typename XT, int NW, int RM>
__global__ void __launch_bounds__(NARROW_WARPS * 32)
    cb_spmm_narrow(const T* __restrict__ tiles, const int* __restrict__ bcol,
                   const XT* __restrict__ xb, float* __restrict__ out, long long slots, int B,
                   int N, bool tile_vec, bool x_vec) {
  constexpr int RG = 32 / NW;                // row groups
  constexpr int VT = 16 / sizeof(T), VX = 16 / sizeof(XT);
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long s = static_cast<long long>(blockIdx.x) * NARROW_WARPS + warp;
  if (s >= slots) return;                    // no block-wide barrier below
  const int sa = B + 1;                      // tile row stride: row groups in other banks
  float* as = smem + warp * (B * sa + B * NW);
  float* xs = as + B * sa;                   // [B][NW]
  const int col = lane % NW, rg = lane / NW;
  const int rows = (B - rg + RG - 1) / RG;   // rows rg + RG*i < B this lane owns

  const T* a = tiles + s * B * B;
  if (tile_vec) {                            // B*B*sizeof(T) % 16 == 0, aligned base
    for (int i = lane * VT; i < B * B; i += 32 * VT) {
      float v[VT];
      load16(a + i, v);
#pragma unroll
      for (int j = 0; j < VT; ++j) as[(i + j) / B * sa + (i + j) % B] = v[j];
    }
  } else {
    for (int i = lane; i < B * B; i += 32) as[i / B * sa + i % B] = cb_to_float(a[i]);
  }
  const XT* x = xb + static_cast<long long>(__ldg(bcol + s)) * B * N;

  for (int n0 = 0; n0 < N; n0 += NW) {
    __syncwarp();                            // the previous chunk's reads are done
    if (x_vec) {                             // N % VX == 0, aligned base: VX columns or none
      for (int i = lane; i < B * (NW / VX); i += 32) {
        const int c = i / (NW / VX), j = (i % (NW / VX)) * VX;
        float v[VX];
        if (n0 + j < N) {
          load16(x + static_cast<long long>(c) * N + n0 + j, v);
        } else {
#pragma unroll
          for (int q = 0; q < VX; ++q) v[q] = 0.f;
        }
#pragma unroll
        for (int q = 0; q < VX; ++q) xs[c * NW + j + q] = v[q];
      }
    } else {
      for (int i = lane; i < B * NW; i += 32) {
        const int c = i / NW, j = i % NW;
        xs[i] = n0 + j < N ? cb_to_float(x[static_cast<long long>(c) * N + n0 + j]) : 0.f;
      }
    }
    __syncwarp();

    float acc[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) acc[i] = 0.f;
    const float* ar = as + rg * sa;
#pragma unroll 4
    for (int c = 0; c < B; ++c) {
      const float xv = xs[c * NW + col];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        if (i < rows) acc[i] = fmaf(ar[i * RG * sa + c], xv, acc[i]);
    }
    const int n = n0 + col;
    if (n < N) {
#pragma unroll
      for (int i = 0; i < RM; ++i)
        if (i < rows) out[(s * B + rg + RG * i) * static_cast<long long>(N) + n] = acc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// launcher
// ---------------------------------------------------------------------------

template <typename T, typename XT, bool VEC>
static int launch_wide(const void* tiles, const void* bcol, const void* xb, void* out,
                       long long slots, int B, int N, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      cb_spmm_wide<T, XT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, WIDE_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(slots), static_cast<unsigned>((N + WIDE_NB - 1) / WIDE_NB));
  cb_spmm_wide<T, XT, VEC><<<grid, WIDE_THREADS, WIDE_SMEM, st>>>(
      static_cast<const T*>(tiles), static_cast<const int*>(bcol), static_cast<const XT*>(xb),
      static_cast<float*>(out), B, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename XT, int NW, int RM>
static int launch_narrow(const void* tiles, const void* bcol, const void* xb, void* out,
                         long long slots, int B, int N, cudaStream_t st) {
  constexpr int most = NARROW_WARPS * (NARROW_MAX_B * (NARROW_MAX_B + 1) + NARROW_MAX_B * NW) * 4;
  static const cudaError_t attr = cudaFuncSetAttribute(
      cb_spmm_narrow<T, XT, NW, RM>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t smem = static_cast<size_t>(NARROW_WARPS) * (B * (B + 1) + B * NW) * 4;
  const bool tile_vec = (static_cast<long long>(B) * B * sizeof(T)) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(tiles) % 16 == 0;
  const bool x_vec = N % (16 / sizeof(XT)) == 0 && reinterpret_cast<uintptr_t>(xb) % 16 == 0;
  const long long blocks = (slots + NARROW_WARPS - 1) / NARROW_WARPS;
  cb_spmm_narrow<T, XT, NW, RM><<<static_cast<unsigned>(blocks), NARROW_WARPS * 32, smem, st>>>(
      static_cast<const T*>(tiles), static_cast<const int*>(bcol), static_cast<const XT*>(xb),
      static_cast<float*>(out), slots, B, N, tile_vec, x_vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename XT>
static int launch(const void* tiles, const void* bcol, const void* xb, void* out,
                  long long slots, int B, int N, cudaStream_t st) {
  if (B > NARROW_MAX_B) {
    if constexpr (IsBf16<XT>::value) {
      return launch_wide<T, XT, false>(tiles, bcol, xb, out, slots, B, N, st);
    } else {
      const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(xb) % 16 == 0;
      return vec ? launch_wide<T, XT, true>(tiles, bcol, xb, out, slots, B, N, st)
                 : launch_wide<T, XT, false>(tiles, bcol, xb, out, slots, B, N, st);
    }
  }
  // column span NW: all 32 lanes live at N = 16; RM rows a lane owns at most
  if (N <= 16)
    return B <= 16 ? launch_narrow<T, XT, 16, 8>(tiles, bcol, xb, out, slots, B, N, st)
                   : launch_narrow<T, XT, 16, 16>(tiles, bcol, xb, out, slots, B, N, st);
  return B <= 16 ? launch_narrow<T, XT, 32, 16>(tiles, bcol, xb, out, slots, B, N, st)
                 : launch_narrow<T, XT, 32, 32>(tiles, bcol, xb, out, slots, B, N, st);
}

extern "C" int cb_spmm(const void* tiles, const void* bcol, const void* xb, void* out,
                       long long slots, int B, int N, int tdtype, int xdtype, void* stream) {
  if (slots <= 0 || slots > INT_MAX || B <= 0 || B > 128 || N <= 0 ||
      (B > NARROW_MAX_B && (N + WIDE_NB - 1) / WIDE_NB > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(T)                                                               \
  switch (xdtype) {                                                             \
    case CB_F32: return launch<T, float>(tiles, bcol, xb, out, slots, B, N, st); \
    case CB_BF16:                                                               \
      return launch<T, __nv_bfloat16>(tiles, bcol, xb, out, slots, B, N, st);   \
    default: return static_cast<int>(cudaErrorInvalidValue);                    \
  }
  CB_DISPATCH_DTYPE(tdtype, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
