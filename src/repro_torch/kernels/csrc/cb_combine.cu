// Fixed-order segmented sum: the combine of CB-SpMV and CB-SpMM on Hopper.
//
// The JAX package adds every format's per-slot partials into the result
// with one XLA scatter-add (src/repro/kernels/ops.py, _combine_into and
// _cb_spmm_jit), which is deterministic there. Float atomicAdd is not: two
// runs may differ in the last bits. Here the order of every addition is a
// function of the plan and this code alone. The plan (kernels/cb_combine.py,
// plan_combine) sorts the slots by block row, stably, and cuts each row's run
// into chunks of at most a few hundred slots. The first pass sums every
// chunk: a row that is one chunk adds its sum to y there and then; the
// chunks of a longer row store their sums to a scratch buffer, and a second
// pass over those rows alone sums them in index order and adds that to y.
// So there are never more than two launches, and one where no row is longer
// than a chunk. No slot is skipped: padding slots add exact zeros, and an
// inf or NaN in x reaches its row as in the reference.
//
// One pass: src (n_src, R) float32; chunk c sums source rows
// perm[bounds[c].x .. bounds[c].y) (perm == nullptr: the positions
// themselves) and adds the sum to y[dst[c]*R ..] (skipping elements at or
// past `limit`, the ragged last block row), or, where dst[c] < 0, stores it
// to scratch row -1 - dst[c].
//
// Layout. A lane owns 4 consecutive columns (16-byte loads where R % 4 == 0
// and the bases are aligned, else 4-byte loads with guards). L lanes (a
// power of two, L = min(32, next_pow2(ceil(R/4)))) cover one slot's row, or
// a 128-column slice of it when R > 128. A chunk is spread over P slot
// positions (P * L <= 32 lanes, P from the plan): lane position p sums the
// chunk's slots p, p + P, p + 2P, ... in that order, with UNROLL slots'
// loads in flight and the next permutation entries fetched while they
// land; then a fixed __shfl_xor_sync tree (offsets L, 2L, .., P*L/2) adds
// the positions, and position 0 writes. At R = 16: 4 lanes a slot, 8 slots
// a warp per load, one chunk a warp. At R >= 128: one warp a 128-column
// slice, one slot at a time, UNROLL in flight.
//
// Bound: memory. The partials read once, one int32 of permutation per slot,
// y read and written once.
#include <stdint.h>

#include "cb_common.cuh"

constexpr int COMBINE_UNROLL = 4;     // slots each lane has in flight (cb_combine.py UNROLL)
constexpr int COMBINE_THREADS = 256;  // threads a block

// Up to 4 columns from p: one 16-byte load, or `n` 4-byte ones.
template <bool VEC>
__device__ __forceinline__ float4 combine_load(const float* p, int n) {
  if (VEC) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  v.x = __ldg(p);
  if (n > 1) v.y = __ldg(p + 1);
  if (n > 2) v.z = __ldg(p + 2);
  if (n > 3) v.w = __ldg(p + 3);
  return v;
}

__device__ __forceinline__ void combine_add(float4& a, const float4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

// The source rows of positions base + u*P + pos, u < UNROLL; -1 past hi.
template <int U>
__device__ __forceinline__ void combine_fetch(const int* __restrict__ perm, int base, int P,
                                              int pos, int hi, int (&s)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = base + u * P + pos;
    s[u] = j < hi ? (perm ? __ldg(perm + j) : j) : -1;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(COMBINE_THREADS)
cb_combine_kernel(const float* __restrict__ src, const int* __restrict__ perm,
                  const int2* __restrict__ bounds, const int* __restrict__ dst, float* y,
                  float* scratch, long long nchunks, int R, long long limit, int lshift,
                  int pshift, long long nslices, bool y_vec) {
  constexpr int U = COMBINE_UNROLL;
  const int L = 1 << lshift, P = 1 << pshift, W = L << pshift;
  const long long grp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >>
                        (lshift + pshift);
  const long long c = grp / nslices;
  if (c >= nchunks) return;  // whole groups leave together: W divides 32
  const int lane = threadIdx.x & 31;
  const unsigned mask = W == 32 ? 0xffffffffu : ((1u << W) - 1u) << (lane & ~(W - 1));
  const int pos = (lane >> lshift) & (P - 1);
  const long long col = ((grp - c * nslices) * L + (lane & (L - 1))) * 4;
  const int ncols = col < R ? static_cast<int>(min(4LL, R - col)) : 0;
  const int2 b = __ldg(bounds + c);
  const int d = __ldg(dst + c);

  // y's old value, fetched before the slot loop where it is one 16-byte word
  const long long at = static_cast<long long>(d) * R + col;
  const bool y_word = VEC && y_vec && d >= 0 && pos == 0 && ncols == 4 && at + 4 <= limit;
  float4 yv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (y_word) yv = *reinterpret_cast<const float4*>(y + at);

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int s[U];
  combine_fetch<U>(perm, b.x, P, pos, b.y, s);
  for (int base = b.x; base < b.y; base += U * P) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s[u] >= 0 && ncols > 0)
        v[u] = combine_load<VEC>(src + s[u] * static_cast<long long>(R) + col, ncols);
    }
    int sn[U];
    combine_fetch<U>(perm, base + U * P, P, pos, b.y, sn);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s[u] >= 0) combine_add(acc, v[u]);  // stored order: positions ascend
      s[u] = sn[u];
    }
  }
  for (int o = L; o < W; o <<= 1) {  // the fixed tree over the P positions
    float4 t;
    t.x = __shfl_xor_sync(mask, acc.x, o);
    t.y = __shfl_xor_sync(mask, acc.y, o);
    t.z = __shfl_xor_sync(mask, acc.z, o);
    t.w = __shfl_xor_sync(mask, acc.w, o);
    combine_add(acc, t);
  }
  if (pos != 0 || ncols == 0) return;

  if (d < 0) {  // a long row's chunk: its sum waits in scratch for the second pass
    float* out = scratch + static_cast<long long>(-1 - d) * R + col;
    if (VEC) {
      *reinterpret_cast<float4*>(out) = acc;
    } else {
      const float a[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < ncols) out[i] = a[i];
    }
  } else if (y_word) {
    combine_add(yv, acc);
    *reinterpret_cast<float4*>(y + at) = yv;
  } else {
    const float a[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < ncols && at + i < limit) y[at + i] += a[i];
  }
}

extern "C" int cb_segment_sum(const void* src, const void* perm, const void* bounds,
                              const void* dst, void* y, void* scratch, long long nchunks, int R,
                              long long limit, int positions, void* stream) {
  if (nchunks <= 0 || R <= 0 || positions <= 0 || (positions & (positions - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  int lshift = 0;
  while (lshift < 5 && (4LL << lshift) < R) ++lshift;
  int pshift = 0;
  while ((1 << pshift) < positions) ++pshift;
  if (lshift + pshift > 5) return static_cast<int>(cudaErrorInvalidValue);
  const long long nslices = (R + (4LL << lshift) - 1) / (4LL << lshift);
  const long long threads = (nchunks * nslices) << (lshift + pshift);
  const long long grid = (threads + COMBINE_THREADS - 1) / COMBINE_THREADS;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = R % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(scratch) % 16 == 0;
  const bool y_vec = reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const float*>(src);
  const auto* p = static_cast<const int*>(perm);
  const auto* bd = static_cast<const int2*>(bounds);
  const auto* d = static_cast<const int*>(dst);
  auto* yo = static_cast<float*>(y);
  auto* sc = static_cast<float*>(scratch);
  if (vec)
    cb_combine_kernel<true><<<static_cast<unsigned>(grid), COMBINE_THREADS, 0, st>>>(
        s, p, bd, d, yo, sc, nchunks, R, limit, lshift, pshift, nslices, y_vec);
  else
    cb_combine_kernel<false><<<static_cast<unsigned>(grid), COMBINE_THREADS, 0, st>>>(
        s, p, bd, d, yo, sc, nchunks, R, limit, lshift, pshift, nslices, y_vec);
  return static_cast<int>(cudaGetLastError());
}

// cudaGetErrorString for the Python loader's messages.
extern "C" const char* cb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
