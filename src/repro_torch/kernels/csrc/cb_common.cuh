// Shared pieces of the CB-SpMV kernels: payload types and their loads.
//
// Every kernel reads the matrix payload in its stored type (float32,
// bfloat16 or float64), converts to float32 in registers, accumulates in
// float32 and writes float32 partials. Each entry point has a plain C
// signature (pointers, ints, the stream as a pointer), launches on the
// stream it is given, allocates nothing, does not synchronise and returns
// cudaGetLastError() as an int.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define CB_SLOT 8  // lanes per slot: slot = lane / CB_SLOT (SUBLANE in Python)

// dtype codes shared with the Python loader (kernels/_build.py)
#define CB_F32 0
#define CB_BF16 1
#define CB_F64 2

__device__ __forceinline__ float cb_to_float(float v) { return v; }
__device__ __forceinline__ float cb_to_float(double v) { return static_cast<float>(v); }
__device__ __forceinline__ float cb_to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Load CB_SLOT consecutive payload values as float32 with 16-byte loads.
// `p` must be aligned to CB_SLOT elements of T (slots always are: widths
// are multiples of CB_SLOT and torch allocations are 256-byte aligned).
__device__ __forceinline__ void cb_load_slot(const float* p, float (&v)[CB_SLOT]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void cb_load_slot(const double* p, float (&v)[CB_SLOT]) {
#pragma unroll
  for (int i = 0; i < CB_SLOT / 2; ++i) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p) + i);
    v[2 * i] = static_cast<float>(a.x);
    v[2 * i + 1] = static_cast<float>(a.y);
  }
}

__device__ __forceinline__ void cb_load_slot(const __nv_bfloat16* p, float (&v)[CB_SLOT]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < CB_SLOT / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cb_load_slot(const int* p, int (&v)[CB_SLOT]) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(p));
  const int4 b = __ldg(reinterpret_cast<const int4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Run `LAUNCH(T)` with T the C++ type of payload dtype code `dtype`;
// an unknown code is reported as cudaErrorInvalidValue.
#define CB_DISPATCH_DTYPE(dtype, LAUNCH)                   \
  switch (dtype) {                                         \
    case CB_F32: { LAUNCH(float); break; }                 \
    case CB_BF16: { LAUNCH(__nv_bfloat16); break; }        \
    case CB_F64: { LAUNCH(double); break; }                \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
