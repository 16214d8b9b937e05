// Warp-level helpers shared by the solver kernels: an inclusive scan,
// order-preserving float keys for one-instruction warp reductions, and
// the float -> int32 conversion the JAX package's kernels use.
//
// Integer sums and scans run on uint32 lanes: two's-complement wrap-around
// is then defined behaviour and gives the same bits as the int32 cumsum and
// sum of the reference (which wrap the same way).
//
// A block-wide reduction in these kernels is: a warp reduction
// (__reduce_*_sync, one REDUX instruction on sm_80+), one slot per warp in
// shared memory, ONE barrier, then every warp reduces the slots again with
// one REDUX. No thread loops over the slots.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ktt {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxWarps = 32;

// float -> int32 as XLA and PTX convert: round toward zero, saturate at the
// int32 range, NaN -> 0 (cvt.rzi.s32.f32).
__device__ __forceinline__ int32_t f2i_sat(float x) { return __float2int_rz(x); }

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }

// Inclusive prefix sum over the warp in lane order (wrap-around).
__device__ __forceinline__ uint32_t warp_incl_scan_u32(uint32_t v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const uint32_t o = __shfl_up_sync(kFullMask, v, off);
        if (lane >= off) v += o;
    }
    return v;
}

// uint32 key whose unsigned order is the float order of the non-NaN values
// (-0 and +0 share the key of +0). NaN takes the lowest key, so a min over
// keys returns NaN first, as torch.argmin and jnp.argmin do.
__device__ __forceinline__ uint32_t fkey_min(float x) {
    if (x != x) return 0u;
    const uint32_t b = __float_as_uint(x == 0.0f ? 0.0f : x);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The same key with NaN highest, so a max over keys propagates NaN as
// torch.amax does.
__device__ __forceinline__ uint32_t fkey_max(float x) { return x != x ? 0xffffffffu : fkey_min(x); }

// The float a key stands for (a NaN key decodes to a NaN).
__device__ __forceinline__ float fkey_value(uint32_t k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

}  // namespace ktt
