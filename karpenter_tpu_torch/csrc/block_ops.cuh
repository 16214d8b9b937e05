// Block-wide helpers shared by the solver kernels: reductions, an
// inclusive scan, and the float -> int32 conversion the JAX package's
// kernels use.
//
// Integer sums and scans run on uint32 lanes: two's-complement wrap-around
// is then defined behaviour and gives the same bits as the int32 cumsum and
// sum of the reference (which wrap the same way).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ktt {

constexpr unsigned kFullMask = 0xffffffffu;

// float -> int32 as XLA and PTX convert: round toward zero, saturate at the
// int32 range, NaN -> 0 (cvt.rzi.s32.f32).
__device__ __forceinline__ int32_t f2i_sat(float x) { return __float2int_rz(x); }

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }

// Sum over the block (wrap-around). `red` holds one slot per warp; every
// thread receives the total. Contains __syncthreads: call from all threads.
__device__ __forceinline__ uint32_t block_sum_u32(uint32_t v, uint32_t* red) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = (blockDim.x + 31) >> 5;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    uint32_t t = 0;
    for (int w = 0; w < nwarps; ++w) t += red[w];
    return t;
}

// Max over the block of non-NaN floats. Every thread receives the result.
__device__ __forceinline__ float block_max_f32(float v, float* red) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = (blockDim.x + 31) >> 5;
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float t = red[0];
    for (int w = 1; w < nwarps; ++w) t = fmaxf(t, red[w]);
    return t;
}

// (min value, first index holding it) over the block: ties go to the lower
// index, as jnp.argmin and torch.argmin pick the first minimum. Threads
// with nothing to offer pass (+inf, INT32_MAX).
__device__ __forceinline__ void block_argmin_f32(float v, int32_t i, float* redv, int32_t* redi,
                                                 float* out_v, int32_t* out_i) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = (blockDim.x + 31) >> 5;
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFullMask, v, off);
        const int32_t oi = __shfl_xor_sync(kFullMask, i, off);
        if (ov < v || (ov == v && oi < i)) {
            v = ov;
            i = oi;
        }
    }
    __syncthreads();
    if (lane == 0) {
        redv[warp] = v;
        redi[warp] = i;
    }
    __syncthreads();
    float bv = redv[0];
    int32_t bi = redi[0];
    for (int w = 1; w < nwarps; ++w) {
        if (redv[w] < bv || (redv[w] == bv && redi[w] < bi)) {
            bv = redv[w];
            bi = redi[w];
        }
    }
    *out_v = bv;
    *out_i = bi;
}

// Inclusive prefix sum over the block in thread order (wrap-around); the
// block total comes back through *total. `red` holds one slot per warp.
__device__ __forceinline__ uint32_t block_incl_scan_u32(uint32_t v, uint32_t* red, uint32_t* total) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = (blockDim.x + 31) >> 5;
    for (int off = 1; off < 32; off <<= 1) {
        const uint32_t o = __shfl_up_sync(kFullMask, v, off);
        if (lane >= off) v += o;
    }
    __syncthreads();
    if (lane == 31) red[warp] = v;
    __syncthreads();
    uint32_t before = 0;
    uint32_t t = 0;
    for (int w = 0; w < nwarps; ++w) {
        if (w < warp) before += red[w];
        t += red[w];
    }
    *total = t;
    return v + before;
}

}  // namespace ktt
