// Kernel B: the candidate-set repack ([S, C, N] first fit onto live nodes).
//
// Replaces the Pallas kernel karpenter_tpu/solver/kernels/disrupt_pallas.py
// `disrupt_repack_pallas`. Same function: for each candidate set s, zero
// the headroom of the nodes the set deletes; then, over the pod classes in
// order, fit[n] = min over R of floor(hr / req) where req > 0 (else +inf),
// clipped at 0 and zeroed where the class may not land on the node; an
// exclusive prefix sum across nodes places the class first-fit, clipped to
// its count; hr -= take * req. The provisioning solve sends it S=1 to pack
// pending pods onto existing nodes before it opens new ones.
// Float operations are the reference's, in its order: IEEE division, and
// -fmad=false so hr - take * req rounds the multiply and the subtract apart.
//
// What bounds it on an H100: latency, as for the FFD scan. With S=1 the C
// class steps are sequential over all N nodes; the bytes it must move
// (mostly the [S, C, N] takes, about 1 MB at C=256, N=1024) take well
// under 1 us at 3.35 TB/s. Design: one thread block per candidate set, so
// consolidation's S in the hundreds fills the SMs; threads stride over
// nodes and each owns its nodes' headroom rows in a per-set slice of a
// [S, N, R] scratch the wrapper allocates (L1-resident at these sizes);
// block scans with a running offset give the first fit across nodes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_ops.cuh"

namespace {

constexpr int kMaxR = 32;

__global__ void disrupt_repack_kernel(
    const float* __restrict__ headroom0,  // [N, R]
    const float* __restrict__ req,        // [C, R]
    const uint8_t* __restrict__ feas,     // [C, N]
    const int32_t* __restrict__ member,   // [S, C]
    const uint8_t* __restrict__ excl,     // [S, N]
    int32_t* __restrict__ leftover,       // [S, C]
    int32_t* __restrict__ takes,          // [S, C, N]
    float* __restrict__ scratch,          // [S, N, R]
    int C, int N, int R) {
    __shared__ float req_row[kMaxR];
    __shared__ uint32_t red[32];
    const int s = blockIdx.x;
    const int tid = threadIdx.x;
    const int T = blockDim.x;
    float* hr = scratch + (size_t)s * N * R;

    for (int n = tid; n < N; n += T) {
        const bool ex = excl[(size_t)s * N + n] != 0;
        for (int r = 0; r < R; ++r) hr[n * R + r] = ex ? 0.0f : headroom0[n * R + r];
    }

    for (int c = 0; c < C; ++c) {
        __syncthreads();
        if (tid < R) req_row[tid] = req[c * R + tid];
        __syncthreads();
        const int32_t count_c = member[(size_t)s * C + c];
        uint32_t running = 0;
        uint32_t placed = 0;
        for (int base = 0; base < N; base += T) {
            const int n = base + tid;
            int32_t fit = 0;
            if (n < N && feas[(size_t)c * N + n]) {
                float f = ktt::f_inf();
                for (int r = 0; r < R; ++r) {
                    const float q = req_row[r];
                    if (q > 0.0f) f = fminf(f, floorf(__fdiv_rn(hr[n * R + r], q)));
                }
                fit = ktt::f2i_sat(fmaxf(f, 0.0f));
            }
            uint32_t chunk;
            const uint32_t incl = ktt::block_incl_scan_u32((uint32_t)fit, red, &chunk);
            const int32_t before = (int32_t)(running + incl - (uint32_t)fit);
            int32_t t = (int32_t)((uint32_t)count_c - (uint32_t)before);
            t = max(t, 0);
            t = min(t, fit);
            if (n < N) {
                takes[((size_t)s * C + c) * N + n] = t;
                if (t > 0) {
                    const float tf = (float)t;
                    for (int r = 0; r < R; ++r)
                        hr[n * R + r] = __fsub_rn(hr[n * R + r], __fmul_rn(tf, req_row[r]));
                }
            }
            running += chunk;
            placed += ktt::block_sum_u32((uint32_t)t, red);
        }
        if (tid == 0) leftover[(size_t)s * C + c] = (int32_t)((uint32_t)count_c - placed);
    }
}

}  // namespace

extern "C" {

int disrupt_repack_max_r() { return kMaxR; }

int disrupt_repack_launch(const void* headroom0, const void* req, const void* feas, const void* member,
                          const void* excl, void* leftover, void* takes, void* scratch, int S, int C, int N,
                          int R, int threads, void* stream) {
    disrupt_repack_kernel<<<S, threads, 0, (cudaStream_t)stream>>>(
        (const float*)headroom0, (const float*)req, (const uint8_t*)feas, (const int32_t*)member,
        (const uint8_t*)excl, (int32_t*)leftover, (int32_t*)takes, (float*)scratch, C, N, R);
    return (int)cudaGetLastError();
}

}  // extern "C"
