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
// What bounds it on an H100: the latency of each class step, as for the
// FFD scan. With S=1 the C class steps are sequential over all N nodes;
// the bytes it must move (mostly the [S, C, N] takes, about 0.5 MB at
// C=128, N=1024) take well under 1 us at 3.35 TB/s. Design: one thread
// block per candidate set, so consolidation's S in the hundreds fills the
// SMs; thread t owns a contiguous run of nodes, whose headroom rows stay
// in shared memory for the whole launch. A chunk of classes is staged at
// once -- feasibility as bits, requests, members -- so a class step loads
// nothing from device memory, and a class whose feasibility row is empty
// (a no-op: leftover = member, zero takes) costs no step. A step has ONE
// barrier: the prefix sum's, with its per-warp slots double-buffered by
// step parity, which also ORs a wrap-around flag; the placed count is
// min(member, total) unless a fit could make the int32 prefix sum wrap (or
// member < 0), when it is summed exactly behind two more barriers.
// When N is too large for the headroom to sit in shared memory, it lives
// in a [S, N, R + 1] scratch the wrapper allocates, feasibility is read
// from device memory and every class takes a step.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_ops.cuh"

namespace {

using ktt::kFullMask;
using ktt::kMaxWarps;

constexpr int kMaxR = 32;
constexpr int kMaxThreads = 1024;

__host__ __device__ __forceinline__ int nwords(int N) { return (N + 31) >> 5; }

// Dynamic shared memory in 32-bit words for a chunk of `chunk` classes.
__host__ __device__ __forceinline__ size_t smem_words(int N, int R, int chunk, int resident) {
    const size_t per_class = (resident ? (size_t)nwords(N) : 0) + R + 1;  // feas bits, req, member
    return (resident ? (size_t)N * (R + 1) : 0) + (size_t)chunk * per_class + (((size_t)chunk + 31) >> 5) +
           3 * kMaxWarps;
}

// One bit per byte of x: bit j is set when byte j is non-zero.
__device__ __forceinline__ uint32_t nz_bits4(uint32_t x) {
    const uint32_t t = __vcmpne4(x, 0u) & 0x08040201u;
    return (t | (t >> 8) | (t >> 16) | (t >> 24)) & 0xfu;
}

// RT > 0 fixes R at compile time (the request axes of the repo's encoding),
// so a node's fit unrolls; RT = 0 takes R at run time.
template <int RT>
__global__ void __launch_bounds__(kMaxThreads) disrupt_repack_kernel(
    const float* __restrict__ headroom0,  // [N, R]
    const float* __restrict__ req,        // [C, R]
    const uint8_t* __restrict__ feas,     // [C, N]
    const int32_t* __restrict__ member,   // [S, C]
    const uint8_t* __restrict__ excl,     // [S, N]
    int32_t* __restrict__ leftover,       // [S, C]
    int32_t* __restrict__ takes,          // [S, C, N]
    float* __restrict__ scratch,          // [S, N, R + 1] when not resident
    int C, int N, int r_arg, int chunk, int resident, int vec16) {
    const int R = RT > 0 ? RT : r_arg;
    const int s = blockIdx.x;
    const int T = blockDim.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = T >> 5;
    const int NW = nwords(N);

    extern __shared__ __align__(16) uint32_t smem[];
    float* hr;        // [N, R] headroom
    int32_t* fit;     // [N] this step's fits, then takes
    uint32_t* fbits;  // [chunk, NW] feasibility bits (resident)
    if (resident) {
        hr = reinterpret_cast<float*>(smem);
        fit = reinterpret_cast<int32_t*>(hr + N * R);
        fbits = reinterpret_cast<uint32_t*>(fit + N);
    } else {
        hr = scratch + (size_t)s * N * (R + 1);
        fit = reinterpret_cast<int32_t*>(hr + N * R);
        fbits = smem;
    }
    float* rq = reinterpret_cast<float*>(fbits + (resident ? chunk * NW : 0));  // [chunk, R]
    int32_t* mem = reinterpret_cast<int32_t*>(rq + chunk * R);                 // [chunk]
    uint32_t* bitmap = reinterpret_cast<uint32_t*>(mem + chunk);               // [ceil(chunk / 32)]
    uint32_t* s_scan = bitmap + ((chunk + 31) >> 5);                           // [2, 32] by step parity
    uint32_t* s_sum = s_scan + 2 * kMaxWarps;                                  // [32]

    // thread t owns nodes [n0, n1)
    const int npt = (N + T - 1) / T;
    const int n0 = min(tid * npt, N);
    const int n1 = min(n0 + npt, N);
    for (int n = n0; n < n1; ++n) {
        const bool ex = excl[(size_t)s * N + n] != 0;
        for (int r = 0; r < R; ++r) hr[n * R + r] = ex ? 0.0f : headroom0[n * R + r];
    }
    // bits of the last feasibility word that stand for nodes
    const uint32_t last_mask = (N & 31) ? (1u << (N & 31)) - 1u : kFullMask;
    // a fit above vmax could make the prefix sum over N nodes wrap
    const uint32_t vmax = 0x7fffffffu / (uint32_t)N;
    int parity = 0;

    for (int base = 0; base < C; base += chunk) {
        const int nc = min(chunk, C - base);
        __syncthreads();  // the previous chunk's readers are done
        // -- stage the chunk ---------------------------------------------------
        for (int i = tid; i < nc * R; i += T) rq[i] = req[(size_t)base * R + i];
        for (int i = tid; i < nc; i += T) mem[i] = member[(size_t)s * C + base + i];
        for (int i = tid; i < ((nc + 31) >> 5); i += T) bitmap[i] = resident ? 0u : kFullMask;
        if (resident && vec16) {
            // 16 feasibility bytes a thread (one 16-node half of a bit word)
            const uint4* src = reinterpret_cast<const uint4*>(feas + (size_t)base * N);
            uint16_t* half = reinterpret_cast<uint16_t*>(fbits);
            const int per_row = N >> 4;
#pragma unroll 4
            for (int i = tid; i < nc * per_row; i += T) {
                const uint4 x = src[i];
                const uint32_t b = nz_bits4(x.x) | (nz_bits4(x.y) << 4) | (nz_bits4(x.z) << 8) | (nz_bits4(x.w) << 12);
                const int cl = i / per_row;
                half[cl * NW * 2 + (i - cl * per_row)] = (uint16_t)b;
            }
        } else if (resident) {
            // one warp ballot per 32 nodes of a class row
            for (int w = warp; w < nc * NW; w += nwarps) {
                const int cl = w / NW;
                const int n = (w - cl * NW) * 32 + lane;
                const uint32_t b = __ballot_sync(kFullMask, n < N && feas[(size_t)(base + cl) * N + n] != 0);
                if (lane == 0) fbits[w] = b;
            }
        }
        if (resident) {
            __syncthreads();
            for (int cl = tid; cl < nc; cl += T) {
                uint32_t any = 0u;
                for (int w = 0; w < NW; ++w) any |= fbits[cl * NW + w] & (w == NW - 1 ? last_mask : kFullMask);
                if (any) atomicOr(&bitmap[cl >> 5], 1u << (cl & 31));
            }
        }
        __syncthreads();
        // no-op classes: leftover = member, a zero take row each
        for (int cl = tid; cl < nc; cl += T)
            if (!((bitmap[cl >> 5] >> (cl & 31)) & 1u)) leftover[(size_t)s * C + base + cl] = mem[cl];
        for (int wd = 0; wd < ((nc + 31) >> 5); ++wd) {
            uint32_t idle = ~bitmap[wd];
            while (idle) {
                const int cl = (wd << 5) + __ffs(idle) - 1;
                idle &= idle - 1u;
                if (cl >= nc) break;
                int32_t* row = takes + ((size_t)s * C + base + cl) * N;
                for (int n = tid; n < N; n += T) row[n] = 0;
            }
        }

        // -- the real classes, one barrier each --------------------------------
        for (int wd = 0; wd < ((nc + 31) >> 5); ++wd) {
            uint32_t todo = bitmap[wd];
            while (todo) {
                const int cl = (wd << 5) + __ffs(todo) - 1;
                todo &= todo - 1u;
                if (cl >= nc) break;
                const int c = base + cl;
                const float* q = rq + cl * R;
                const int32_t count_c = mem[cl];
                uint32_t tv = 0u;
                bool risk = false;
                for (int n = n0; n < n1; ++n) {
                    const bool ok = resident ? ((fbits[cl * NW + (n >> 5)] >> (n & 31)) & 1u)
                                             : feas[(size_t)c * N + n] != 0;
                    int32_t f = 0;
                    if (ok) {
                        float x = ktt::f_inf();
#pragma unroll
                        for (int r = 0; r < R; ++r)
                            if (q[r] > 0.0f) x = fminf(x, floorf(__fdiv_rn(hr[n * R + r], q[r])));
                        f = ktt::f2i_sat(fmaxf(x, 0.0f));
                    }
                    fit[n] = f;
                    tv += (uint32_t)f;
                    risk |= (uint32_t)f > vmax;
                }
                const uint32_t incl = ktt::warp_incl_scan_u32(tv);
                uint32_t* slots = s_scan + parity * kMaxWarps;
                parity ^= 1;
                // a warp whose fits could wrap the prefix sum says so with an
                // all-ones slot (no true warp total comes near it)
                const bool warp_risk = __any_sync(kFullMask, risk);
                if (lane == 31) slots[warp] = warp_risk ? kFullMask : incl;
                __syncthreads();  // the step's barrier
                uint32_t sv = lane < nwarps ? slots[lane] : 0u;
                risk = __any_sync(kFullMask, sv == kFullMask);
                if (risk) {
                    // the exact wrapped warp totals instead
                    __syncthreads();  // every warp has read the slots
                    if (lane == 31) slots[warp] = incl;
                    __syncthreads();
                    sv = lane < nwarps ? slots[lane] : 0u;
                }
                const uint32_t total = __reduce_add_sync(kFullMask, sv);
                uint32_t before = __reduce_add_sync(kFullMask, lane < warp ? sv : 0u) + incl - tv;
                int32_t* trow = takes + ((size_t)s * C + c) * N;
                uint32_t tsum = 0u;
                for (int n = n0; n < n1; ++n) {
                    const int32_t v = fit[n];
                    int32_t t = (int32_t)((uint32_t)count_c - before);
                    t = min(max(t, 0), v);
                    before += (uint32_t)v;
                    tsum += (uint32_t)t;
                    trow[n] = t;
                    if (t > 0) {
                        const float tf = (float)t;
                        for (int r = 0; r < R; ++r) hr[n * R + r] = __fsub_rn(hr[n * R + r], __fmul_rn(tf, q[r]));
                    }
                }
                uint32_t placed;
                if (!risk && count_c >= 0) {
                    placed = min((uint32_t)count_c, total);  // no prefix wraps
                } else {
                    tsum = __reduce_add_sync(kFullMask, tsum);
                    __syncthreads();  // an earlier wrapping step's readers are done
                    if (lane == 0) s_sum[warp] = tsum;
                    __syncthreads();
                    placed = __reduce_add_sync(kFullMask, lane < nwarps ? s_sum[lane] : 0u);
                }
                if (tid == 0) leftover[(size_t)s * C + c] = (int32_t)((uint32_t)count_c - placed);
            }
        }
    }
}

}  // namespace

extern "C" {

int disrupt_repack_max_r() { return kMaxR; }

// Dynamic shared memory of one launch, in bytes (resident: headroom and
// feasibility bits in shared memory).
size_t disrupt_repack_smem_bytes(int N, int R, int chunk, int resident) {
    return 4 * smem_words(N, R, chunk, resident);
}

int disrupt_repack_launch(const void* headroom0, const void* req, const void* feas, const void* member,
                          const void* excl, void* leftover, void* takes, void* scratch, int S, int C, int N,
                          int R, int threads, int chunk, int resident, void* stream) {
    if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 || chunk < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = disrupt_repack_smem_bytes(N, R, chunk, resident);
    auto kernel = R == 9 ? disrupt_repack_kernel<9> : disrupt_repack_kernel<0>;
    // raise the kernel's shared-memory ceiling once per size seen (the call
    // costs host time on every launch otherwise)
    static size_t ceiling[2] = {0, 0};
    size_t& have = ceiling[kernel == disrupt_repack_kernel<9> ? 0 : 1];
    if (smem > have) {
        const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        have = smem;
    }
    // feasibility rows load 16 bytes at a time when each row is whole 16-byte pieces
    const int vec16 = N % 16 == 0 && ((uintptr_t)feas & 15u) == 0;
    kernel<<<S, threads, smem, (cudaStream_t)stream>>>(
        (const float*)headroom0, (const float*)req, (const uint8_t*)feas, (const int32_t*)member,
        (const uint8_t*)excl, (int32_t*)leftover, (int32_t*)takes, (float*)scratch, C, N, R, chunk, resident,
        vec16);
    return (int)cudaGetLastError();
}

}  // extern "C"
