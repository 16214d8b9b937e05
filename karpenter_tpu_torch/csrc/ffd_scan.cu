// Kernel A: the fused first-fit-decreasing scan of the provisioning solve.
//
// Replaces the Pallas kernel karpenter_tpu/solver/kernels/ffd_pallas.py
// `_fused_scan` (called through `ffd_solve_fused_pallas`). Same function:
// a sequential scan over the C pod classes whose carry is the set of open
// node groups -- accum [G, R] f32, the bit-packed surviving-type mask
// [G, K/32] u32, the packed zone|captype bitset [G] u32 and n_open. Each
// step (1) joins the class onto every open group (packed AND of survivor
// mask and class compat plus the zone/captype join), (2) counts how many
// pods fit per group, floor((cap - accum) / req) over R, max over the
// surviving types, (3) places pods first-fit by an exclusive prefix sum
// over the groups, (4) sizes fresh groups by the price envelope (argmin of
// the total class cost over K, first index wins) and (5) updates the carry.
// Float operations are the reference's, in its order, rounded the same way:
// IEEE division (never build with --use_fast_math), and -fmad=false so a
// multiply and an add round separately.
//
// What bounds it on an H100: latency. The C steps are sequential and each
// step needs all G groups, so the scan cannot spread over the card's 132
// SMs; the bytes it must move (about 2.4 MB at C=256, G=1024, K=640) take
// under 1 us at 3.35 TB/s. Design: one thread block of 1024 threads runs
// the whole scan on one SM with the carry resident in dynamic shared
// memory (about 160 KB at G=1024, K=640), so the carry never leaves the
// SM. Threads stride over groups; a group's survivor words are walked bit
// by bit (__ffs), so only surviving types cost a division; block scans and
// reductions separate the phases. The known limit is that one SM of 132
// does the work: splitting G across a thread-block cluster is the next
// redesign.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_ops.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kCtShift = 8;  // captype bits sit above the zone bits

__device__ __forceinline__ bool joint_ok(uint32_t x) {
    return (x & ((1u << kCtShift) - 1u)) != 0u && (x >> kCtShift) != 0u;
}

// Pods of `req` that fit in cap - acc, min over the constrained axes,
// clipped at 0 (ffd._fit_counts, one (group, type) entry).
__device__ __forceinline__ float fit_count(const float* cap_k, const float* acc, const float* req, int R) {
    float n = ktt::f_inf();
    for (int r = 0; r < R; ++r) {
        const float q = req[r];
        if (q > 0.0f) n = fminf(n, floorf(__fdiv_rn(__fsub_rn(cap_k[r], acc[r]), q)));
    }
    return fmaxf(n, 0.0f);
}

__device__ __forceinline__ bool bit_of(const uint32_t* words, int k) {
    return (words[k >> 5] >> (k & 31)) & 1u;
}

__global__ void __launch_bounds__(kThreads, 1) ffd_scan_kernel(
    const float* __restrict__ req,        // [C, R]
    const uint32_t* __restrict__ compat_w,  // [C, KW]
    const uint32_t* __restrict__ fresh_w,   // [C, KW]
    const uint32_t* __restrict__ hasres_w,  // [C, KW]
    const float* __restrict__ n_fresh,    // [C, K]
    const float* __restrict__ price,      // [C, K]
    const int32_t* __restrict__ count,    // [C]
    const int32_t* __restrict__ env,      // [C]
    const uint32_t* __restrict__ azc,     // [C]
    const float* __restrict__ cap_eff,    // [K, R]
    const uint32_t* __restrict__ tzc,     // [K]
    int32_t* __restrict__ take_out,       // [C, G]
    int32_t* __restrict__ unplaced_out,   // [C]
    uint32_t* __restrict__ gmask_out,     // [G, KW]
    uint32_t* __restrict__ gzc_out,       // [G]
    int32_t* __restrict__ n_open_out,     // [1]
    int C, int G, int K, int R, int price_objective) {
    const int KW = K >> 5;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    extern __shared__ uint32_t smem[];
    float* accum = reinterpret_cast<float*>(smem);               // [G, R]
    uint32_t* gmask = smem + G * R;                              // [G, KW]
    uint32_t* gzc = gmask + G * KW;                              // [G]
    int32_t* ngrp = reinterpret_cast<int32_t*>(gzc + G);         // [G]
    int32_t* take = ngrp + G;                                    // [G]
    float* cap = reinterpret_cast<float*>(take + G);             // [K, R]
    uint32_t* tz = reinterpret_cast<uint32_t*>(cap + K * R);     // [K]
    float* nf_row = reinterpret_cast<float*>(tz + K);            // [K]
    float* pr_row = nf_row + K;                                  // [K]
    uint32_t* compat_row = reinterpret_cast<uint32_t*>(pr_row + K);  // [KW]
    uint32_t* fresh_row = compat_row + KW;                       // [KW]
    uint32_t* hasres_row = fresh_row + KW;                       // [KW]
    uint32_t* open_row = hasres_row + KW;                        // [KW]
    float* req_row = reinterpret_cast<float*>(open_row + KW);    // [R]
    uint32_t* red_u = reinterpret_cast<uint32_t*>(req_row + R);  // [kWarps]
    float* red_f = reinterpret_cast<float*>(red_u + kWarps);     // [kWarps]
    int32_t* red_i = reinterpret_cast<int32_t*>(red_f + kWarps);  // [kWarps]

    for (int i = tid; i < G * R; i += kThreads) accum[i] = 0.0f;
    for (int i = tid; i < G * KW; i += kThreads) gmask[i] = 0u;
    for (int i = tid; i < G; i += kThreads) gzc[i] = 0u;
    for (int i = tid; i < K * R; i += kThreads) cap[i] = cap_eff[i];
    for (int i = tid; i < K; i += kThreads) tz[i] = tzc[i];
    int32_t n_open = 0;  // identical in every thread

    for (int c = 0; c < C; ++c) {
        // -- stage the class's streamed row --------------------------------
        __syncthreads();
        for (int i = tid; i < KW; i += kThreads) {
            compat_row[i] = compat_w[c * KW + i];
            fresh_row[i] = fresh_w[c * KW + i];
            hasres_row[i] = hasres_w[c * KW + i];
        }
        for (int k = tid; k < K; k += kThreads) {
            nf_row[k] = n_fresh[(size_t)c * K + k];
            pr_row[k] = price[(size_t)c * K + k];
        }
        if (tid < R) req_row[tid] = req[c * R + tid];
        __syncthreads();
        const int32_t count_c = count[c];
        const int32_t env_c = env[c];
        const uint32_t azc_c = azc[c];

        // -- (1)+(2) best fit of the class on each open group ---------------
        for (int g = tid; g < G; g += kThreads) {
            float best = 0.0f;
            if (g < n_open) {
                const uint32_t gz = gzc[g] & azc_c;
                const float* acc = accum + g * R;
                for (int wi = 0; wi < KW; ++wi) {
                    uint32_t w = gmask[g * KW + wi] & compat_row[wi];
                    while (w) {
                        const int k = (wi << 5) + (__ffs(w) - 1);
                        w &= w - 1u;
                        if (!joint_ok(gz & tz[k])) continue;
                        best = fmaxf(best, fit_count(cap + k * R, acc, req_row, R));
                    }
                }
            }
            ngrp[g] = ktt::f2i_sat(best);
        }

        // -- (3) first fit: exclusive prefix sum over the groups ------------
        uint32_t running = 0;
        uint32_t placed = 0;
        for (int base = 0; base < G; base += kThreads) {
            const int g = base + tid;
            const uint32_t v = g < G ? (uint32_t)ngrp[g] : 0u;
            uint32_t chunk;
            const uint32_t incl = ktt::block_incl_scan_u32(v, red_u, &chunk);
            const int32_t before = (int32_t)(running + incl - v);
            int32_t t = (int32_t)((uint32_t)count_c - (uint32_t)before);
            t = max(t, 0);
            t = min(t, (int32_t)v);
            if (g < G) take[g] = t;
            running += chunk;
            placed += ktt::block_sum_u32(g < G ? (uint32_t)t : 0u, red_u);
        }
        const int32_t leftover = (int32_t)((uint32_t)count_c - placed);

        // -- (4) the fresh-group envelope ------------------------------------
        float mf = 0.0f;
        for (int k = tid; k < K; k += kThreads)
            if (bit_of(fresh_row, k)) mf = fmaxf(mf, nf_row[k]);
        const float max_fit_f = ktt::block_max_f32(mf, red_f);
        const int32_t per_new_fit = ktt::f2i_sat(max_fit_f);
        int32_t per_new;
        if (price_objective) {
            const int32_t tail = (int32_t)((uint32_t)leftover + (uint32_t)(-env_c - 1));
            const int32_t env_n = env_c > 0 ? env_c : max(tail, 1);
            const float envf = (float)env_n;
            const float need = fminf(max_fit_f, envf);
            float bv = ktt::f_inf();
            int32_t bi = INT32_MAX;
            for (int k = tid; k < K; k += kThreads) {
                const float nf = nf_row[k];
                const float ngroups = ceilf(__fdiv_rn(envf, fmaxf(nf, 1.0f)));
                const bool eligible = bit_of(fresh_row, k) && nf >= 1.0f &&
                                      (__fmul_rn(2.0f, fminf(nf, envf)) >= need || bit_of(hasres_row, k));
                const float tc = eligible ? __fmul_rn(pr_row[k], ngroups) : ktt::f_inf();
                if (tc < bv || (tc == bv && k < bi)) {
                    bv = tc;
                    bi = k;
                }
            }
            float tc_min;
            int32_t kstar;
            ktt::block_argmin_f32(bv, bi, red_f, red_i, &tc_min, &kstar);
            if (kstar < 0 || kstar >= K) kstar = 0;  // all +inf: argmin is the first index
            const bool ok = isfinite(tc_min);
            const int32_t per_new_price = ok ? ktt::f2i_sat(nf_row[kstar]) : 0;
            const float p_star = pr_row[kstar];
            const float pnp = (float)per_new_price;
            const bool use_fit = env_c == 0;
            per_new = use_fit ? per_new_fit : per_new_price;
            // the open mask as packed words: one ballot per 32 types
            for (int base = warp << 5; base < K; base += kThreads) {
                const int k = base + lane;
                const bool pm = ok && bit_of(fresh_row, k) && nf_row[k] >= pnp && pr_row[k] <= p_star;
                const unsigned word = __ballot_sync(ktt::kFullMask, pm);
                if (lane == 0) open_row[k >> 5] = use_fit ? fresh_row[k >> 5] : word;
            }
        } else {
            per_new = per_new_fit;
            for (int i = tid; i < KW; i += kThreads) open_row[i] = fresh_row[i];
        }
        __syncthreads();

        // -- open fresh identical groups for the remainder -------------------
        int32_t n_new = 0;
        if (leftover > 0 && per_new > 0)
            n_new = (int32_t)(((int64_t)leftover + per_new - 1) / per_new);
        n_new = min(n_new, G - n_open);

        // -- (5) carry update; each thread owns its groups' rows -------------
        uint32_t placed_all = 0;
        for (int base = 0; base < G; base += kThreads) {
            const int g = base + tid;
            int32_t ta = 0;
            if (g < G) {
                const int32_t tk = take[g];
                const bool is_new = g >= n_open && g < n_open + n_new;
                int32_t tn = 0;
                if (is_new) {
                    int64_t rest = (int64_t)leftover - (int64_t)(g - n_open) * per_new;
                    if (rest < 0) rest = 0;
                    if (rest > per_new) rest = per_new;
                    tn = (int32_t)rest;
                }
                ta = tk + tn;
                take_out[(size_t)c * G + g] = ta;
                const float takef = (float)ta;
                if (tk > 0) {
                    // touched open group: keep the surviving types the class
                    // joined on that still hold the new total
                    const uint32_t gz = gzc[g] & azc_c;
                    const float* acc = accum + g * R;
                    for (int wi = 0; wi < KW; ++wi) {
                        uint32_t w = gmask[g * KW + wi] & compat_row[wi];
                        uint32_t keep = 0u;
                        while (w) {
                            const int j = __ffs(w) - 1;
                            w &= w - 1u;
                            const int k = (wi << 5) + j;
                            if (joint_ok(gz & tz[k]) && takef <= fit_count(cap + k * R, acc, req_row, R))
                                keep |= 1u << j;
                        }
                        gmask[g * KW + wi] = keep;
                    }
                    gzc[g] = gz;
                } else if (is_new) {
                    for (int wi = 0; wi < KW; ++wi) {
                        uint32_t w = open_row[wi];
                        uint32_t keep = 0u;
                        while (w) {
                            const int j = __ffs(w) - 1;
                            w &= w - 1u;
                            if (takef <= nf_row[(wi << 5) + j]) keep |= 1u << j;
                        }
                        gmask[g * KW + wi] = keep;
                    }
                    gzc[g] = azc_c;
                }
                if (ta > 0) {
                    float* acc = accum + g * R;
                    for (int r = 0; r < R; ++r) acc[r] = __fadd_rn(acc[r], __fmul_rn(takef, req_row[r]));
                }
            }
            placed_all += ktt::block_sum_u32((uint32_t)ta, red_u);
        }
        if (tid == 0) unplaced_out[c] = (int32_t)((uint32_t)count_c - placed_all);
        n_open += n_new;
    }

    __syncthreads();
    for (int i = tid; i < G * KW; i += kThreads) gmask_out[i] = gmask[i];
    for (int i = tid; i < G; i += kThreads) gzc_out[i] = gzc[i];
    if (tid == 0) n_open_out[0] = n_open;
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for these shapes, in bytes.
size_t ffd_scan_smem_bytes(int G, int K, int R) {
    const size_t KW = (size_t)K / 32;
    return 4 * ((size_t)G * R + (size_t)G * KW + 3 * (size_t)G + (size_t)K * R + 3 * (size_t)K +
                4 * KW + (size_t)R + 3 * (size_t)kWarps);
}

int ffd_scan_launch(const void* req, const void* compat_w, const void* fresh_w, const void* hasres_w,
                    const void* n_fresh, const void* price, const void* count, const void* env,
                    const void* azc, const void* cap_eff, const void* tzc, void* take_out,
                    void* unplaced_out, void* gmask_out, void* gzc_out, void* n_open_out, int C, int G,
                    int K, int R, int price_objective, void* stream) {
    const size_t smem = ffd_scan_smem_bytes(G, K, R);
    cudaError_t err = cudaFuncSetAttribute(ffd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ffd_scan_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)req, (const uint32_t*)compat_w, (const uint32_t*)fresh_w, (const uint32_t*)hasres_w,
        (const float*)n_fresh, (const float*)price, (const int32_t*)count, (const int32_t*)env,
        (const uint32_t*)azc, (const float*)cap_eff, (const uint32_t*)tzc, (int32_t*)take_out,
        (int32_t*)unplaced_out, (uint32_t*)gmask_out, (uint32_t*)gzc_out, (int32_t*)n_open_out, C, G, K, R,
        price_objective);
    return (int)cudaGetLastError();
}

}  // extern "C"
