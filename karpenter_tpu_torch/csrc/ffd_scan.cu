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
// the total class cost over K, first index wins, NaN first) and (5)
// updates the carry. Float operations are the reference's, in its order,
// rounded the same way: IEEE division (never build with --use_fast_math),
// and -fmad=false so a multiply and an add round separately.
//
// What bounds it on an H100: the latency of each class step. The C steps
// are sequential and the bytes a step must move take under 1 us at 3.35
// TB/s. A narrow step -- every open group holding at most kNarrowTypes
// surviving types, as on the main path's price ticks (1 or 2) -- makes a
// few hundred fit evaluations; it waits on barriers and on the longest
// walk of one thread over its groups. So the design cuts what a step
// waits on:
//   - one thread block runs the whole scan with the carry resident in
//     dynamic shared memory; thread t owns a contiguous run of groups for
//     the whole launch, so a narrow step's carry update needs no barrier;
//   - a class whose compat and fresh rows are both empty is a no-op (no
//     open group can take it and no fresh group can open), found for a
//     chunk of classes at once; such a class only writes its zero take row
//     and unplaced = count, and costs no step;
//   - each group keeps a bitmap of its non-zero survivor words, so a step
//     walks those words only;
//   - the next real class's row (n_fresh, price, the three mask rows, req,
//     count, env, azc) is copied into a second shared buffer with cp.async
//     while the current step runs;
//   - two barriers a step: the prefix sum's (which also carries the
//     fresh-fit max and a wrap-around flag) and the envelope argmin's, and
//     a third in a step that opens groups, after the new groups' masks are
//     built once as words by warp ballots (every new group but the last
//     takes per_new pods, so two masks serve them all). Each reduction is
//     a warp REDUX, a slot per warp, one barrier, and a REDUX over the
//     slots. The placed count is min(count, total) unless a group count
//     could make the int32 prefix sum wrap (or count < 0); then the warp
//     totals and the takes are summed exactly, behind more barriers;
//   - R = 9 (the repo's request axes) is a template case, so a fit's
//     axes unroll with the request in registers.
// A wide step is one with a group of more than kNarrowTypes surviving
// types: a zone-spread sub-class (env_count 0) or the fit objective opens
// each group with every compatible type (up to ~570 joined on the spread
// worlds). Walked by its owning thread, such a group made the step last
// hundreds of serial fits, twice -- once for the max in (2) and again for
// the keep test in (5) -- while 1,023 threads waited at the prefix sum.
// A wide step instead:
//   - classifies the open groups (W0, a barrier): each owner counts its
//     groups' survivors and sets their bits in a [G/32] wide-group bitmap
//     (device memory, beside the fits);
//   - deals the wide groups' non-zero survivor words, as (group, word)
//     items in group order, round-robin over the 32 warps (each warp
//     places the items with a scan over 32 groups at a time, so a world of
//     many wide groups costs a warp n/32 group visits, not n); a lane
//     takes one type of the word, so a word's fits run at once; a group's
//     max is a REDUX over order-preserving keys and a shared atomicMax
//     (exact: a fit is never NaN, and a max of non-NaN floats has no
//     order); each fit goes to a [G, K] f32 scratch the wrapper allocates
//     (2.6 MB at K = 640, in L2), written once in (2) -- -1 where the
//     zone/captype join fails, which no take keeps;
//   - meets again (W1) so the owners add their wide groups' counts to the
//     prefix sum, which runs as before;
//   - in (5), the same warps read the stored fits of a touched wide group
//     back, word by word, and build each kept word with one ballot; the
//     owners update accum, gzc and the take rows as before;
//   - meets a third time (W2) and each warp rebuilds the non-zero-word
//     bitmaps of its own lanes' touched wide groups with ballots.
// What bounds a wide step then is no longer one group: it is the narrow
// owners' walks (at most kNarrowTypes fits, twice for a touched group),
// a warp's few items with an L2 round trip each in (5), and the three
// barriers -- 8 to 13 us a step on the wide worlds against ~4.3 on a
// narrow one (PERF.md). A lower kNarrowTypes moves fits from the owners
// to the warps but multiplies the items (8 was slower on the fit tick).
// Narrow groups stay with their owners in every step; an owner re-walks
// the at most kNarrowTypes fits of a touched narrow group in (5), which
// costs less than fetching them back from L2 one by one. Whether a step
// is wide is known to every thread without a barrier: wide groups only
// shrink, so a step is wide only if the last one found a wide group, or
// opened a group whose mask (counted by the ballots that build it) is
// wide. A step with no wide group runs the narrow path with no extra
// barrier.
// When the resident layout does not fit in shared memory, a lean layout
// (one row buffer, no prefetch, cap_eff/tzc read through L1) takes any
// shape the first version of this kernel took. When neither fits (a
// merged catalog over three full pools: K = 1920 at G = 1024), the scratch
// layout keeps the survivor words in device memory: each group's words
// [G, KW] live in the gmask output itself and their non-zero bitmaps
// [G, NZW] in a scratch buffer the wrapper allocates, about 0.25 MB at
// that shape, well inside the 50 MB L2. A narrow group's words are touched
// only by its owner; a wide group's by the warps of W0..W2, behind those
// barriers. accum, gzc and the fits (R + 2 words a group) stay in shared
// memory, beside the lean layout's one row buffer. It is a template case,
// so the other layouts keep their survivor words in shared memory with
// shared-memory loads.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_ops.cuh"

namespace {

using ktt::kFullMask;
using ktt::kMaxWarps;

constexpr int kMaxThreads = 1024;
constexpr int kCtShift = 8;  // captype bits sit above the zone bits
// a group of more surviving types than this is wide: its words are dealt
// over the warps instead of walked by its owner
constexpr int kNarrowTypes = 16;

struct Operands {
    const float* req;         // [C, R]
    const uint32_t* compat;   // [C, KW]
    const uint32_t* fresh;    // [C, KW]
    const uint32_t* hasres;   // [C, KW]
    const float* n_fresh;     // [C, K]
    const float* price;       // [C, K]
    const int32_t* count;     // [C]
    const int32_t* env;       // [C]
    const uint32_t* azc;      // [C]
    const float* cap_eff;     // [K, R]
    const uint32_t* tzc;      // [K]
    int32_t* take;            // [C, G]
    int32_t* unplaced;        // [C]
    uint32_t* gmask_out;      // [G, KW]
    uint32_t* gzc_out;        // [G]
    int32_t* n_open_out;      // [1]
    uint32_t* gnz_scratch;    // [G, NZW] survivor-word bitmaps (scratch layout)
    uint32_t* wide_scratch;   // [G, K] f32 a step's fits of the wide groups' survivors,
                              // then [ceil(G / 32)] u32 the bitmap of the wide groups
};

// The three layouts, as the wrapper names them.
constexpr int kLean = 0;
constexpr int kResident = 1;
constexpr int kScratch = 2;

// Words of one staged class row: n_fresh [K], price [K] (16-byte aligned,
// copied 16 bytes at a time), compat/fresh/hasres [KW], req [R], count,
// env, azc; padded to 16 bytes so a second buffer stays aligned.
__host__ __device__ __forceinline__ int row_words(int K, int R) {
    return (2 * K + 3 * (K >> 5) + R + 3 + 3) & ~3;
}

__host__ __device__ __forceinline__ size_t smem_words(int G, int K, int R, int threads, int layout) {
    const size_t KW = (size_t)K >> 5;
    const size_t NZW = (KW + 31) >> 5;
    const bool resident = layout == kResident;
    const size_t nbuf = resident ? 2 : 1;
    const size_t bitmap = resident ? (size_t)threads >> 5 : 1;
    const size_t per_group = (size_t)R + 2 + (layout == kScratch ? 0 : KW + NZW);
    return nbuf * row_words(K, R) + (size_t)G * per_group + (resident ? (size_t)K * R + K : 0) + bitmap +
           4 * kMaxWarps + 2 + 2 * KW + 2 * NZW;
}

__device__ __forceinline__ bool joint_ok(uint32_t x) {
    return (x & ((1u << kCtShift) - 1u)) != 0u && (x >> kCtShift) != 0u;
}

// Pods of the class that fit in cap - acc, min over the constrained axes,
// clipped at 0 (ffd._fit_counts, one (group, type) entry). With RT > 0 the
// request sits in registers (q) and the axes unroll; else it is read from
// the staged row (req) for R axes.
template <int RT>
__device__ __forceinline__ float fit_count(const float* cap_k, const float* acc, const float (&q)[RT > 0 ? RT : 1],
                                           const float* req, int R) {
    float n = ktt::f_inf();
    if constexpr (RT > 0) {
#pragma unroll
        for (int r = 0; r < RT; ++r)
            if (q[r] > 0.0f) n = fminf(n, floorf(__fdiv_rn(__fsub_rn(cap_k[r], acc[r]), q[r])));
    } else {
        for (int r = 0; r < R; ++r) {
            const float qr = req[r];
            if (qr > 0.0f) n = fminf(n, floorf(__fdiv_rn(__fsub_rn(cap_k[r], acc[r]), qr)));
        }
    }
    return fmaxf(n, 0.0f);
}

__device__ __forceinline__ bool bit_of(const uint32_t* words, int k) {
    return (words[k >> 5] >> (k & 31)) & 1u;
}

// Start copying class c's row into `dst`: 16-byte cp.async for the
// n_fresh and price rows, 4 bytes for the rest, issued from the top threads
// (the warps with no types to scan); completed with __pipeline_wait_prior.
__device__ __forceinline__ void load_row(float* dst, int c, const Operands& o, int K, int R) {
    const int KW = K >> 5;
    const int T = blockDim.x;
    const int me = T - 1 - (int)threadIdx.x;
    const int quads = K >> 2;
    const float* nf = o.n_fresh + (size_t)c * K;
    const float* pr = o.price + (size_t)c * K;
    for (int i = me; i < 2 * quads; i += T) {
        const bool second = i >= quads;
        const int j = (second ? i - quads : i) << 2;
        __pipeline_memcpy_async(dst + (second ? K : 0) + j, (second ? pr : nf) + j, 16);
    }
    uint32_t* w = reinterpret_cast<uint32_t*>(dst + 2 * K);
    const int nw = 3 * KW + R + 3;
    for (int i = me; i < nw; i += T) {
        const void* src;
        if (i < KW) src = o.compat + (size_t)c * KW + i;
        else if (i < 2 * KW) src = o.fresh + (size_t)c * KW + (i - KW);
        else if (i < 3 * KW) src = o.hasres + (size_t)c * KW + (i - 2 * KW);
        else if (i < 3 * KW + R) src = o.req + (size_t)c * R + (i - 3 * KW);
        else if (i == 3 * KW + R) src = o.count + c;
        else if (i == 3 * KW + R + 1) src = o.env + c;
        else src = o.azc + c;
        __pipeline_memcpy_async(w + i, src, 4);
    }
    __pipeline_commit();
}

// Position of the n-th (from 0) set bit of x, which has more than n.
__device__ __forceinline__ int nth_bit(uint32_t x, int n) {
    int pos = 0;
#pragma unroll
    for (int width = 16; width > 0; width >>= 1) {
        const int low = __popc(x & ((1u << width) - 1u));
        if (n >= low) {
            n -= low;
            x >>= width;
            pos += width;
        }
    }
    return pos;
}

// Calls f(g, wi) on this warp's share of the wide groups' (group, non-zero
// survivor word) items: every item in group order, then word order, dealt
// round-robin over the warps, so each warp gets the same items in (2) and
// in (5). The warp walks the wide groups 32 at a time, a group a lane: each
// lane counts its group's items, a warp scan places them, and the warp
// visits only the groups that hold one of its items. Every lane calls f
// with the same item (f may use warp collectives). Reads the wide bitmap
// and the groups' non-zero-word bitmaps, which nothing writes between W0
// and W2.
template <typename F>
__device__ __forceinline__ void for_wide_items(const uint32_t* wide_bits, int GW, const uint32_t* gnz, int NZW,
                                               int warp, int nwarps, F&& f) {
    const int lane = threadIdx.x & 31;
    int dealt = 0;  // items of the groups walked so far (the same in every lane)
    for (int j0 = 0; j0 < GW; j0 += 32) {
        const uint32_t bits = j0 + lane < GW ? wide_bits[j0 + lane] : 0u;
        uint32_t words = __ballot_sync(kFullMask, bits != 0u);
        while (words) {
            const int src = __ffs(words) - 1;
            words &= words - 1u;
            const uint32_t wb = __shfl_sync(kFullMask, bits, src);
            // lane l takes the l-th wide group of this bitmap word
            const bool mine = lane < __popc(wb);
            const int g = mine ? ((j0 + src) << 5) + nth_bit(wb, lane) : 0;
            int n = 0;  // its items
            if (mine)
                for (int z = 0; z < NZW; ++z) n += __popc(gnz[(size_t)g * NZW + z]);
            const int incl = (int)ktt::warp_incl_scan_u32((uint32_t)n);
            const int first = dealt + incl - n;  // the group's first item
            const int t0 = ((warp - first) % nwarps + nwarps) % nwarps;  // this warp's first of them
            uint32_t todo = __ballot_sync(kFullMask, t0 < n);
            while (todo) {
                const int s = __ffs(todo) - 1;
                todo &= todo - 1u;
                const int gg = __shfl_sync(kFullMask, g, s);
                const int nn = __shfl_sync(kFullMask, n, s);
                for (int t = __shfl_sync(kFullMask, t0, s); t < nn; t += nwarps) {
                    // the t-th non-zero word of group gg
                    int rest = t, z = 0;
                    uint32_t nzw = gnz[(size_t)gg * NZW];
                    while (rest >= __popc(nzw)) {
                        rest -= __popc(nzw);
                        nzw = gnz[(size_t)gg * NZW + ++z];
                    }
                    f(gg, (z << 5) + nth_bit(nzw, rest));
                }
            }
            dealt += __shfl_sync(kFullMask, incl, 31);
        }
    }
}

// First class after `after` whose bit is set in the chunk bitmap, or cend.
__device__ __forceinline__ int next_real(const uint32_t* bitmap, int nbits, int base, int after, int cend) {
    for (int j = after - base + 1; j < nbits; j = (j | 31) + 1) {
        const uint32_t w = bitmap[j >> 5] & (kFullMask << (j & 31));
        if (w) return min(base + (j & ~31) + __ffs(w) - 1, cend);
    }
    return cend;
}

// RT > 0 fixes R at compile time (the request axes of the repo's encoding),
// so each fit's loads and divides unroll and issue together; RT = 0 takes R
// at run time. SCRATCH keeps the survivor words and their bitmaps in
// device memory (then `resident` is 0).
template <int RT, bool SCRATCH>
__global__ void __launch_bounds__(kMaxThreads, 1)
    ffd_scan_kernel(Operands o, int C, int G, int K, int r_arg, int price_objective, int resident) {
    const int R = RT > 0 ? RT : r_arg;
    const int KW = K >> 5;
    const int NZW = (KW + 31) >> 5;
    const int T = blockDim.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = T >> 5;
    const int ROW = row_words(K, R);
    const int nbits = resident ? T : 32;  // classes per chunk
    const int GW = (G + 31) >> 5;         // words of the wide-group bitmap

    extern __shared__ __align__(16) uint32_t smem[];
    float* rows = reinterpret_cast<float*>(smem);                  // [nbuf, ROW]
    float* cap_s = rows + (resident ? 2 : 1) * ROW;                // [K, R] (resident)
    uint32_t* tz_s = reinterpret_cast<uint32_t*>(cap_s + (resident ? K * R : 0));  // [K] (resident)
    float* accum = reinterpret_cast<float*>(tz_s + (resident ? K : 0));  // [G, R]
    uint32_t* after_accum = reinterpret_cast<uint32_t*>(accum + G * R);
    uint32_t* gmask = SCRATCH ? o.gmask_out : after_accum;         // [G, KW]
    uint32_t* gnz = SCRATCH ? o.gnz_scratch : gmask + G * KW;      // [G, NZW] non-zero survivor words
    uint32_t* gzc = SCRATCH ? after_accum : gnz + G * NZW;         // [G]
    int32_t* ngrp = reinterpret_cast<int32_t*>(gzc + G);           // [G] fits, then takes
    uint32_t* bitmap = reinterpret_cast<uint32_t*>(ngrp + G);      // [nbits / 32] real classes
    uint32_t* s_scan = bitmap + (nbits >> 5);                      // [32] per-warp slots
    uint32_t* s_mfit = s_scan + kMaxWarps;
    uint32_t* s_hi = s_mfit + kMaxWarps;
    uint32_t* s_idx = s_hi + kMaxWarps;
    uint32_t* s_open_types = s_idx + kMaxWarps;                    // [2] types of the two new masks
    uint32_t* open_full = s_open_types + 2;                        // [KW] a full new group's mask
    uint32_t* open_last = open_full + KW;                          // [KW] the last new group's mask
    uint32_t* open_nz_full = open_last + KW;                       // [NZW] their non-zero words
    uint32_t* open_nz_last = open_nz_full + NZW;                   // [NZW]
    const float* cap = resident ? cap_s : o.cap_eff;
    const uint32_t* tz = resident ? tz_s : o.tzc;
    // device memory (L2): a wide step's fits [G, K] and its wide groups [GW]
    float* fits = reinterpret_cast<float*>(o.wide_scratch);
    uint32_t* wide_bits = o.wide_scratch + (size_t)G * K;

    // thread t owns groups [g0, g1) for the whole launch
    const int gpt = (G + T - 1) / T;
    const int g0 = min(tid * gpt, G);
    const int g1 = min(g0 + gpt, G);
    for (int g = g0; g < g1; ++g) {
        for (int r = 0; r < R; ++r) accum[g * R + r] = 0.0f;
        for (int wi = 0; wi < KW; ++wi) gmask[g * KW + wi] = 0u;
        for (int j = 0; j < NZW; ++j) gnz[g * NZW + j] = 0u;
        gzc[g] = 0u;
    }
    for (int i = tid; i < GW; i += T) wide_bits[i] = 0u;
    if (resident) {
        // 16 bytes a copy (K is a multiple of 32); waited for with the first row
        for (int i = tid; i < (K * R) >> 2; i += T) __pipeline_memcpy_async(cap_s + 4 * i, o.cap_eff + 4 * i, 16);
        for (int i = tid; i < K >> 2; i += T) __pipeline_memcpy_async(tz_s + 4 * i, o.tzc + 4 * i, 16);
        __pipeline_commit();
    }
    // a group count above vmax could make the prefix sum over G groups wrap
    const uint32_t vmax = 0x7fffffffu / (uint32_t)G;
    int32_t n_open = 0;       // identical in every thread
    bool wide_mode = false;   // some open group may be wide (identical in every thread)

    for (int base = 0; base < C; base += nbits) {
        const int cend = min(base + nbits, C);
        __syncthreads();  // the previous chunk's readers are done with the bitmap and the rows
        for (int i = tid; i < (nbits >> 5); i += T) bitmap[i] = 0u;
        __syncthreads();
        // a warp per class, its lanes over the compat and fresh words
#pragma unroll 4
        for (int cl = warp; cl < cend - base; cl += nwarps) {
            const int c = base + cl;
            uint32_t any = 0u;
            for (int wi = lane; wi < KW; wi += 32) any |= o.compat[(size_t)c * KW + wi] | o.fresh[(size_t)c * KW + wi];
            if (__any_sync(kFullMask, any != 0u)) {
                if (lane == 0) atomicOr(&bitmap[cl >> 5], 1u << (cl & 31));
            } else if (lane == 0) {
                o.unplaced[c] = o.count[c];
            }
        }
        __syncthreads();
        // no-op classes: a zero take row each (16 bytes a store when rows allow)
        for (int wd = 0; wd < (nbits >> 5); ++wd) {
            uint32_t idle = ~bitmap[wd];
            while (idle) {
                const int c = base + (wd << 5) + __ffs(idle) - 1;
                idle &= idle - 1u;
                if (c >= cend) break;
                if ((G & 3) == 0) {
                    int4* row4 = reinterpret_cast<int4*>(o.take + (size_t)c * G);
                    for (int i = tid; i < (G >> 2); i += T) row4[i] = make_int4(0, 0, 0, 0);
                } else {
                    for (int g = tid; g < G; g += T) o.take[(size_t)c * G + g] = 0;
                }
            }
        }

        int c = next_real(bitmap, nbits, base, base - 1, cend);
        if (resident && c < cend) {
            load_row(rows, c, o, K, R);
            __pipeline_wait_prior(0);
            __syncthreads();
        }
        for (int step = 0; c < cend; ++step) {
            const int c_next = next_real(bitmap, nbits, base, c, cend);
            float* row = rows + (resident ? (step & 1) * ROW : 0);
            if (!resident) {
                __syncthreads();  // everyone is done with the previous row
                load_row(row, c, o, K, R);
                __pipeline_wait_prior(0);
                __syncthreads();
            }
            const float* nf_row = row;
            const float* pr_row = row + K;
            const uint32_t* compat_row = reinterpret_cast<const uint32_t*>(row + 2 * K);
            const uint32_t* fresh_row = compat_row + KW;
            const uint32_t* hasres_row = fresh_row + KW;
            const float* req_row = reinterpret_cast<const float*>(hasres_row + KW);
            const int32_t* scal = reinterpret_cast<const int32_t*>(req_row + R);
            const int32_t count_c = scal[0];
            const int32_t env_c = scal[1];
            const uint32_t azc_c = (uint32_t)scal[2];

            // the fresh-fit max is free of the carry: warp partials now,
            // combined behind the prefix sum's barrier
            uint32_t mk = 0u;
            for (int k = T - 1 - tid; k < K; k += T)
                mk = max(mk, ktt::fkey_max(bit_of(fresh_row, k) ? nf_row[k] : 0.0f));
            // the request in registers for the fits of this step
            float q[RT > 0 ? RT : 1];
            if constexpr (RT > 0) {
#pragma unroll
                for (int r = 0; r < RT; ++r) q[r] = req_row[r];
            }
            mk = __reduce_max_sync(kFullMask, mk);
            if (lane == 0) s_mfit[warp] = mk;

            // -- a wide step: the owners mark their wide groups (W0) ------------
            uint32_t mine = 0u;     // bit g - g0: an owned group is wide this step
            bool has_wide = false;  // identical in every thread
            if (wide_mode) {
                for (int g = g0; g < min(g1, n_open); ++g) {
                    int n = 0;  // surviving types, counted past kNarrowTypes at most
                    for (int j = 0; j < NZW && n <= kNarrowTypes; ++j) {
                        uint32_t nzw = gnz[g * NZW + j];
                        while (nzw && n <= kNarrowTypes) {
                            const int wi = (j << 5) + __ffs(nzw) - 1;
                            nzw &= nzw - 1u;
                            n += __popc(gmask[g * KW + wi]);
                        }
                    }
                    const bool wide = n > kNarrowTypes;
                    if (wide) {
                        mine |= 1u << (g - g0);
                        ngrp[g] = (int32_t)ktt::fkey_max(0.0f);  // the key of its max, raised by the warps
                    }
                    if (gpt > 1) {
                        if (wide) atomicOr(&wide_bits[g >> 5], 1u << (g & 31));
                        else atomicAnd(&wide_bits[g >> 5], ~(1u << (g & 31)));
                    }
                }
                if (gpt == 1) {
                    // thread t owns group t: a warp's ballot is its bitmap word
                    const uint32_t wb = __ballot_sync(kFullMask, mine != 0u);
                    if (lane == 0 && warp < GW) wide_bits[warp] = wb;
                }
                __syncthreads();  // W0: the bitmap, and the last step's carry, visible
                uint32_t any = 0u;
                for (int i = lane; i < GW; i += 32) any |= wide_bits[i];
                has_wide = __any_sync(kFullMask, any != 0u);
            }

            // -- (1)+(2) best fit of the class on each owned narrow open group -
            uint32_t tv = 0u;
            bool risk = false;
            for (int g = g0; g < g1; ++g) {
                if ((mine >> (g - g0)) & 1u) continue;  // wide: its warps count it, below
                float best = 0.0f;
                if (g < n_open) {
                    const uint32_t gz = gzc[g] & azc_c;
                    const float* acc = accum + g * R;
                    for (int j = 0; j < NZW; ++j) {
                        uint32_t nzw = gnz[g * NZW + j];
                        while (nzw) {
                            const int wi = (j << 5) + __ffs(nzw) - 1;
                            nzw &= nzw - 1u;
                            uint32_t w = gmask[g * KW + wi] & compat_row[wi];
                            while (w) {
                                const int k = (wi << 5) + __ffs(w) - 1;
                                w &= w - 1u;
                                if (!joint_ok(gz & tz[k])) continue;
                                best = fmaxf(best, fit_count<RT>(cap + k * R, acc, q, req_row, R));
                            }
                        }
                    }
                }
                const int32_t v = ktt::f2i_sat(best);
                ngrp[g] = v;
                tv += (uint32_t)v;
                risk |= (uint32_t)v > vmax;
            }
            if (has_wide) {
                // the wide groups' fits: a (group, word) item a warp, a type a lane
                for_wide_items(wide_bits, GW, gnz, NZW, warp, nwarps, [&](int g, int wi) {
                    const uint32_t w = gmask[g * KW + wi] & compat_row[wi];
                    if (w == 0u) return;
                    const int k = (wi << 5) + lane;
                    const bool bit = (w >> lane) & 1u;
                    float f = -1.0f;  // not joined: no take keeps it
                    if (bit && joint_ok(gzc[g] & azc_c & tz[k]))
                        f = fit_count<RT>(cap + k * R, accum + g * R, q, req_row, R);
                    if (bit) fits[(size_t)g * K + k] = f;
                    const uint32_t key = __reduce_max_sync(kFullMask, ktt::fkey_max(fmaxf(f, 0.0f)));
                    if (lane == 0) atomicMax(reinterpret_cast<uint32_t*>(ngrp) + g, key);
                });
                __syncthreads();  // W1: the wide groups' maxima
                for (int g = g0; g < g1; ++g) {
                    if (!((mine >> (g - g0)) & 1u)) continue;
                    const int32_t v = ktt::f2i_sat(ktt::fkey_value((uint32_t)ngrp[g]));
                    ngrp[g] = v;
                    tv += (uint32_t)v;
                    risk |= (uint32_t)v > vmax;
                }
            }

            // -- (3) first fit: exclusive prefix sum in group order ----------
            const uint32_t incl = ktt::warp_incl_scan_u32(tv);
            // a warp whose fits could wrap the prefix sum says so with an
            // all-ones slot (no true warp total comes near it)
            const bool warp_risk = __any_sync(kFullMask, risk);
            if (lane == 31) s_scan[warp] = warp_risk ? kFullMask : incl;
            __syncthreads();  // barrier 1
            if (resident && c_next < cend) load_row(rows + ((step + 1) & 1) * ROW, c_next, o, K, R);
            if (tid == 0) {
                for (int j = 0; j < NZW; ++j) open_nz_full[j] = open_nz_last[j] = 0u;
                s_open_types[0] = s_open_types[1] = 0u;
            }
            uint32_t sv = lane < nwarps ? s_scan[lane] : 0u;
            risk = __any_sync(kFullMask, sv == kFullMask);
            if (risk) {
                // the exact wrapped warp totals instead
                __syncthreads();  // every warp has read the slots
                if (lane == 31) s_scan[warp] = incl;
                __syncthreads();
                sv = lane < nwarps ? s_scan[lane] : 0u;
            }
            const uint32_t total = __reduce_add_sync(kFullMask, sv);
            uint32_t before = __reduce_add_sync(kFullMask, lane < warp ? sv : 0u) + incl - tv;
            const float max_fit_f =
                ktt::fkey_value(__reduce_max_sync(kFullMask, lane < nwarps ? s_mfit[lane] : 0u));
            uint32_t tsum = 0u;
            for (int g = g0; g < g1; ++g) {
                const int32_t v = ngrp[g];
                int32_t t = (int32_t)((uint32_t)count_c - before);
                t = min(max(t, 0), v);
                ngrp[g] = t;
                before += (uint32_t)v;
                tsum += (uint32_t)t;
            }
            uint32_t placed;
            if (!risk && count_c >= 0) {
                // no prefix wraps: the takes fill the groups in order up to count
                placed = min((uint32_t)count_c, total);
            } else {
                tsum = __reduce_add_sync(kFullMask, tsum);
                __syncthreads();  // every warp has read the scan slots
                if (lane == 0) s_scan[warp] = tsum;
                __syncthreads();
                placed = __reduce_add_sync(kFullMask, lane < nwarps ? s_scan[lane] : 0u);
            }
            const int32_t leftover = (int32_t)((uint32_t)count_c - placed);

            // -- (4) the fresh-group envelope --------------------------------
            const bool use_price = price_objective && env_c != 0;
            if (use_price) {
                const int32_t tail = (int32_t)((uint32_t)leftover + ~(uint32_t)env_c);  // leftover + (-env - 1)
                const int32_t env_n = env_c > 0 ? env_c : max(tail, 1);
                const float envf = (float)env_n;
                const float need = max_fit_f != max_fit_f ? max_fit_f : fminf(max_fit_f, envf);
                uint32_t bh = kFullMask, bi = kFullMask;
                for (int k = tid; k < K; k += T) {
                    const float nf = nf_row[k];
                    const float ngroups = ceilf(__fdiv_rn(envf, fmaxf(nf, 1.0f)));
                    const bool eligible = bit_of(fresh_row, k) && nf >= 1.0f &&
                                          (__fmul_rn(2.0f, fminf(nf, envf)) >= need || bit_of(hasres_row, k));
                    const uint32_t h = ktt::fkey_min(eligible ? __fmul_rn(pr_row[k], ngroups) : ktt::f_inf());
                    if (h < bh) {  // k rises within a thread: ties keep the first
                        bh = h;
                        bi = (uint32_t)k;
                    }
                }
                const uint32_t wh = __reduce_min_sync(kFullMask, bh);
                const uint32_t wk = __reduce_min_sync(kFullMask, bh == wh ? bi : kFullMask);
                if (lane == 0) {
                    s_hi[warp] = wh;
                    s_idx[warp] = wk;
                }
            }
            if (resident) __pipeline_wait_prior(0);  // the next row has landed (this thread's part)
            __syncthreads();                          // barrier 2: argmin slots, and the next row, visible

            int32_t per_new;
            bool ok = false;
            float p_star = 0.0f, pnp = 0.0f;
            if (use_price) {
                const uint32_t sh = lane < nwarps ? s_hi[lane] : kFullMask;
                const uint32_t si = lane < nwarps ? s_idx[lane] : kFullMask;
                const uint32_t hi = __reduce_min_sync(kFullMask, sh);
                uint32_t kstar = __reduce_min_sync(kFullMask, sh == hi ? si : kFullMask);
                if (kstar >= (uint32_t)K) kstar = 0;
                ok = isfinite(ktt::fkey_value(hi));
                per_new = ok ? ktt::f2i_sat(nf_row[kstar]) : 0;
                p_star = pr_row[kstar];
                pnp = (float)per_new;
            } else {
                per_new = ktt::f2i_sat(max_fit_f);
            }

            // -- open fresh identical groups for the remainder ---------------
            int32_t n_new = 0;
            bool new_wide = false;  // a new group opens wide (identical in every thread)
            if (leftover > 0 && per_new > 0) {
                // both below 2^31, so the ceiling divides exactly in uint32
                const uint32_t want = ((uint32_t)leftover + (uint32_t)per_new - 1u) / (uint32_t)per_new;
                n_new = (int32_t)min(want, (uint32_t)(G - n_open));
            }

            // -- (5) carry update; each thread owns its groups' rows, but a ---
            // -- wide group's words are its warps' ----------------------------
            const int64_t left64 = leftover;
            const int64_t pn64 = per_new;
            if (n_new > 0) {
                // a new group's mask is the open mask's types that hold its
                // take: per_new for all but the last, which may take less;
                // built once as words by ballot, then copied per group
                const int64_t last = left64 - (int64_t)(n_new - 1) * pn64;
                const float full_f = (float)per_new;
                const float last_f = (float)(last > pn64 ? pn64 : last);
                for (int base_k = warp << 5; base_k < K; base_k += T) {
                    const int k = base_k + lane;
                    const float nf = nf_row[k];
                    const bool open = bit_of(fresh_row, k) && (!use_price || (ok && nf >= pnp && pr_row[k] <= p_star));
                    const uint32_t wf = __ballot_sync(kFullMask, open && full_f <= nf);
                    const uint32_t wl = __ballot_sync(kFullMask, open && last_f <= nf);
                    if (lane == 0) {
                        const int wi = base_k >> 5;
                        open_full[wi] = wf;
                        open_last[wi] = wl;
                        if (wf) {
                            atomicOr(&open_nz_full[wi >> 5], 1u << (wi & 31));
                            atomicAdd(&s_open_types[0], (uint32_t)__popc(wf));
                        }
                        if (wl) {
                            atomicOr(&open_nz_last[wi >> 5], 1u << (wi & 31));
                            atomicAdd(&s_open_types[1], (uint32_t)__popc(wl));
                        }
                    }
                }
                __syncthreads();  // barrier 3, only in steps that open groups
                // all but the last new group take open_full, the last open_last
                new_wide = (n_new > 1 && s_open_types[0] > kNarrowTypes) || s_open_types[1] > kNarrowTypes;
            }
            for (int g = g0; g < g1; ++g) {
                const int32_t tk = ngrp[g];
                const bool is_new = g >= n_open && g < n_open + n_new;
                int32_t tn = 0;
                if (is_new) {
                    int64_t rest = left64 - (int64_t)(g - n_open) * pn64;
                    rest = rest < 0 ? 0 : rest;
                    tn = (int32_t)(rest > pn64 ? pn64 : rest);
                }
                const int32_t ta = tk + tn;
                o.take[(size_t)c * G + g] = ta;
                const float takef = (float)ta;
                if (tk > 0 && ((mine >> (g - g0)) & 1u)) {
                    gzc[g] = gzc[g] & azc_c;  // its kept words: below
                } else if (tk > 0) {
                    // touched open group: keep the surviving types the class
                    // joined on that still hold the new total
                    const uint32_t gz = gzc[g] & azc_c;
                    const float* acc = accum + g * R;
                    for (int j = 0; j < NZW; ++j) {
                        uint32_t nzw = gnz[g * NZW + j];
                        uint32_t nz_new = 0u;
                        while (nzw) {
                            const int wi = (j << 5) + __ffs(nzw) - 1;
                            nzw &= nzw - 1u;
                            uint32_t w = gmask[g * KW + wi] & compat_row[wi];
                            uint32_t keep = 0u;
                            while (w) {
                                const int b = __ffs(w) - 1;
                                w &= w - 1u;
                                const int k = (wi << 5) + b;
                                if (joint_ok(gz & tz[k]) && takef <= fit_count<RT>(cap + k * R, acc, q, req_row, R))
                                    keep |= 1u << b;
                            }
                            gmask[g * KW + wi] = keep;
                            if (keep) nz_new |= 1u << (wi & 31);
                        }
                        gnz[g * NZW + j] = nz_new;
                    }
                    gzc[g] = gz;
                } else if (is_new) {
                    // a fresh group (all-zero mask until now): copy the
                    // non-zero words of its open mask
                    const bool is_last = g == n_open + n_new - 1;
                    const uint32_t* open = is_last ? open_last : open_full;
                    const uint32_t* open_nz = is_last ? open_nz_last : open_nz_full;
                    for (int j = 0; j < NZW; ++j) {
                        uint32_t m = open_nz[j];
                        gnz[g * NZW + j] = m;
                        while (m) {
                            const int wi = (j << 5) + __ffs(m) - 1;
                            m &= m - 1u;
                            gmask[g * KW + wi] = open[wi];
                        }
                    }
                    gzc[g] = azc_c;
                }
                if (ta > 0) {
                    float* acc = accum + g * R;
                    for (int r = 0; r < R; ++r) acc[r] = __fadd_rn(acc[r], __fmul_rn(takef, req_row[r]));
                }
            }
            if (has_wide) {
                // a touched wide group keeps the joined types whose fit (2)
                // holds its take: one ballot a word
                for_wide_items(wide_bits, GW, gnz, NZW, warp, nwarps, [&](int g, int wi) {
                    const int32_t tk = ngrp[g];
                    if (tk <= 0) return;
                    const float takef = (float)tk;  // an open group takes no new pods
                    const uint32_t w = gmask[g * KW + wi] & compat_row[wi];
                    const bool keep =
                        ((w >> lane) & 1u) && takef <= fits[(size_t)g * K + (wi << 5) + lane];
                    const uint32_t kept = __ballot_sync(kFullMask, keep);
                    if (lane == 0) gmask[g * KW + wi] = kept;
                });
                __syncthreads();  // W2: every kept word written
                // each warp rebuilds the non-zero-word bitmaps of its own
                // lanes' touched wide groups (their owners read them next)
                for (int j = 0; j < gpt; ++j) {
                    const int g = g0 + j;
                    const bool touched = g < g1 && ((mine >> j) & 1u) && ngrp[g] > 0;
                    uint32_t todo = __ballot_sync(kFullMask, touched);
                    while (todo) {
                        const int gg = __shfl_sync(kFullMask, g, __ffs(todo) - 1);
                        todo &= todo - 1u;
                        for (int z = 0; z < NZW; ++z) {
                            const uint32_t old = gnz[gg * NZW + z];
                            const uint32_t nz = __ballot_sync(
                                kFullMask, ((old >> lane) & 1u) && gmask[gg * KW + (z << 5) + lane] != 0u);
                            if (lane == 0) gnz[gg * NZW + z] = nz;
                        }
                    }
                }
                __syncwarp();
            }
            wide_mode = has_wide || new_wide;
            if (tid == 0) {
                // the new groups' takes sum to leftover, or to n_new full groups when clipped
                const int64_t full = (int64_t)n_new * pn64;
                const int64_t sum_new = n_new > 0 ? (left64 < full ? left64 : full) : 0;
                o.unplaced[c] = (int32_t)((uint32_t)count_c - placed - (uint32_t)sum_new);
            }
            n_open += n_new;
            c = c_next;
        }
    }

    __pipeline_wait_prior(0);  // no copy outlives the block
    __syncthreads();  // the carry rows, written by their owners, out in coalesced order
    if (!SCRATCH)
        for (int i = tid; i < G * KW; i += T) o.gmask_out[i] = gmask[i];
    for (int i = tid; i < G; i += T) o.gzc_out[i] = gzc[i];
    if (tid == 0) o.n_open_out[0] = n_open;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one launch, in bytes: `layout` 1 (resident)
// keeps cap_eff/tzc in shared memory and double-buffers the class row, 0 is
// the lean layout, 2 the scratch layout (survivor words in device memory).
size_t ffd_scan_smem_bytes(int G, int K, int R, int threads, int layout) {
    return 4 * smem_words(G, K, R, threads, layout);
}

// `gnz_scratch` is a [G, ceil(K / 1024)] u32 buffer for the scratch layout,
// unused (may be null) by the others; `wide_scratch` is G * K + ceil(G / 32)
// u32 words for every layout: a wide step's fits, then its wide-group
// bitmap (the kernel zeroes the bitmap; the fits are written before read).
int ffd_scan_launch(const void* req, const void* compat_w, const void* fresh_w, const void* hasres_w,
                    const void* n_fresh, const void* price, const void* count, const void* env,
                    const void* azc, const void* cap_eff, const void* tzc, void* take_out,
                    void* unplaced_out, void* gmask_out, void* gzc_out, void* n_open_out, void* gnz_scratch,
                    void* wide_scratch, int C, int G, int K, int R, int price_objective, int threads, int layout,
                    void* stream) {
    if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) return (int)cudaErrorInvalidValue;
    // a thread's wide groups are bits of one word (shared memory holds far fewer groups)
    if (G > 32 * threads || wide_scratch == nullptr) return (int)cudaErrorInvalidValue;
    if (layout < kLean || layout > kScratch || (layout == kScratch && gnz_scratch == nullptr))
        return (int)cudaErrorInvalidValue;
    const size_t smem = ffd_scan_smem_bytes(G, K, R, threads, layout);
    const bool scratch = layout == kScratch;
    // the four template cases: R = 9 or run-time R, by scratch or not
    const int which = (R == 9 ? 0 : 1) + (scratch ? 2 : 0);
    void (*const kernels[4])(Operands, int, int, int, int, int, int) = {
        ffd_scan_kernel<9, false>, ffd_scan_kernel<0, false>, ffd_scan_kernel<9, true>, ffd_scan_kernel<0, true>};
    auto kernel = kernels[which];
    // raise the kernel's shared-memory ceiling once per size seen (the call
    // costs host time on every launch otherwise)
    static size_t ceiling[4] = {0, 0, 0, 0};
    size_t& have = ceiling[which];
    if (smem > have) {
        const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        have = smem;
    }
    Operands o{(const float*)req,     (const uint32_t*)compat_w, (const uint32_t*)fresh_w,
               (const uint32_t*)hasres_w, (const float*)n_fresh, (const float*)price,
               (const int32_t*)count, (const int32_t*)env,      (const uint32_t*)azc,
               (const float*)cap_eff, (const uint32_t*)tzc,     (int32_t*)take_out,
               (int32_t*)unplaced_out, (uint32_t*)gmask_out,     (uint32_t*)gzc_out,
               (int32_t*)n_open_out,  (uint32_t*)gnz_scratch,    (uint32_t*)wide_scratch};
    kernel<<<1, threads, smem, (cudaStream_t)stream>>>(o, C, G, K, R, price_objective, (int)(layout == kResident));
    return (int)cudaGetLastError();
}

}  // extern "C"
