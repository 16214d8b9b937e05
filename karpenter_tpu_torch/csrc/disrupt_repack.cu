// Kernel B: the candidate-set repack ([S, C, N] first fit onto live nodes).
//
// Replaces the Pallas kernel karpenter_tpu/solver/kernels/disrupt_pallas.py
// `disrupt_repack_pallas`. Same function: for each candidate set s, zero
// the headroom of the nodes the set deletes; then, over the pod classes in
// order, fit[n] = min over R of floor(hr / req) where req > 0 (else +inf),
// clipped at 0 and zeroed where the class may not land on the node; an
// exclusive prefix sum across nodes places the class first-fit, clipped to
// its count; hr -= take * req. Float operations are the reference's, in
// its order: IEEE division, and -fmad=false so hr - take * req rounds the
// multiply and the subtract apart. Integer sums wrap as the reference's
// int32 cumsum and sum do (uint32 lanes).
//
// Two callers, two kernels. The provisioning solve sends one set (S=1) to
// pack pending pods onto existing nodes, and reads the takes; every class
// with a feasible node holds pods. The consolidation sweep sends one set
// per candidate (S up to 1024) and reads only the [S, C] leftovers; a set
// holds the pods of the 1-32 nodes it deletes, a few of the C classes, and
// the padding sets of the S bucket hold none. Either entry may pass no
// takes pointer (then no [S, C, N] tensor exists).
//
// What bounds it on an H100: the latency of the class steps, which are
// sequential within a set. The bytes are few without takes.
//
// Both kernels skip the (set, class) pairs the span kernel proves no-ops,
// which it computes once a launch before them (below): at full width 37 of
// the pre-pass's 65 feasible classes, and all but 1,260 of the ramp-down
// sweep's 30,208 pairs. The pre-pass's 37 hold pods that fit on no node;
// only a per-node bound finds them, which one block would compute at about
// the cost of a step a class, and the span kernel spreads over C blocks.
//
// The block kernel (S=1, any shape the sweep kernel cannot hold, and the
// sets the sweep kernel hands off): one thread block per set; thread t owns a contiguous run of nodes, whose
// headroom rows stay in shared memory for the whole launch. A chunk of
// classes is staged at once -- feasibility as bits, requests, members -- so
// a class step loads nothing from device memory. A step has ONE barrier: the
// prefix sum's, with its per-warp slots double-buffered by step parity,
// which also ORs a wrap-around flag; the placed count is min(member, total)
// unless a fit could make the int32 prefix sum wrap (or member < 0), when
// it is summed exactly behind two more barriers. When N is too large for
// the headroom to sit in shared memory, it lives in a [S, N, R + 1] scratch
// the wrapper allocates, feasibility is read from device memory and every
// class takes a step.
//
// The sweep kernel (S > 1): one warp per set, several sets a block, each
// set's headroom in shared memory, and no block barrier at all. A block
// step over 1,024 nodes costs ~1.6 us on an H100 whatever it places; a
// sweep's class places a few pods, on the first surviving nodes with
// room. So the warp walks the nodes 32 at a time, a lane a node: fits, a
// warp scan continuing the prefix, the takes, the headroom update; it
// visits only the 32-node pieces where a pod of the class may fit, and
// stops once the prefix reaches the member count, where that is exact. A
// node's headroom row is staged on the first walk that reaches its piece,
// by the lane that owns it, so a set loads only the rows it touches.
//
// A dense set (many stepping classes, each walking many pieces) costs the
// sweep kernel a piece at a time, where a block step covers every node at
// once. So when the block kernel can run every set of the launch at once
// (S at most two blocks an SM), the sweep kernel hands such a set to it:
// after two walks or more whose pieces exceed twice the walks plus 8, it
// counts the set's stepping classes, and leaves the set, flagged, when the
// walks left at the recent walks' length would cost more than the block
// kernel's whole run of it. (Not the average since the set's first walk:
// that lags the lengthening walks, and on a dense S=64 world 3 of 64 sets
// whose first walks were short never handed off, so the launch waited for
// them.) The block kernel, launched after the sweep
// kernel, runs the flagged sets alone, from headroom0, writing each of
// their rows again. Walks of one piece never hand off.
//
// The span kernel, once a launch, bounds every fit of class c in every set
// by node. Take the axes r with req[c, r] > 0 on which no class of the
// launch requests a negative amount or NaN: hr[n, r] then never rises above
// headroom0[n, r], or above 0 on a deleted node (hr -= t * req with req >= 0
// rounds down or stays; a finite hr never turns +inf or NaN). Division and
// floor are monotone, so on a node whose headroom on such an axis is not
// NaN every fit is at most g[n] = min over those axes of floor(max(
// headroom0[n, r], 0) / req[c, r]), as the kernel computes it; a feasible
// node with no such axis is open (unbounded).
// - room[c, n] = feasible and (open or g[n] > 0): a node without it fits no
//   pod of c in any set, and a walk skips it exactly (fit 0, take 0).
// - With no open node, B = the sum of g over c's feasible nodes (64 bits)
//   bounds every prefix: B = 0, no pod of c fits anywhere, every member
//   count is a no-op ([INT32_MIN, INT32_MAX]); B <= INT32_MAX, no prefix
//   wraps, so member in [INT32_MIN + B, 0] places nothing (and member -
//   before cannot wrap), and a walk with member >= 0 may stop once the
//   prefix reaches it (every later take is 0): span[c] = [INT32_MIN + B, 0].
// - Otherwise every count steps and its walk covers every node with room,
//   in wrapping uint32 arithmetic: span[c] = [1, -1].
// A (set, class) pair with its member count inside span[c] takes no step:
// leftover = member, a zero takes row, headroom unchanged. A zero-request
// class has no bounding axis: with member 0 it steps, its fits saturate at
// INT32_MAX, the prefix sum wraps and it places pods, as in the reference.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "block_ops.cuh"

namespace {

using ktt::kFullMask;
using ktt::kMaxWarps;

constexpr int kMaxR = 32;
constexpr int kMaxThreads = 1024;
constexpr int kSpanThreads = 1024;  // a warp a 32-node piece up to N = 1,024
constexpr int kMaxSetsPerBlock = 16;

__host__ __device__ __forceinline__ int nwords(int N) { return (N + 31) >> 5; }

// Dynamic shared memory in 32-bit words of the block kernel, for a chunk of
// `chunk` classes.
__host__ __device__ __forceinline__ size_t smem_words(int N, int R, int chunk, int resident) {
    const size_t per_class = (resident ? (size_t)nwords(N) : 0) + R + 1;  // feas bits, req, member
    return (resident ? (size_t)N * (R + 1) : 0) + (size_t)chunk * per_class + (((size_t)chunk + 31) >> 5) +
           3 * kMaxWarps;
}

// Shared memory in 32-bit words of one set of the sweep kernel: headroom
// [N, R] and a bit a 32-node piece (its rows staged).
__host__ __device__ __forceinline__ size_t sweep_set_words(int N, int R) {
    return (size_t)N * R + (((size_t)nwords(N) + 31) >> 5);
}

// Programmatic dependent launch (Hopper): the kernel after the span kernel on
// the stream may start while the span kernel runs, staging what it needs
// from the inputs, and waits for the span kernel's writes before it reads
// them. The span kernel lets it start as soon as every span block runs.
// On an H100 this took 3.4-3.6 us off each pre-pass launch (tick 2's
// 0.0646 -> 0.0610 ms device-only; hack/disrupt_repack_versions.py).
__device__ __forceinline__ void let_dependents_start() { asm volatile("griddepcontrol.launch_dependents;"); }
__device__ __forceinline__ void wait_for_spans() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

// One bit per byte of x: bit j is set when byte j is non-zero.
__device__ __forceinline__ uint32_t nz_bits4(uint32_t x) {
    const uint32_t t = __vcmpne4(x, 0u) & 0x08040201u;
    return (t | (t >> 8) | (t >> 16) | (t >> 24)) & 0xfu;
}

// A class's request row: in registers when R is fixed at compile time (so
// the next class's row loads while a walk runs), else read where it lies.
template <int RT>
struct ReqRow {
    float v[RT];
    __device__ __forceinline__ void load(const float* __restrict__ q) {
#pragma unroll
        for (int r = 0; r < RT; ++r) v[r] = __ldg(q + r);
    }
    __device__ __forceinline__ float operator[](int r) const { return v[r]; }
};

template <>
struct ReqRow<0> {
    const float* q;
    __device__ __forceinline__ void load(const float* __restrict__ row) { q = row; }
    __device__ __forceinline__ float operator[](int r) const { return q[r]; }
};

// The span of class c (blockIdx.x) and its room bits: the member counts
// whose step is a no-op in every set, and the nodes where a pod of c may
// fit (the source note above).
template <int RT>
__global__ void __launch_bounds__(kSpanThreads) disrupt_repack_span_kernel(
    const float* __restrict__ headroom0,  // [N, R]
    const float* __restrict__ req,        // [C, R]
    const uint8_t* __restrict__ feas,     // [C, N]
    int2* __restrict__ span,              // [C]
    uint32_t* __restrict__ room,          // [C, NW] bit n: a pod of c may fit on node n
    int C, int N, int r_arg) {
    let_dependents_start();
    const int R = RT > 0 ? RT : r_arg;
    const int c = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int NW = nwords(N);
    __shared__ int s_usable[kMaxR];  // req[c, r] > 0 and no class requests < 0 or NaN on r
    __shared__ unsigned long long s_bound;
    __shared__ int s_open;           // a feasible node that no axis bounds
    if (tid < R) s_usable[tid] = req[(size_t)c * R + tid] > 0.0f;
    if (tid == 0) {
        s_bound = 0ull;
        s_open = 0;
    }
    __syncthreads();
    for (int i = tid; i < C * R; i += kSpanThreads)
        if (!(req[i] >= 0.0f)) s_usable[i % R] = 0;
    __syncthreads();
    unsigned long long sum = 0ull;
    bool open = false;
    for (int w = warp; w < NW; w += kSpanThreads / 32) {
        const int n = (w << 5) + lane;
        bool may = false;
        if (n < N) {
            // the feasibility byte and the headroom row load together
            const bool feasible = feas[(size_t)c * N + n] != 0;
            bool bounded = false;
            int32_t g = INT_MAX;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const float h = __ldg(headroom0 + (size_t)n * R + r);
                if (s_usable[r] && h == h) {
                    bounded = true;
                    g = min(g, ktt::f2i_sat(floorf(__fdiv_rn(fmaxf(h, 0.0f), __ldg(req + (size_t)c * R + r)))));
                }
            }
            if (!feasible) {
                // no pod of c lands here
            } else if (bounded) {
                sum += (uint32_t)g;
                may = g > 0;
            } else {
                open = may = true;
            }
        }
        const uint32_t b = __ballot_sync(kFullMask, may);
        if (lane == 0) room[(size_t)c * NW + w] = b;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(kFullMask, sum, off);
    open = __any_sync(kFullMask, open);
    if (lane == 0) {
        atomicAdd(&s_bound, sum);
        if (open) s_open = 1;
    }
    __syncthreads();
    if (tid == 0) {
        int2 out = make_int2(1, -1);  // every count steps, its walk over every node with room
        if (!s_open && s_bound == 0ull)
            out = make_int2(INT_MIN, INT_MAX);
        else if (!s_open && s_bound <= (unsigned long long)INT_MAX)
            out = make_int2((int)((long long)INT_MIN + (long long)s_bound), 0);
        span[c] = out;
    }
}

// The sweep kernel: warp w of block b walks set b * (blockDim.x / 32) + w.
template <int RT>
__global__ void __launch_bounds__(kMaxSetsPerBlock * 32) disrupt_repack_sweep_kernel(
    const float* __restrict__ headroom0,  // [N, R]
    const float* __restrict__ req,        // [C, R]
    const int32_t* __restrict__ member,   // [S, C]
    const uint8_t* __restrict__ excl,     // [S, N]
    const int2* __restrict__ span,        // [C] from the span kernel
    const uint32_t* __restrict__ room,    // [C, NW] from the span kernel
    int32_t* __restrict__ leftover,       // [S, C]
    int32_t* __restrict__ takes,          // [S, C, N], or null
    int32_t* __restrict__ handoff,        // [S] 1: the block kernel runs the set; or null
    int S, int C, int N, int r_arg) {
    const int R = RT > 0 ? RT : r_arg;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int s = blockIdx.x * (blockDim.x >> 5) + warp;
    if (s >= S) return;  // the whole warp; the kernel has no block barrier
    const int NW = nwords(N);
    if (handoff != nullptr && lane == 0) handoff[s] = 0;
    // pieces visited and classes walked so far, the walks' recent length
    // (pieces x 16, each walk weighing a quarter), and the set's stepping
    // classes once counted (the hand-off test below)
    int visited = 0, walked = 0, recent16 = 0, k_set = -1;
    extern __shared__ __align__(16) uint32_t smem[];
    float* hr = reinterpret_cast<float*>(smem + (size_t)warp * sweep_set_words(N, R));  // [N, R]
    uint32_t* staged = reinterpret_cast<uint32_t*>(hr + (size_t)N * R);                 // a bit a 32 nodes
    for (int i = lane; i < ((NW + 31) >> 5); i += 32) staged[i] = 0u;
    __syncwarp();
    wait_for_spans();

    for (int base = 0; base < C; base += 32) {
        // -- which of these 32 classes step in this set --------------------------
        const int c = base + lane;
        int32_t m = 0;
        int hi = 0;
        bool step = false;
        if (c < C) {
            m = member[(size_t)s * C + c];
            const int2 sp = span[c];
            hi = sp.y;
            step = m < sp.x || m > sp.y;
            if (!step) leftover[(size_t)s * C + c] = m;
        }
        uint32_t todo = __ballot_sync(kFullMask, step);
        if (takes != nullptr) {
            // a zero take row for each class; a walk writes over the nodes it visits
            const uint32_t rows = __ballot_sync(kFullMask, c < C);
            for (int cl = 0; cl < 32; ++cl) {
                if (!((rows >> cl) & 1u)) continue;
                int32_t* row = takes + ((size_t)s * C + base + cl) * N;
                for (int n = lane; n < N; n += 32) row[n] = 0;
            }
        }
        // -- the stepping classes in order, each a walk over the nodes with room --
        // the next class's request row, and lane l's room word of its piece l,
        // load while the walk before it runs
        ReqRow<RT> q, q_next;
        uint32_t next = 0u;
        if (todo) {
            const int c_next = base + __ffs(todo) - 1;
            q_next.load(req + (size_t)c_next * R);
            if (lane < NW) next = room[(size_t)c_next * NW + lane];
        }
        while (todo) {
            const int cl = __ffs(todo) - 1;
            todo &= todo - 1u;
            const int cc = base + cl;
            const uint32_t first = next;
            q = q_next;
            if (todo) {
                const int c_next = base + __ffs(todo) - 1;
                q_next.load(req + (size_t)c_next * R);
                if (lane < NW) next = room[(size_t)c_next * NW + lane];
            }
            const int32_t count = __shfl_sync(kFullMask, m, cl);
            // the prefix never wraps: the walk may stop once it reaches count
            const bool stops = __shfl_sync(kFullMask, hi, cl) == 0 && count >= 0;
            int32_t* trow = takes != nullptr ? takes + ((size_t)s * C + cc) * N : nullptr;
            uint32_t before = 0u, placed = 0u;
            bool done = false;
            const int visited0 = visited;
            for (int w0 = 0; w0 < NW && !done; w0 += 32) {
                // lane l holds the room word of 32-node piece w0 + l
                const uint32_t mine = w0 == 0 ? first : w0 + lane < NW ? room[(size_t)cc * NW + w0 + lane] : 0u;
                uint32_t pieces = __ballot_sync(kFullMask, mine != 0u);
                while (pieces) {
                    const int wl = __ffs(pieces) - 1;
                    pieces &= pieces - 1u;
                    const int w = w0 + wl;
                    ++visited;
                    const uint32_t bits = __shfl_sync(kFullMask, mine, wl);
                    const int n = (w << 5) + lane;
                    if (!((staged[w >> 5] >> (w & 31)) & 1u)) {
                        // first walk to reach these 32 nodes: each lane stages its own row
                        if (n < N) {
                            const bool ex = excl[(size_t)s * N + n] != 0;
#pragma unroll
                            for (int r = 0; r < R; ++r) {
                                const float h = __ldg(headroom0 + (size_t)n * R + r);  // beside excl's load
                                hr[n * R + r] = ex ? 0.0f : h;
                            }
                        }
                        __syncwarp();
                        if (lane == 0) staged[w >> 5] |= 1u << (w & 31);
                        __syncwarp();
                    }
                    int32_t f = 0;
                    if ((bits >> lane) & 1u) {
                        float x = ktt::f_inf();
#pragma unroll
                        for (int r = 0; r < R; ++r) {
                            const float qr = q[r];
                            if (qr > 0.0f) x = fminf(x, floorf(__fdiv_rn(hr[n * R + r], qr)));
                        }
                        f = ktt::f2i_sat(fmaxf(x, 0.0f));
                    }
                    const uint32_t incl = ktt::warp_incl_scan_u32((uint32_t)f);
                    int32_t t = (int32_t)((uint32_t)count - (before + incl - (uint32_t)f));
                    t = min(max(t, 0), f);
                    if (t > 0) {
                        const float tf = (float)t;
#pragma unroll
                        for (int r = 0; r < R; ++r) hr[n * R + r] = __fsub_rn(hr[n * R + r], __fmul_rn(tf, q[r]));
                    }
                    if (trow != nullptr && n < N) trow[n] = t;
                    placed += __reduce_add_sync(kFullMask, (uint32_t)t);
                    before += __shfl_sync(kFullMask, incl, 31);
                    if (stops && before >= (uint32_t)count) {
                        done = true;  // every later node takes 0
                        break;
                    }
                }
            }
            if (lane == 0) leftover[(size_t)s * C + cc] = (int32_t)((uint32_t)count - placed);
            // Hand the set to the block kernel when its walks run long: at
            // their recent length (walks lengthen as the set's headroom runs
            // out), the walks left would cost more than the block kernel's
            // run of the whole set (a piece ~1.4 us here, a block step ~1.6 us
            // and ~10 us of staging there, with a margin of 1.5). It starts
            // the set again from headroom0 and writes every row of it.
            const int pieces16 = 16 * (visited - visited0);
            recent16 = walked == 0 ? pieces16 : recent16 + ((pieces16 - recent16) >> 2);
            ++walked;
            if (handoff != nullptr && walked >= 2 && visited > 2 * walked + 8) {
                if (k_set < 0) {
                    k_set = 0;
                    for (int c0 = 0; c0 < C; c0 += 32) {
                        bool st = false;
                        if (c0 + lane < C) {
                            const int32_t mc = member[(size_t)s * C + c0 + lane];
                            const int2 sp = span[c0 + lane];
                            st = mc < sp.x || mc > sp.y;
                        }
                        k_set += __popc(__ballot_sync(kFullMask, st));
                    }
                }
                if ((long long)(k_set - walked) * recent16 > 16LL * (11 + 2 * k_set)) {
                    if (lane == 0) handoff[s] = 1;
                    return;
                }
            }
        }
    }
}

// The block kernel's body. RT > 0 fixes R at compile time (the request axes
// of the repo's encoding), so a node's fit unrolls; RT = 0 takes R at run
// time. TAKES: the takes are written (the pre-pass's entry).
template <int RT, bool TAKES>
__device__ __forceinline__ void block_repack(
    const float* __restrict__ headroom0,  // [N, R]
    const float* __restrict__ req,        // [C, R]
    const uint8_t* __restrict__ feas,     // [C, N]
    const int32_t* __restrict__ member,   // [S, C]
    const uint8_t* __restrict__ excl,     // [S, N]
    const int2* __restrict__ span,        // [C] from the span kernel
    int32_t* __restrict__ leftover,       // [S, C]
    int32_t* __restrict__ takes,          // [S, C, N] (TAKES)
    float* __restrict__ scratch,          // [S, N, R + 1] when not resident
    int s, int C, int N, int r_arg, int chunk, int resident, int vec16) {
    const int R = RT > 0 ? RT : r_arg;
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
    // a fit above vmax could make the prefix sum over N nodes wrap
    const uint32_t vmax = 0x7fffffffu / (uint32_t)N;
    int parity = 0;

    for (int base = 0; base < C; base += chunk) {
        const int nc = min(chunk, C - base);
        __syncthreads();  // the previous chunk's readers are done
        // -- stage the chunk ---------------------------------------------------
        for (int i = tid; i < nc * R; i += T) rq[i] = req[(size_t)base * R + i];
        for (int i = tid; i < nc; i += T) mem[i] = member[(size_t)s * C + base + i];
        for (int i = tid; i < ((nc + 31) >> 5); i += T) bitmap[i] = 0u;
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
        __syncthreads();
        if (base == 0) wait_for_spans();  // the chunk's staging overlapped the span kernel
        // a class steps where its member count lies outside its span (the
        // span of a class without a feasible node holds every count)
        for (int cl = tid; cl < nc; cl += T) {
            const int2 sp = span[base + cl];
            if (mem[cl] < sp.x || mem[cl] > sp.y) atomicOr(&bitmap[cl >> 5], 1u << (cl & 31));
        }
        __syncthreads();
        // no-op classes: leftover = member, a zero take row each
        for (int cl = tid; cl < nc; cl += T)
            if (!((bitmap[cl >> 5] >> (cl & 31)) & 1u)) leftover[(size_t)s * C + base + cl] = mem[cl];
        if (TAKES) {
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
                int32_t* trow = TAKES ? takes + ((size_t)s * C + c) * N : nullptr;
                uint32_t tsum = 0u;
                for (int n = n0; n < n1; ++n) {
                    const int32_t v = fit[n];
                    int32_t t = (int32_t)((uint32_t)count_c - before);
                    t = min(max(t, 0), v);
                    before += (uint32_t)v;
                    tsum += (uint32_t)t;
                    if (TAKES) trow[n] = t;
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

// The block kernel: one thread block a set; after the sweep kernel, only
// the sets it handed off.
template <int RT>
__global__ void __launch_bounds__(kMaxThreads) disrupt_repack_kernel(
    const float* __restrict__ headroom0, const float* __restrict__ req, const uint8_t* __restrict__ feas,
    const int32_t* __restrict__ member, const uint8_t* __restrict__ excl, const int2* __restrict__ span,
    const int32_t* __restrict__ handoff, int32_t* __restrict__ leftover, int32_t* __restrict__ takes,
    float* __restrict__ scratch, int C, int N, int r_arg, int chunk, int resident, int vec16) {
    const int s = blockIdx.x;
    if (handoff != nullptr && handoff[s] == 0) return;  // the whole block
    if (takes != nullptr)
        block_repack<RT, true>(headroom0, req, feas, member, excl, span, leftover, takes, scratch, s, C, N,
                               r_arg, chunk, resident, vec16);
    else
        block_repack<RT, false>(headroom0, req, feas, member, excl, span, leftover, takes, scratch, s, C, N,
                                r_arg, chunk, resident, vec16);
}

// Launch `kernel` right after the span kernel, allowed to start before the
// span kernel ends (it waits for the spans in `wait_for_spans`).
template <typename... P, typename... A>
cudaError_t launch_after_spans(void (*kernel)(P...), unsigned grid, unsigned block, size_t smem, cudaStream_t st,
                               A... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(block);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

extern "C" {

int disrupt_repack_max_r() { return kMaxR; }

// Dynamic shared memory of one launch, in bytes: the block kernel's
// (resident: headroom and feasibility bits in shared memory) for layout 0
// or 1 and `chunk` classes, the sweep kernel's for layout 2 and `chunk` sets
// a block.
size_t disrupt_repack_smem_bytes(int N, int R, int chunk, int resident) {
    if (resident == 2) return 4 * (size_t)chunk * sweep_set_words(N, R);
    return 4 * smem_words(N, R, chunk, resident);
}

// The span kernel runs first. Then, with `sweep_sets` > 0, the sweep kernel
// with that many sets (warps) a block; and the block kernel in layout
// `resident` (0: headroom in `spill`, 1: in shared memory; -1: not
// launched) with `threads` threads and `chunk` classes staged at once --
// alone when sweep_sets is 0, else on the sets the sweep kernel hands it,
// which it does only when the block kernel runs every set at once (S at
// most two blocks an SM). scratch: the [C] int2 spans, the [C, ceil(N /
// 32)] uint32 room bits, then (both kernels) the [S] int32 hand-off flags.
// spill (layout 0): the [S, N, R + 1] float headroom and fits. takes may be
// null.
int disrupt_repack_launch(const void* headroom0, const void* req, const void* feas, const void* member,
                          const void* excl, void* leftover, void* takes, void* scratch, void* spill, int S,
                          int C, int N, int R, int sweep_sets, int threads, int chunk, int resident,
                          void* stream) {
    if (scratch == nullptr || sweep_sets < 0 || sweep_sets > kMaxSetsPerBlock || resident < -1 || resident > 1 ||
        (sweep_sets == 0 && resident < 0) || (resident == 0 && spill == nullptr))
        return (int)cudaErrorInvalidValue;
    if (resident >= 0 && (threads < 32 || threads > kMaxThreads || threads % 32 != 0 || chunk < 1))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int rt9 = R == 9;
    auto kernel = rt9 ? disrupt_repack_kernel<9> : disrupt_repack_kernel<0>;
    auto spans = rt9 ? disrupt_repack_span_kernel<9> : disrupt_repack_span_kernel<0>;
    auto sweep = rt9 ? disrupt_repack_sweep_kernel<9> : disrupt_repack_sweep_kernel<0>;
    const size_t smem_sweep = disrupt_repack_smem_bytes(N, R, sweep_sets, 2);
    const size_t smem_block = resident >= 0 ? disrupt_repack_smem_bytes(N, R, chunk, resident) : 0;
    // raise each kernel's shared-memory ceiling once per size seen (the call
    // costs host time on every launch otherwise)
    static size_t ceiling[2][2] = {{0, 0}, {0, 0}};
    size_t& have_sweep = ceiling[1][rt9 ? 0 : 1];
    size_t& have_block = ceiling[0][rt9 ? 0 : 1];
    if (sweep_sets > 0 && smem_sweep > have_sweep) {
        const cudaError_t err = cudaFuncSetAttribute(sweep, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_sweep);
        if (err != cudaSuccess) return (int)err;
        have_sweep = smem_sweep;
    }
    if (resident >= 0 && smem_block > have_block) {
        const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_block);
        if (err != cudaSuccess) return (int)err;
        have_block = smem_block;
    }
    int2* span = static_cast<int2*>(scratch);
    uint32_t* room = reinterpret_cast<uint32_t*>(span + C);
    int32_t* handoff = nullptr;
    if (sweep_sets > 0 && resident >= 0) {
        // SMs of the current device, read once a device
        static int sms[64] = {0};
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return (int)err;
        if (dev < 64 && sms[dev] == 0) {
            err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
            if (err != cudaSuccess) return (int)err;
        }
        if (dev < 64 && S <= 2 * sms[dev]) handoff = reinterpret_cast<int32_t*>(room + (size_t)C * nwords(N));
    }
    spans<<<C, kSpanThreads, 0, st>>>((const float*)headroom0, (const float*)req, (const uint8_t*)feas, span, room,
                                      C, N, R);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (sweep_sets > 0) {
        err = launch_after_spans(sweep, (S + sweep_sets - 1) / sweep_sets, 32 * sweep_sets, smem_sweep, st,
                                 (const float*)headroom0, (const float*)req, (const int32_t*)member,
                                 (const uint8_t*)excl, (const int2*)span, (const uint32_t*)room, (int32_t*)leftover,
                                 (int32_t*)takes, handoff, S, C, N, R);
        if (err != cudaSuccess || handoff == nullptr) return (int)err;
    }
    // feasibility rows load 16 bytes at a time when each row is whole 16-byte pieces
    const int vec16 = N % 16 == 0 && ((uintptr_t)feas & 15u) == 0;
    const int32_t* flags = handoff;
    if (handoff != nullptr) {
        // after the sweep kernel: an ordinary launch, which waits for its flags
        kernel<<<S, threads, smem_block, st>>>(
            (const float*)headroom0, (const float*)req, (const uint8_t*)feas, (const int32_t*)member,
            (const uint8_t*)excl, span, flags, (int32_t*)leftover, (int32_t*)takes, (float*)spill, C, N, R, chunk,
            resident, vec16);
        return (int)cudaGetLastError();
    }
    return (int)launch_after_spans(kernel, S, threads, smem_block, st, (const float*)headroom0, (const float*)req,
                                   (const uint8_t*)feas, (const int32_t*)member, (const uint8_t*)excl,
                                   (const int2*)span, flags, (int32_t*)leftover, (int32_t*)takes, (float*)spill, C,
                                   N, R, chunk, resident, vec16);
}

}  // extern "C"
