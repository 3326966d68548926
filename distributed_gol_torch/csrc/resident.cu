// K1: the resident kernel.  Replaces
// distributed_gol_tpu/ops/pallas_packed.py::_vmem_kernel (and its step
// _gen_vertical): every generation of a whole vertically packed board in
// one launch, the board held in registers across a thread-block cluster
// (resident_reg_kernel, gol_resident_reg_launch).
//
// K7: the batched form.  Replaces
// pallas_packed.py::_vmem_kernel_batched (built by
// _build_vmem_resident_batched): a contiguous (B, H/32, W) stack of B
// same-shape boards in one launch of K1's kernel with a board axis: the
// grid's y index is the board, each board is one cluster of C CTAs
// (cluster dims stay (C, 1, 1), so distributed shared memory and the
// cluster barrier never cross boards), and its pointers are offset by b
// boards, so each board is its own torus.  This is the serving plane's
// cohort launch: 16 tenants of 512^2 are 16 clusters side by side.
//
// Layout: (H/32, W) words, bit k of word (wy, x) = cell (32*wy + k, x) —
// the JAX package's pack_vertical layout.  Vertical neighbours are an
// in-word shift with a carry from the word row above or below, horizontal
// neighbours the column index +-1 mod W, so both wraps are exact and no
// halo is needed.
//
// K1's design, one part for each factor between the first port's time
// (one 1024-thread block, the board in shared memory, ~60 instructions a
// word-generation, two barriers a generation, one SM of 132) and the work:
// - The loop in registers (regwin.cuh's, transposed).  A word is one cell
//   column's 32 rows, so a thread holds one cell column's run of up to H
//   word rows; the north and south carries come from its own adjacent
//   registers, and the west and east columns are the adjacent lanes.  Each
//   word's 2-bit vertical sum (v0, v1) is computed once and shuffled to
//   both neighbours (4 shuffles a word).
// - Column groups with halo lanes.  A warp's lanes 1..q (q <= 30) are a
//   group of q consecutive columns; lane 0 holds the column west of the
//   group and lane q + 1 the one east of it (halo lanes, refreshed every
//   generation from the groups that own them), so the warp's lane wrap
//   only corrupts the halo lanes' own results, which are discarded.  The
//   board's W columns are evened over G = ceil(W / 30) groups.
// - Sub-runs.  A thread's 32 registers hold V = 32 / H sub-runs of H rows
//   (H = 8 or 2); sub-run u = (run gy, group gx) covers word rows
//   [gy*rh, gy*rh + rh) (rh <= H; the last run may be shorter: the ragged
//   form) of group gx.  Tall boards stack runs over warps, wide flat ones
//   put several groups in one warp, so one design takes every board K1's
//   gate takes.
// - One exchange a generation.  Each sub-run publishes, in its CTA's
//   shared memory (double-buffered by generation parity), its first and
//   last centre columns and two ballots: bit 0 of its first row and bit 31
//   of its last, one bit a lane, each as the step writes the row.  After
//   one barrier each sub-run reads its halo columns and its carries: a
//   centre lane from the runs above and below in its own group, a halo
//   lane from the diagonal runs, which own its column.  A sub-run's neighbours sit anywhere in the cluster: their
//   slots are read through distributed shared memory
//   (cluster.map_shared_rank) and the barrier is cluster.sync().
// - The rule a template argument (regwin.cuh::FixedRule/by_rule): B3/S23
//   and B36/S23 compiled in, AnyRule for the rest; no divide or modulo in
//   the loop (each sub-run's neighbours are a table in shared memory,
//   built once a launch).
// - Spread over the card: the plan (ops/cuda_packed.py::resident_reg_plan)
//   splits the sub-runs over a cluster of C CTAs (C <= 8 portable, 16 with
//   cudaFuncAttributeNonPortableClusterSizeAllowed); all CTAs of a cluster
//   sit on one GPC, so a 512^2 board uses C SMs, not 132.  The launch
//   refuses a cluster the card cannot schedule (cudaOccupancyMaxActiveClusters).
//   K7's plan (resident_batched_plan) prices K1's plan by the waves the
//   stack takes on the card's active clusters (gol_resident_reg_clusters).
//
// What bounds it on an H100: a 512^2 board is 32 KB, so the bytes are
// nothing; the operations (12 a word-generation for B3/S23, 18-20 with the
// shuffles, the halo lanes and the exchange) spread over C SMs, and one
// cluster barrier a generation.  A stack's boards run side by side, as
// many clusters at once as the card holds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "regwin.cuh"

namespace cg = cooperative_groups;

namespace {

// -- K1: the cluster-resident register kernel ---------------------------------

namespace col {

constexpr int kLanes = 32;
constexpr int kWords = 32;      // state registers a thread holds
constexpr int kMaxWarps = 16;   // warps a CTA stacks: 512 threads, up to 128 registers each
constexpr int kMaxCluster = 16;
constexpr int kGroup = 30;      // most centre columns a warp holds
constexpr unsigned kFull = 0xffffffffu;

// A sub-run's table entries (its CTA's shared memory, built once a
// launch): its eight neighbours' slots (rank << 16 | slot within the
// rank), its centre columns q, its west group's q, its rows, its first
// column.
enum { kW, kE, kN, kS, kNW, kNE, kSW, kSE, kQ, kQW, kRows, kC0, kTab };

// The launch's geometry: the board (hw word rows, w columns), G groups,
// `runs` runs of rh rows, vs sub-runs a warp, wpc warps a CTA, and the
// derived counts (nsub sub-runs, spc a CTA).
struct Geom {
    int hw, w, groups, runs, rh, vs, wpc, nsub, spc;
};

// A sub-run's slot: [0, H) its first centre column's rows (read by the
// west group's east halo lane), [H, 2H) its last centre column's, 2H the
// ballot of its first row's bit 0, 2H + 1 that of its last row's bit 31.
template <int H>
__host__ __device__ constexpr int slot_words() {
    return 2 * H + 2;
}

// The slot of sub-run (gy, gx), both taken modulo the grid of sub-runs.
__device__ __forceinline__ int slot_of(const Geom& g, int gy, int gx) {
    const int u = gol::wrap(gy, g.runs) * g.groups + gol::wrap(gx, g.groups);
    return ((u / g.spc) << 16) | (u % g.spc);
}

__device__ __forceinline__ int first_col(const Geom& g, int gx) {
    return gx * g.w / g.groups;
}

// Publish row k (its value `x`) of a sub-run into its slot: lane 1's
// and lane q's words (the first and last centre columns), and the ballot
// of bit 0 of the first row and of bit 31 of the last row (`rows` rows;
// whole runs: H).  Warp-uniform.
template <int H, bool kRagged>
__device__ __forceinline__ void publish_row(uint32_t* slot, int k, uint32_t x, int q, int rows) {
    const int lane = threadIdx.x;
    if (lane == 1) slot[k] = x;
    if (lane == q) slot[H + k] = x;
    if (k == 0) {
        const uint32_t top = __ballot_sync(kFull, x & 1u);
        if (lane == 0) slot[2 * H] = top;
    }
    if (kRagged ? k == rows - 1 : k == H - 1) {
        const uint32_t bot = __ballot_sync(kFull, x >> 31);
        if (lane == 0) slot[2 * H + 1] = bot;
    }
}

// One generation of sub-run j (registers [j*H, j*H + H), `rows` of them
// live), in place: `upw` carries the north neighbour of row 0 in bit 31,
// `dnw` the south neighbour of the last row in bit 0.  Each new row is
// published into `slot`, the sub-run's slot of the next generation's
// buffer.  Warp-uniform.
template <int H, bool kRagged, class Rule>
__device__ __forceinline__ void step(uint32_t (&s)[kWords], int j, uint32_t upw, uint32_t dnw,
                                     int rows, uint32_t* slot, int q, const Rule& rule) {
    const int src_w = (threadIdx.x + kLanes - 1) % kLanes;
    const int src_e = (threadIdx.x + 1) % kLanes;
    uint32_t prev = upw;
#pragma unroll
    for (int k = 0; k < H; ++k) {
        if (kRagged && k >= rows) break;
        const uint32_t a = s[j * H + k];
        uint32_t below = dnw;
        if (k + 1 < H) {
            if (!kRagged || k + 1 < rows) below = s[j * H + k + 1];
        }
        const uint32_t north = __funnelshift_l(prev, a, 1);   // (a << 1) | (prev >> 31)
        const uint32_t south = __funnelshift_r(a, below, 1);  // (a >> 1) | (below << 31)
        const uint32_t v0 = gol::reg::lop3<0x96>(a, north, south);
        const uint32_t v1 = gol::reg::lop3<0xe8>(a, north, south);
        const uint32_t v0w = __shfl_sync(kFull, v0, src_w);
        const uint32_t v0e = __shfl_sync(kFull, v0, src_e);
        const uint32_t v1w = __shfl_sync(kFull, v1, src_w);
        const uint32_t v1e = __shfl_sync(kFull, v1, src_e);
        // The 9-cell total is (v0 + v0w + v0e) + 2 (v1 + v1w + v1e): its
        // low bit, the two half sums of bit 1 and the carry into bit 2.
        const uint32_t x =
            rule(gol::reg::lop3<0x96>(v0, v0w, v0e), gol::reg::lop3<0x96>(v1, v1w, v1e),
                 gol::reg::lop3<0xe8>(v0, v0w, v0e), gol::reg::lop3<0xe8>(v1, v1w, v1e), a);
        s[j * H + k] = x;
        publish_row<H, kRagged>(slot, k, x, q, rows);
        prev = a;
    }
}

__device__ __forceinline__ void barrier(bool clustered) {
    if (clustered) {
        cg::this_cluster().sync();
    } else {
        __syncthreads();
    }
}

// The slot `e` (rank << 16 | slot) in the publication buffer `buf` of
// its CTA (this CTA's `buf` mapped into that rank's shared memory).
template <int H>
__device__ __forceinline__ const uint32_t* slot_at(uint32_t* buf, int e, bool clustered) {
    uint32_t* p = buf + (e & 0xffff) * slot_words<H>();
    return clustered ? cg::this_cluster().map_shared_rank(p, e >> 16) : p;
}

// K1 and K7: `turns` generations of each board of the stack `in` into
// `out`.  blockDim = (32, wpc); the grid is (C, B): board b is the
// cluster of C CTAs at grid row b.  Shared memory: two parities of spc
// slots, then the spc-entry table.
template <int H, bool kRagged, class Rule>
__global__ void __launch_bounds__(kMaxWarps * kLanes, 1)
resident_reg_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, Geom g,
                    int turns, int clustered, Rule rule) {
    constexpr int V = kWords / H;
    constexpr int SW = slot_words<H>();
    extern __shared__ uint32_t smem[];
    uint32_t* pub = smem;
    int* tab = reinterpret_cast<int*>(smem + 2 * g.spc * SW);
    const bool cl = clustered != 0;
    const int rank = cl ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
    const int lane = threadIdx.x;
    const int warp = threadIdx.y;
    for (int lu = warp * kLanes + lane; lu < g.spc; lu += g.wpc * kLanes) {
        const int u = rank * g.spc + lu;
        if (u >= g.nsub) break;
        const int gy = u / g.groups;
        const int gx = u - gy * g.groups;
        int* t = tab + lu * kTab;
        t[kW] = slot_of(g, gy, gx - 1);
        t[kE] = slot_of(g, gy, gx + 1);
        t[kN] = slot_of(g, gy - 1, gx);
        t[kS] = slot_of(g, gy + 1, gx);
        t[kNW] = slot_of(g, gy - 1, gx - 1);
        t[kNE] = slot_of(g, gy - 1, gx + 1);
        t[kSW] = slot_of(g, gy + 1, gx - 1);
        t[kSE] = slot_of(g, gy + 1, gx + 1);
        const int c0 = first_col(g, gx);
        t[kQ] = first_col(g, gx + 1) - c0;
        t[kQW] = gx == 0 ? g.w - first_col(g, g.groups - 1) : c0 - first_col(g, gx - 1);
        t[kRows] = min(g.rh, g.hw - gy * g.rh);
        t[kC0] = c0;
    }
    __syncthreads();
    const int lu0 = warp * g.vs;
    const int u0 = rank * g.spc + lu0;
    // This CTA's board (block_y: nothing of it held through the loop).
    const size_t board = static_cast<size_t>(g.hw) * g.w;
    in += gol::reg::block_y() * board;
    uint32_t s[kWords];
#pragma unroll
    for (int j = 0; j < V; ++j) {
#pragma unroll
        for (int k = 0; k < H; ++k) s[j * H + k] = 0u;
        if (j >= g.vs || u0 + j >= g.nsub) continue;
        const int* t = tab + (lu0 + j) * kTab;
        const int x = gol::wrap(t[kC0] - 1 + lane, g.w);
        const int r0 = (u0 + j) / g.groups * g.rh;
#pragma unroll
        for (int k = 0; k < H; ++k) {
            if (k < t[kRows]) s[j * H + k] = in[static_cast<size_t>(r0 + k) * g.w + x];
        }
    }
    // Generation 0 reads buffer 0: the loaded state, published.
#pragma unroll
    for (int j = 0; j < V; ++j) {
        if (j >= g.vs || u0 + j >= g.nsub) break;
        const int* t = tab + (lu0 + j) * kTab;
#pragma unroll
        for (int k = 0; k < H; ++k) {
            if (kRagged && k >= t[kRows]) break;
            publish_row<H, kRagged>(pub + (lu0 + j) * SW, k, s[j * H + k], t[kQ], t[kRows]);
        }
    }
    for (int gen = 0; gen < turns; ++gen) {
        uint32_t* buf = pub + (gen & 1) * g.spc * SW;
        uint32_t* next = pub + ((gen + 1) & 1) * g.spc * SW;
        barrier(cl);
#pragma unroll
        for (int j = 0; j < V; ++j) {
            if (j >= g.vs || u0 + j >= g.nsub) break;
            const int* t = tab + (lu0 + j) * kTab;
            const int q = t[kQ];
            const int rows = t[kRows];
            // Lane 0 is the west halo, lane q + 1 the east one; a halo
            // lane's carries come from the diagonal runs, which own its
            // column, at that column's lane there.
            const int which = lane == 0 ? 0 : lane == q + 1 ? 1 : 2;
            const int bit = which == 0 ? t[kQW] : which == 1 ? 1 : lane;
            const int up = t[which == 0 ? kNW : which == 1 ? kNE : kN];
            const int dn = t[which == 0 ? kSW : which == 1 ? kSE : kS];
            if (which < 2) {
                const uint32_t* h = slot_at<H>(buf, t[which == 0 ? kW : kE], cl) +
                                    (which == 0 ? H : 0);
#pragma unroll
                for (int k = 0; k < H; ++k) {
                    if (kRagged && k >= rows) break;
                    s[j * H + k] = h[k];
                }
            }
            const uint32_t upw = ((slot_at<H>(buf, up, cl)[2 * H + 1] >> bit) & 1u) << 31;
            const uint32_t dnw = (slot_at<H>(buf, dn, cl)[2 * H] >> bit) & 1u;
            // The next generation's buffer was last read before this
            // generation's barrier, so the step may publish into it.
            step<H, kRagged>(s, j, upw, dnw, rows, next + (lu0 + j) * SW, q, rule);
        }
    }
    // No CTA leaves while another may still read its shared memory.
    barrier(cl);
    out += gol::reg::block_y() * static_cast<size_t>(g.hw) * g.w;
#pragma unroll
    for (int j = 0; j < V; ++j) {
        if (j >= g.vs || u0 + j >= g.nsub) break;
        const int* t = tab + (lu0 + j) * kTab;
        if (lane < 1 || lane > t[kQ]) continue;
        const int r0 = (u0 + j) / g.groups * g.rh;
        const int x = t[kC0] + lane - 1;
#pragma unroll
        for (int k = 0; k < H; ++k) {
            if (k < t[kRows]) out[static_cast<size_t>(r0 + k) * g.w + x] = s[j * H + k];
        }
    }
}

// One request of the host: launch `turns` generations of the nb boards of
// `in` into `out` on `stream`, or (query != nullptr) only store in *query
// how many clusters of the plan the card holds at once.
struct Job {
    const uint32_t* in;
    uint32_t* out;
    int nb, turns;
    int* query;
    cudaStream_t stream;
};

template <int H, bool kRagged, class Rule>
int launch_reg(const Geom& g, int cluster, const Job& job, const Rule& rule) {
    const auto kernel = resident_reg_kernel<H, kRagged, Rule>;
    const size_t smem = sizeof(uint32_t) * (2 * g.spc * slot_words<H>() + g.spc * kTab);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess && cluster > 8) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, job.nb);
    cfg.blockDim = dim3(kLanes, g.wpc);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = job.stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (job.query != nullptr) {
        *job.query = clusters;
        return cudaSuccess;
    }
    if (clusters < 1) return cudaErrorLaunchOutOfResources;  // the card cannot hold it
    err = cudaLaunchKernelEx(&cfg, kernel, job.in, job.out, g, job.turns, cluster > 1 ? 1 : 0,
                             rule);
    return err != cudaSuccess ? err : cudaGetLastError();
}

// Check a plan, build its geometry and serve `job` in its instantiation:
// sub-runs of at most `h_run` (8 or 2) registers, `rh` rows of the board
// each (`ragged`: some run has fewer than h_run rows), `vs` a warp, `wpc`
// warps a CTA, `cluster` CTAs a board; G = ceil(w / 30) column groups.
// `variant` picks the rule's instantiation (regwin.cuh::by_rule).
int serve(int hw, int w, int h_run, int ragged, int rh, int vs, int wpc, int cluster,
          int variant, unsigned born, unsigned surv, const Job& job) {
    if (job.nb < 1 || job.nb > 65535 || hw < 1 || w < kLanes || w % kLanes || rh < 1 ||
        rh > h_run || vs < 1 || vs * h_run > kWords || wpc < 1 || wpc > kMaxWarps ||
        cluster < 1 || cluster > kMaxCluster) {
        return cudaErrorInvalidValue;
    }
    Geom g;
    g.hw = hw;
    g.w = w;
    g.groups = (w + kGroup - 1) / kGroup;
    g.rh = rh;
    g.runs = (hw + rh - 1) / rh;
    g.vs = vs;
    g.wpc = wpc;
    g.nsub = g.groups * g.runs;
    g.spc = wpc * vs;
    // Every CTA holds sub-runs, and together they hold all of them; a
    // plan that says it is not ragged has only whole runs of h_run rows.
    if (static_cast<long long>(cluster) * g.spc < g.nsub || (cluster - 1) * g.spc >= g.nsub ||
        (!ragged && (rh != h_run || hw % rh)) || g.nsub >= (1 << 16) * kMaxCluster) {
        return cudaErrorInvalidValue;
    }
    return gol::reg::by_rule(variant, born, surv, [&](auto rule) {
        switch (h_run * 2 + (ragged ? 1 : 0)) {
            case 16: return launch_reg<8, false>(g, cluster, job, rule);
            case 17: return launch_reg<8, true>(g, cluster, job, rule);
            case 4: return launch_reg<2, false>(g, cluster, job, rule);
            case 5: return launch_reg<2, true>(g, cluster, job, rule);
            default: return static_cast<int>(cudaErrorInvalidValue);
        }
    });
}

}  // namespace col

}  // namespace

// K1 (nb = 1) and K7: `turns` generations of each of the nb boards of
// (hw, w) words stacked contiguously at `in`, into `out`, each board on
// its own cluster of the plan (col::serve's arguments).  The plans are
// ops/cuda_packed.py::resident_reg_plan's and resident_batched_plan's.
extern "C" int gol_resident_reg_launch(const void* in, void* out, int nb, int hw, int w,
                                       int turns, int h_run, int ragged, int rh, int vs, int wpc,
                                       int cluster, int variant, unsigned born, unsigned surv,
                                       void* stream) {
    if (turns < 1) return cudaErrorInvalidValue;
    const col::Job job{static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), nb, turns,
                       nullptr, static_cast<cudaStream_t>(stream)};
    return col::serve(hw, w, h_run, ragged, rh, vs, wpc, cluster, variant, born, surv, job);
}

// How many clusters of a plan (col::serve's arguments) the card holds at
// once (cudaOccupancyMaxActiveClusters), stored in the int at `clusters`:
// the waves of K7's plan.
extern "C" int gol_resident_reg_clusters(void* clusters, int hw, int w, int h_run, int ragged,
                                         int rh, int vs, int wpc, int cluster, int variant,
                                         unsigned born, unsigned surv) {
    const col::Job job{nullptr, nullptr, 1, 1, static_cast<int*>(clusters), nullptr};
    return col::serve(hw, w, h_run, ragged, rh, vs, wpc, cluster, variant, born, surv, job);
}
