// Register-resident windows: the generation loop of K2 and K3 (tiled.cu,
// tiled_skip.cu), K4, K11 and K13 (probing.cu), K9 and K10 (ext.cu) and
// the frontier kernels K5, K8, K12, K14 and K15 (frontier.cu), designed
// for Hopper.  No kernel steps a window in shared memory any longer
// (window.cuh::advance).
//
// Layout (window.cuh's): bit k of a packed word holds cell 32*x + k of its
// row, so a cell's west neighbour is the next lower bit.
//
// A block is `warps` warps stacked vertically (blockDim = (32, warps)).
// Warp w holds window rows [32w, 32w + 32) of one 32-word window column:
// lane l holds word column l, one word a row in registers (`s[kRun]`).
// The window's middle kLanes - 2*border words are the block's centre
// columns; `border` words a side absorb the error of the warp's column
// edge (its lanes wrap: lane 0's west word is lane 31's), which spreads
// one cell a generation, so T <= 32*border generations leave the centre
// exact.  Rows past the window read as zero, as in window.cuh.
//
// One generation, all from registers: a word's west and east neighbour
// words come from the adjacent lanes (__shfl_sync), one funnel shift each
// takes the bit it needs, and the row sums roll down the run as in
// window.cuh::advance.  Only a run's first and last rows cross to the
// neighbouring warps, through shared memory: 2 stores and 2 loads per run
// and generation, one __syncthreads (double-buffered by parity, so one
// barrier orders both the writes and the reads).
//
// The rule is a template argument (FixedRule<born, surv>): its totals
// test folds at compile time, and B3/S23 takes a network of four LOP3s
// after the adder's four, so a word costs the 12 instructions of
// chip_smoke.py::ops_per_word (2 funnel shifts and 10 LOP3s) besides its
// 2 shuffles; AnyRule takes the masks at run time
// (life_rule.cuh::gol_apply_rule) and serves every other rule.
//
// The light cone: only cells within T - g rows of the centre matter at
// generation g (K13: every window row until its probe at generation 6).
// Each run steps only its chunks of kChunk rows that meet that cone; the
// rows it skips keep a stale value that no row of the cone reads later.
#pragma once

#include <cuda_runtime.h>

#include "life_rule.cuh"
#include "window.cuh"

namespace gol {
namespace reg {

constexpr int kLanes = 32;      // word columns of a warp's window
constexpr int kRun = 32;        // window rows a thread holds in registers
constexpr int kChunk = 8;       // rows of the light-cone trimming's unit
constexpr int kMaxWarps = 16;   // warps a block stacks: windows up to 512 rows
constexpr int kMaxThreads = kLanes * kMaxWarps;
constexpr unsigned kFull = 0xffffffffu;

// B3/S23 and B36/S23 as rule masks (cuda_packed.rule_masks): bit k of
// `born` = a dead cell with total k is born, bit k of `surv` = a live cell
// with total k survives.
constexpr uint32_t kConwayBorn = 0x8u, kConwaySurv = 0x18u;
constexpr uint32_t kHighlifeBorn = 0x48u, kHighlifeSurv = 0x18u;

// A 3-input bitwise function as one LOP3: `lut` is its truth table on
// a = 0xf0, b = 0xcc, c = 0xaa.
template <uint32_t kLut>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t out;
    asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(out) : "r"(a), "r"(b), "r"(c), "n"(kLut));
    return out;
}

// The rule at run time: every life-like rule.  Arguments: the total's low
// bit t0, the half sums p1 and cc of bit 1, the carry q, the centre.
struct AnyRule {
    uint32_t born, surv;
    __device__ __forceinline__ uint32_t operator()(uint32_t t0, uint32_t p1, uint32_t cc,
                                                   uint32_t q, uint32_t c) const {
        const uint32_t k = p1 & cc;
        return gol_apply_rule(t0, p1 ^ cc, q ^ k, q & k, c, born, surv);
    }
};

// The rule at compile time.  A total of 8 or 9 has t1 = t2 = 0, so where
// the rule treats 8 as 0 for a dead cell and 9 as 1 for a live one, t3 is
// not needed and the totals test runs on (t0, t1, t2) alone; a live cell
// with total 0 cannot occur, so its minterm takes the total-8 answer.
template <uint32_t kBorn, uint32_t kSurv>
struct FixedRule {
    __device__ __forceinline__ uint32_t operator()(uint32_t t0, uint32_t p1, uint32_t cc,
                                                   uint32_t q, uint32_t c) const {
        if constexpr (kBorn == kConwayBorn && kSurv == kConwaySurv) {
            // Alive next: total 3, or total 4 and alive now, where the total
            // is t0 + 2 (cc + p1) + 4 q.  With q, only cc = p1 = 0 and t0 = 0
            // (total 4) lives; without it, t0 = 1 with one of cc, p1 (3), or
            // t0 = 0 with both (4).  Four LOP3s: y = q ? ~(cc | p1) : cc & p1,
            // z = ~q & (cc ^ p1), v = ~t0 & y & c, then (t0 & z) | v.
            const uint32_t y = lop3<0x42>(cc, p1, q);
            const uint32_t z = lop3<0x14>(cc, p1, q);
            return lop3<0xea>(t0, z, lop3<0x08>(t0, y, c));
        }
        const uint32_t t1 = p1 ^ cc;
        const uint32_t k = p1 & cc;
        const uint32_t t2 = q ^ k;
        if constexpr ((kBorn & 1u) == ((kBorn >> 8) & 1u) &&
                      ((kSurv >> 1) & 1u) == ((kSurv >> 9) & 1u)) {
            uint32_t out = 0u;
#pragma unroll
            for (int n = 0; n < 8; ++n) {
                const bool dead = (kBorn >> n) & 1u;
                const bool live = (kSurv >> (n == 0 ? 8 : n)) & 1u;
                if (!(dead || live)) continue;
                const uint32_t m =
                    ((n & 1) ? t0 : ~t0) & ((n & 2) ? t1 : ~t1) & ((n & 4) ? t2 : ~t2);
                out |= m & (dead ? (live ? 0xffffffffu : ~c) : c);
            }
            return out;
        } else {
            return gol_apply_rule(t0, t1, t2, q & k, c, kBorn, kSurv);
        }
    }
};

using Conway = FixedRule<kConwayBorn, kConwaySurv>;
using Highlife = FixedRule<kHighlifeBorn, kHighlifeSurv>;

// Blocks of kMaxThreads an SM must hold at once (__launch_bounds__'s
// second argument) for a frontier kernel's (K5/K8, K12, K14, K15)
// instantiation: two,
// so 64 registers a thread, for the compiled-in rules; one for AnyRule,
// whose run-time masks and the frontier window's gen-T bookkeeping need
// more than 64 (ptxas spilled them there).
template <class Rule>
struct FrontierBlocks {
    static constexpr int value = 2;
};
template <>
struct FrontierBlocks<AnyRule> {
    static constexpr int value = 1;
};

// Where a block stands: its warp and lane, and the cone's parameters.
// Window rows [0, rows) matter; the centre starts `halo` rows down; the
// launch runs `turns` generations and probes after `probe` (0: none).
struct Run {
    int lane, warp, warps;
    int rows, halo, turns, probe;
    int src_w, src_e;  // the lanes holding this lane's west and east words

    __device__ static Run make(int rows, int halo, int turns, int probe) {
        Run r;
        r.lane = threadIdx.x;
        r.warp = threadIdx.y;
        r.warps = blockDim.y;
        r.rows = rows;
        r.halo = halo;
        r.turns = turns;
        r.probe = probe;
        r.src_w = (r.lane + kLanes - 1) % kLanes;
        r.src_e = (r.lane + 1) % kLanes;
        return r;
    }

    // Window row of this thread's register i.
    __device__ __forceinline__ int row(int i) const { return warp * kRun + i; }

    // This run's rows [lo, hi) to step at generation g, whole chunks: the
    // cone is window rows [d, rows - d), d = g until the probe and
    // halo - turns + g after it.  lo == hi: none.
    __device__ __forceinline__ void live(int g, int& lo, int& hi) const {
        const int d = g <= probe ? g : halo - turns + g;
        const int top = warp * kRun;
        lo = max(d - top, 0);
        hi = min(rows - d - top, kRun);
        if (lo >= hi) {
            lo = hi = 0;
            return;
        }
        lo = lo / kChunk * kChunk;
        hi = min((hi + kChunk - 1) / kChunk * kChunk, kRun);
    }
};

// The 2-bit horizontal sum of word x with its west and east neighbours.
__device__ __forceinline__ void hsum(uint32_t x, const Run& run, uint32_t& h0, uint32_t& h1) {
    const uint32_t w = __shfl_sync(kFull, x, run.src_w);
    const uint32_t e = __shfl_sync(kFull, x, run.src_e);
    const uint32_t west = __funnelshift_l(w, x, 1);  // (x << 1) | (w >> 31)
    const uint32_t east = __funnelshift_r(x, e, 1);  // (x >> 1) | (e << 31)
    h0 = lop3<0x96>(x, west, east);  // x ^ west ^ east
    h1 = lop3<0xe8>(x, west, east);  // their majority
}

// One generation of rows [lo, hi) of the run (whole chunks, lo < hi),
// in place: `up` is the row above the run and `dn` the row below, both at
// the current generation.  The row sums roll down, so each row's sum is
// computed once; a row is overwritten only after the row below has read
// it.  Warp-uniform: every lane takes the same branches.
template <class Rule>
__device__ __forceinline__ void step(uint32_t (&s)[kRun], uint32_t up, uint32_t dn, int lo,
                                     int hi, const Run& run, const Rule& rule) {
    uint32_t n0 = 0u, n1 = 0u, h0 = 0u, h1 = 0u, a = 0u;
#pragma unroll
    for (int c = 0; c < kRun / kChunk; ++c) {
        const int r0 = c * kChunk;
        if (r0 < lo || r0 >= hi) continue;
        if (r0 == lo) {
            hsum(c == 0 ? up : s[(r0 + kRun - 1) % kRun], run, n0, n1);
            a = s[r0];
            hsum(a, run, h0, h1);
        }
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
            const int r = r0 + i;
            const uint32_t below = r + 1 < kRun ? s[(r + 1) % kRun] : dn;
            uint32_t s0, s1;
            hsum(below, run, s0, s1);
            s[r] = rule(lop3<0x96>(h0, n0, s0), lop3<0x96>(h1, n1, s1), lop3<0xe8>(h0, n0, s0),
                        lop3<0xe8>(h1, n1, s1), a);
            n0 = h0;
            n1 = h1;
            h0 = s0;
            h1 = s1;
            a = below;
        }
    }
}

// The exchange of run edges between the block's warps: by generation
// parity, each warp's first and last row.
struct Edges {
    uint32_t row[2][kMaxWarps][2][kLanes];
};

// Generations [from, to] of every run of the block.  Each begins with
// the exchange: every warp publishes its first and last row, one barrier,
// each reads the last row of the warp above and the first of the warp
// below (zero past the window).  Parity double-buffering makes one
// barrier enough: a buffer is written again only two generations later,
// after the barrier that every reader of it has passed.
template <class Rule>
__device__ void advance(uint32_t (&s)[kRun], Edges& edges, const Run& run, int from, int to,
                        const Rule& rule) {
    for (int g = from; g <= to; ++g) {
        auto& e = edges.row[g & 1];
        e[run.warp][0][run.lane] = s[0];
        e[run.warp][1][run.lane] = s[kRun - 1];
        __syncthreads();
        const uint32_t up = run.warp > 0 ? e[run.warp - 1][1][run.lane] : 0u;
        const uint32_t dn = run.warp + 1 < run.warps ? e[run.warp + 1][0][run.lane] : 0u;
        int lo, hi;
        run.live(g, lo, hi);
        if (lo < hi) step(s, up, dn, lo, hi, run, rule);
    }
}

// blockIdx.y, read anew where it is used (the asm is volatile, so the
// compiler neither keeps an earlier read nor what was computed from it):
// values kept from the kernel's start would hold registers through the
// generation loop.
__device__ __forceinline__ int block_y() {
    int y;
    asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(y));
    return y;
}

// blockIdx.x, the same way.
__device__ __forceinline__ int block_x() {
    int x;
    asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(x));
    return x;
}

// blockIdx.z, the same way.
__device__ __forceinline__ int block_z() {
    int z;
    asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(z));
    return z;
}

// Fill the registers: window row i of this run from `load(row)`, zero
// past the window's rows.
template <class Load>
__device__ __forceinline__ void load(uint32_t (&s)[kRun], const Run& run, const Load& from) {
#pragma unroll
    for (int i = 0; i < kRun; ++i) s[i] = run.row(i) < run.rows ? from(run.row(i)) : 0u;
}

// Keep this run's registers in `kept` (warps * kRun * kLanes words of
// shared memory), each thread its own column: the probe's generation-0
// source, read back only by the thread that wrote it.
__device__ __forceinline__ void keep(const uint32_t (&s)[kRun], const Run& run, uint32_t* kept) {
#pragma unroll
    for (int i = 0; i < kRun; ++i) kept[run.row(i) * kLanes + run.lane] = s[i];
}

// The skip proof's test (window.cuh::inner_stable) on this block's
// window, kSkipPeriod generations on: its inner region (rows and cells
// at least kSkipPeriod from its edge; a window is one warp wide, lanes 0
// and 31 its edge words) against `load(row)`, the source it was filled
// from.  The same value in every thread.
template <class Load>
__device__ bool inner_stable(const uint32_t (&s)[kRun], const Run& run, const Load& from) {
    uint32_t mask = 0xffffffffu;
    if (run.lane == 0) mask = 0xffffffc0u;           // cells 0..5 of the window row
    if (run.lane == kLanes - 1) mask = 0x03ffffffu;  // its last six cells
    uint32_t diff = 0u;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
        const int r = run.row(i);
        if (r >= kSkipPeriod && r < run.rows - kSkipPeriod) diff |= (s[i] ^ from(r)) & mask;
    }
    return __syncthreads_or(diff != 0u) == 0;
}

// -- The torus window (K2, K3) ------------------------------------------------
//
// A block of a whole board of h x wp words read in place as the torus:
// its window starts `halo` rows above its tile of `tile_h` board rows and
// `border` words left of its column group of kLanes - 2 * border centre
// words, so window row r of lane l is board row (y0 - halo + r) mod h,
// word (x0 - border + l) mod wp.  A board shorter than the window fills it
// with its periodic cover, and on a board narrower than a warp's window
// the lanes hold it several times over, in a period that is exactly the
// torus: either way the window is a patch of the board's cover, exact but
// for the warp's column edge.  Where the block stands is read anew from
// blockIdx wherever it is needed (block_x/block_y), so no value of it
// holds a register through the generation loop.
struct TorusBlock {
    const uint32_t* __restrict__ in;
    int h, wp, tile_h, border;

    __device__ __forceinline__ int y0() const { return block_y() * tile_h; }
    __device__ __forceinline__ int x0() const { return block_x() * (kLanes - 2 * border); }

    // visit(i, word): the address of this lane's word of window row
    // run.row(i), for every register i.  Rows step down the torus one at a
    // time, wrapping at h (one modulo for the run's first row).
    template <class Visit>
    __device__ __forceinline__ void rows(const Run& run, const Visit& visit) const {
        const uint32_t* col = in + wrap(x0() - border + run.lane, wp);
        int y = wrap(y0() - run.halo + run.row(0), h);
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
            visit(i, col + static_cast<size_t>(y) * wp);
            y = y + 1 == h ? 0 : y + 1;
        }
    }

    // Fill the registers from the board, zero past the window's rows.
    __device__ __forceinline__ void load(uint32_t (&s)[kRun], const Run& run) const {
        rows(run, [&](int i, const uint32_t* word) { s[i] = run.row(i) < run.rows ? *word : 0u; });
    }

    // Store the centre (window rows [halo, halo + tile_h) of the centre
    // lanes) where it lies on the board: rows y0 + r < h (the last tile
    // overhangs) and words gx < wp, so each word is written once.
    __device__ __forceinline__ void store(const uint32_t (&s)[kRun], const Run& run,
                                          uint32_t* __restrict__ out) const {
        const int top = y0();
        const int gx = x0() + run.lane - border;
        const bool centre = run.lane >= border && run.lane < kLanes - border && gx < wp;
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
            const int r = run.row(i) - run.halo;
            if (centre && r >= 0 && r < tile_h && top + r < h) {
                out[static_cast<size_t>(top + r) * wp + gx] = s[i];
            }
        }
    }
};

// -- The frontier window (K5/K8, K12, K14 and K15) ---------------------------------
//
// A frontier block's window is its tile of `tile_h` centre rows with
// T + 6 rows a side (a Run of T + 6 generations whose cone is every row
// but g a side at generation g), and 32 word columns from one left of its
// 30 centre words.  It steps T generations, keeps gen T (reg::keep), steps
// 6 more, measures where gen T + 6 differs from gen T and stores what its
// stripe's route writes (frontier.cu).

// One word column of a window source (window.cuh's BoardSource,
// StripSource or MeshTileSource) as a run reads it: row y's word, for y
// in [-nh, h + nh), from the buffer above the middle one (y < 0), the
// middle one, or the one below (y >= h); `stride` words a row.
struct Column {
    const uint32_t* north;
    const uint32_t* mid;
    const uint32_t* south;
    int h, nh, stride;
    __device__ __forceinline__ uint32_t operator()(int y) const {
        return y < 0    ? north[static_cast<size_t>(nh + y) * stride]
               : y >= h ? south[static_cast<size_t>(y - h) * stride]
                        : mid[static_cast<size_t>(y) * stride];
    }
};

// Word column x (unwrapped) of a whole board, a torus of h rows: rows
// past its edges wrap around the board itself, once (the window's halo
// T + 6 <= h), and x wraps modulo wp.  A stack's board b is the source
// whose `b` points b boards on, so its rows never reach another board.
__device__ __forceinline__ Column column(const BoardSource& src, int x) {
    const uint32_t* c = src.b + wrap(x, src.wp);
    return Column{c, c, c, src.h, src.h, src.wp};
}

// Word column x (unwrapped) of a strip of a row mesh: the strip spans
// the board's width, so x wraps modulo it.
__device__ __forceinline__ Column column(const StripSource& src, int x) {
    const int c = wrap(x, src.wp);
    return Column{src.north + c, src.local + c, src.south + c, src.h, src.n, src.wp};
}

// Word column x (unwrapped, in tile (dy, dx)'s frame) of a 2-D mesh of
// tiles on one torus: x may lie any number of tiles away (a window is 32
// words, a tile may be narrower), rows come from the tile row above, this
// one and the one below.
__device__ __forceinline__ Column column(const MeshTileSource& src, int x) {
    const int sx = x >= 0 ? x / src.wp : -((src.wp - 1 - x) / src.wp);  // floor(x / wp)
    const int tx = wrap(src.dx + sx, src.nx);
    const int c = x - sx * src.wp;
    const auto tile = [&](int sy) { return src.tab[wrap(src.dy + sy, src.ny) * src.nx + tx] + c; };
    return Column{tile(-1), tile(0), tile(1), src.h, src.h, src.wp};
}

// Whether this lane holds one of the block's centre words (lanes 1..30,
// inside the board's wp words), and its word column gx.
__device__ __forceinline__ bool centre_lane(const Run& run, int x0, int wp, int& gx) {
    gx = x0 - 1 + run.lane;
    return run.lane >= 1 && run.lane < kLanes - 1 && gx < wp;
}

// Launch one of the three instantiations of `Kernel<Rule>` as `variant`
// (0 any rule, 1 B3/S23, 2 B36/S23) says, after checking that the masks
// are that rule's; `launch(kernel, rule)` launches it.
template <class Launch>
int by_rule(int variant, uint32_t born, uint32_t surv, const Launch& launch) {
    switch (variant) {
        case 0:
            return launch(AnyRule{born, surv});
        case 1:
            if (born != kConwayBorn || surv != kConwaySurv) return cudaErrorInvalidValue;
            return launch(Conway{});
        case 2:
            if (born != kHighlifeBorn || surv != kHighlifeSurv) return cudaErrorInvalidValue;
            return launch(Highlife{});
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace reg
}  // namespace gol
