// The frontier kernels: K5 and K8 (gol_frontier_batched_launch), K12
// (gol_strip_frontier_launch), K14 (gol_strip_mega_launch) and K15
// (gol_tile_mega_launch).  Each replaces a Pallas kernel of the JAX
// package that runs the tracked-interval skip/compute/measure state
// machine of a skip_stable dispatch, and each steps its windows in
// registers (regwin.cuh's frontier window, below).
//
// K5: replaces distributed_gol_tpu/ops/pallas_packed.py::
// _kernel_frontier_mega (its decisions _hit_union, its measure _measure2),
// the kernel _run_tiled runs for whole chunks of launches.  The TPU kernel
// runs a chunk of launches as one pallas_call with the per-stripe state
// in SMEM.  Here one launch (T generations, T a multiple of 6,
// T + 6 <= 30) is two CUDA kernels chained on the stream, and the state
// lives in device memory, so there is no host round trip between
// launches:
//
//   state  int32[2][5][grid]: per launch parity, the two tracked row
//          intervals of each stripe (lo0, hi0, lo1, hi1; empty = (2^30, -1),
//          board rows, inside the stripe) and whether the stripe computed;
//   rowflag int32[H]: rows whose gen-(T+6) state differs from gen T,
//          inside each stripe's measure region — zero between launches;
//   skipped int32[1], act int32[grid]: the skip count and the per-stripe
//          activity, accumulated over the chunk.
//
// frontier_reg_kernel, one block per (row tile of a stripe, column group
// of 30 words):
// - reads the neighbour stripes' intervals from the previous parity,
//   placed in this stripe's row frame across the torus wrap, and decides
//   `hit` and the clamped union exactly as _hit_union does, with the JAX
//   kernel's reach pad_f = round8(T + 6); launch 0 of a chunk forces hit
//   and the maximal union;
// - a stripe that does not hit counts one skip, and copies its centre from
//   the read buffer to the write buffer if it computed last launch (the
//   write buffer holds the state of two launches ago; a stripe that also
//   skipped last launch has nothing to do);
// - a stripe that hits loads its window (T + 6 rows a side, rows wrapping
//   around the board: reg::column of a BoardSource), steps T generations,
//   writes the gen-T centre, steps 6 more and flags the rows of its
//   measure region (the JAX m_lo..m_hi, in the centre) where gen T + 6
//   differs from gen T.  The TPU kernel's row, column and rectangle tiers
//   only narrow what it computes; cells in their validity regions are the
//   true state, so computing the whole window gives the same board and
//   the same measure.
// frontier_finalize, one block per stripe: turns the stripe's row flags
// into the two intervals of _measure2 (split at the midpoint of the
// stripe-wide span), counts the stripe active when the first is nonempty,
// and clears the flags.
//
// K8: the same kernel on a contiguous stack of B same-shape boards, the
// nboards > 1 form of _kernel_frontier_mega (its leading grid axis over
// boards stacked along the row axis, driven by _run_tiled_batched),
// blockIdx.z the board.  Every array gains the board axis, indexed
// board-globally as the JAX kernel's gi = b * grid + i: state
// int32[2][5][B * grid], rowflag int32[B * H], skipped int32[B] (one count
// per board), act int32[B * grid].  Each board is its own torus: block
// (., ., b) reads board b's words (its column wraps within the board), its
// neighbour stripes i +- 1 mod grid and its interval placement across the
// wrap all stay inside board b; a dead board beside a live one is never
// read.  K5 is this kernel with B = 1.
//
// K12: the frontier strip launch.  Replaces
// distributed_gol_tpu/parallel/pallas_halo.py::_ext_kernel_frontier, the
// launch a skip_stable dispatch on a row mesh runs for every full launch
// where the strip has a frontier plan.  K5 on one strip, state in the
// strip's row frame: stripes 0 and grid - 1 take their outer neighbours'
// intervals from an extended array that the exchange fills from the
// neighbour strips' edge stripes (shifted by -/+ h_loc, so nothing wraps
// inside the strip); a window's rows outside the strip come from the
// north and south buffers (window.cuh::StripSource); the first launch of
// a dispatch starts from full intervals, as the JAX make_superstep does.
// Like K5 it keeps no column interval: the JAX kernel's (cl, ch) only
// narrows its column tier, and neither the skip decision nor the activity
// reads it.
//
// K14: the strip megakernel.  Replaces
// distributed_gol_tpu/parallel/pallas_halo.py::_kernel_frontier_mega_strip,
// the in-kernel exchange tier of a skip_stable dispatch on a row mesh: on
// a TPU one pallas_call per device runs a chunk of launches, shipping
// round8(T + 6) boundary rows and its edge stripes' intervals to both
// y-neighbours between launches by remote DMA.  Here every strip of the
// mesh lies on this card, so a launch is one CUDA launch over every strip
// (blockIdx.z the strip) and the exchange happens inside it: a window's
// rows past its strip's edge are read straight from the neighbour strip's
// read buffer (window.cuh::StripSource, north and south the neighbours'
// whole buffers), and an edge stripe takes its outer neighbour's
// intervals from the neighbour strip's entries of the one shared state
// array, shifted by -/+ h_loc into its own row frame (MeshIntervals).
// Stream order between the chained launches stands in for the TPU
// kernel's semaphores and entry barrier, the two write buffers for its
// parity slots.  Device tables give each strip's read and write buffer;
// every array gains the strip axis as K8's gains the board axis (state
// int32[2][5][ny * grid], rowflag int32[ny * h_loc], skipped int32[ny],
// act int32[ny * grid]), so K8's finalize serves unchanged.  With ny = 1
// the strip is its own neighbour: the JAX package's loopback build.
//
// K15: the 2-D megakernel.  Replaces
// distributed_gol_tpu/parallel/pallas_halo.py::_kernel_frontier_mega_2d,
// the in-kernel exchange tier of a skip_stable dispatch on an (ny, nx)
// mesh, whose TPU form ships N/S rows, E/W word columns, four corner
// blocks and both x-neighbours' interval state over ten remote-DMA
// channels every launch.  Here every tile lies on this card: one CUDA
// launch covers every tile (blockIdx.z = dy * nx + dx), a window reads
// whatever it needs past its tile's edges straight from the neighbour
// tiles' read buffers, corners included (window.cuh::MeshTileSource), and
// a stripe decides from nine tracked states in the shared state array
// (TorusTileIntervals: its own stripes i - 1..i + 1 and those of the W and
// E tiles).  The arrays gain the tile axis as K14's gain the strip axis,
// so K8's finalize serves unchanged.
//
// The JAX kernel forces a tile's first and last stripes to compute every
// launch, since its y-neighbours' interval state never crosses the wire.
// Here that state lies in the same array, so an edge stripe also decides:
// its neighbours past the tile's edge are the N (or S) tile row's edge
// stripes, moved into its row frame, which makes its nine the 3x3-tile
// neighbourhood.  An edge stripe that hits computes with the maximal
// measure region, as the JAX kernel's forced one; one that does not is
// proved stable, so its gen-T and gen-(T + 6) rows equal its input and the
// JAX kernel's measure of it is empty: it computes nothing, writes empty
// intervals (its rows stay unflagged) and, to keep the skip count, the
// activity and the state the JAX kernel's, counts as computed (it copies
// its centre as a stripe that computed last launch must).  Launch 0 of a
// chunk still forces every stripe.  K14 never forced its edge stripes, so
// it has no such elision.
//
// The window (regwin.cuh): a block is `warps` warps over a tile of
// `tile_h` rows of one stripe (a divisor of it) with T + 6 rows a side,
// and one 32-word column group whose middle 30 words are its centre
// (T + 6 <= 30 < 32: one border word a side holds the lanes' wrap error,
// and a board narrower than 30 words wraps inside the group, its copies
// past wp never stored or measured).  It steps T generations, stores its
// gen-T centre and keeps it in shared memory, steps 6 more and flags its
// measure rows; each run steps only the chunks of the light cone of
// generation T + 6 on the centre.  The plan
// (ops/cuda_adaptive.py::frontier_blocks: frontier_reg_plan on every
// shard's rows stacked) picks the block height.  What bounds a launch:
// integer operations on the stripes that hit (T + 6 generations of their
// words); on a settled board, the decisions of the many blocks that do
// not compute and the few stripes that do.

#include "regwin.cuh"
#include "window.cuh"

namespace {

using namespace gol;

constexpr int kEmpty = 1 << 30;  // pallas_packed._EMPTY_LO
constexpr int kFields = 5;       // lo0, hi0, lo1, hi1, computed

// Stripe i's neighbourhood on a whole board: the previous launch's
// intervals of stripes i - 1, i and i + 1 (modulo grid), placed in stripe
// i's row frame across the torus wrap.
//
// Each neighbourhood lists kSize stripes; get(n, k, ...) gives interval k
// (0 or 1) of its stripe n, placed in stripe i's row frame.
struct TorusIntervals {
    static constexpr int kSize = 3;
    const int* prev;  // the previous parity's state of this board
    int total, grid, stripe_h, i;
    __device__ void get(int n, int k, int& lo, int& hi) const {
        const int slot = n - 1;
        const int j = wrap(i + slot, grid);
        const int off = (i + slot - j) * stripe_h;
        lo = prev[(2 * k) * total + j] + off;
        hi = prev[(2 * k + 1) * total + j] + off;
    }
};

// Stripe i's neighbourhood on a strip of a row mesh (K12): an extended
// array of grid + 2 entries per field, the neighbour strips' edge stripes
// at both ends, already placed in this strip's row frame by the exchange.
struct StripIntervals {
    static constexpr int kSize = 3;
    const int* ext;  // int32[4][grid + 2]: lo0, hi0, lo1, hi1
    int stride, i;   // stride = grid + 2
    __device__ void get(int n, int k, int& lo, int& hi) const {
        lo = ext[(2 * k) * stride + i + n];
        hi = ext[(2 * k + 1) * stride + i + n];
    }
};

// Stripe i of strip s of a row mesh whose strips share one state array
// (K14): a neighbour past the strip's edge is the last stripe of strip
// s - 1 or the first of strip s + 1 (modulo ny), whose intervals, in
// that strip's row frame, move by -/+ h_loc into strip s's.  An empty
// interval stays empty: both ends move together.
struct MeshIntervals {
    static constexpr int kSize = 3;
    const int* prev;  // the previous parity's state of every strip
    int total, grid, ny, h_loc, s, i;
    __device__ void get(int n, int k, int& lo, int& hi) const {
        int j = i + n - 1;
        int t = s;
        int off = 0;
        if (j < 0) {
            j = grid - 1;
            t = wrap(s - 1, ny);
            off = -h_loc;
        } else if (j >= grid) {
            j = 0;
            t = wrap(s + 1, ny);
            off = h_loc;
        }
        lo = prev[(2 * k) * total + t * grid + j] + off;
        hi = prev[(2 * k + 1) * total + t * grid + j] + off;
    }
};

// Stripe i of tile (dy, dx) of a 2-D mesh whose tiles share one state
// array (K15): its own stripes i - 1, i and i + 1 and the same three of
// the W and E tiles (modulo nx), whose row frames are this tile's; a
// neighbour past the tile's edge is the last stripe of the tile row above
// or the first of the row below (modulo ny), moved by -/+ h into this
// tile's frame as MeshIntervals moves a strip's.  An interior stripe's
// nine are _kernel_frontier_mega_2d's; an edge stripe's are its 3x3-tile
// neighbourhood.
struct TorusTileIntervals {
    static constexpr int kSize = 9;
    const int* prev;  // the previous parity's state of every tile
    int total, grid, ny, nx, h, dy, dx, i;
    __device__ void get(int n, int k, int& lo, int& hi) const {
        const int tx = wrap(dx + n / 3 - 1, nx);  // W, own, E
        int j = i + n % 3 - 1;
        int ty = dy;
        int off = 0;
        if (j < 0) {
            j = grid - 1;
            ty = wrap(dy - 1, ny);
            off = -h;
        } else if (j >= grid) {
            j = 0;
            ty = wrap(dy + 1, ny);
            off = h;
        }
        const int at = (ty * nx + tx) * grid + j;
        lo = prev[(2 * k) * total + at] + off;
        hi = prev[(2 * k + 1) * total + at] + off;
    }
};

// _hit_union for stripe rows [c_lo, c_hi] over the neighbourhood `iv`, by
// one thread: `decision` gets hit and the measure rows [lo, hi]; `first`
// forces hit and the maximal union (launch 0 of a chunk).
template <class Intervals>
__device__ void decide(int* decision, const Intervals& iv, int c_lo, int c_hi, int t6,
                       int pad_f, int first) {
    int hit = first;
    int u_lo = c_lo - t6;
    int u_hi = c_hi + t6;
    if (!first) {
        const int w_lo = c_lo - pad_f;
        const int w_hi = c_hi + pad_f;
        u_lo = kEmpty;
        u_hi = -kEmpty;
        for (int n = 0; n < Intervals::kSize; ++n) {
            for (int k = 0; k < 2; ++k) {
                int lo, hi;
                iv.get(n, k, lo, hi);
                if (lo > hi) continue;
                if (lo - kSkipPeriod <= w_hi && hi + kSkipPeriod >= w_lo) hit = 1;
                const int clo = max(lo, c_lo - t6);
                const int chi = min(hi, c_hi + t6);
                if (clo <= chi) {
                    u_lo = min(u_lo, clo);
                    u_hi = max(u_hi, chi);
                }
            }
        }
    }
    decision[0] = hit;
    decision[1] = max(u_lo - t6, c_lo);
    decision[2] = min(u_hi + t6, c_hi);
}

// A frontier block on the register-resident window after its stripe's
// decision (decision[0]: 0 skip, 1 compute, 2 an edge stripe proved
// stable, K15: counted computed, not computed).  The leader (one thread
// of the stripe) keeps the skip count and the computed flag `*computed`;
// a block that does not compute copies its centre from `rd` to `wr` if
// the stripe computed last launch.  Whether the block computes.
__device__ bool reg_begin(const int* decision, bool leader, int* skipped, int* computed,
                          int computed_before, const uint32_t* __restrict__ rd,
                          uint32_t* __restrict__ wr, int wp, int y0, int x0, int tile_h) {
    const int d = decision[0];
    if (leader) {
        if (d == 0) atomicAdd(skipped, 1);
        *computed = d != 0;
    }
    if (d == 1) return true;
    if (computed_before) reg::copy_centre(rd, wr, wp, y0, x0, tile_h);
    return false;
}

// The window's rows and generations: a tile of `tile_h` rows with
// T + 6 rows a side, stepped T + 6 generations, its cone every row but g
// a side at generation g.
__device__ __forceinline__ reg::Run reg_run(int turns, int tile_h) {
    const int halo = turns + kSkipPeriod;
    return reg::Run::make(tile_h + 2 * halo, halo, halo, 0);
}

// The block's T + 6 generations after its load: T, the gen-T centre kept
// (reg::keep) and stored by `store(s)`, 6 more, then `measure(s)`.  The
// two callbacks find the block's place anew (reg::block_x, ...), so that
// nothing computed before the loops holds a register through them.
template <class Rule, class Store, class Measure>
__device__ __forceinline__ void reg_steps(uint32_t (&s)[reg::kRun], reg::Edges& edges,
                                          uint32_t* kept, const reg::Run& run, int turns,
                                          const Rule& rule, const Store& store,
                                          const Measure& measure) {
    reg::advance(s, edges, run, 1, turns, rule);
    reg::keep(s, run, kept);
    store(s);
    reg::advance(s, edges, run, turns + 1, turns + kSkipPeriod, rule);
    measure(s);
}

// K5 and K8: one frontier launch over a contiguous stack of boards of
// (h, wp) words, blockIdx.z the board, blockIdx.y the row tile of a
// stripe and blockIdx.x the column group of 30 words.  Board b's stripes
// keep their state at b * grid + i; `first` forces every stripe to hit
// with the maximal union (launch 0 of a chunk).  The window's rows wrap
// around board b alone (reg::column of a BoardSource; the halo <= h).
template <class Rule>
__global__ void __launch_bounds__(reg::kMaxThreads, reg::FrontierBlocks<Rule>::value)
frontier_reg_kernel(const uint32_t* __restrict__ rd, uint32_t* __restrict__ wr,
                    int* __restrict__ state, int* __restrict__ rowflag, int* __restrict__ skipped,
                    int h, int wp, int turns, int stripe_h, int tile_h, int pad_f, int parity,
                    int first, Rule rule) {
    __shared__ reg::Edges edges;
    __shared__ int decision[3];  // 0 skip / 1 compute, measure rows lo, hi
    extern __shared__ uint32_t kept[];  // the window at gen T (reg::keep)
    const int grid = h / stripe_h;
    const int board = blockIdx.z;
    const int total = gridDim.z * grid;
    const size_t words = static_cast<size_t>(h) * wp;
    const uint32_t* b = rd + board * words;
    const int y0 = blockIdx.y * tile_h;
    const int x0 = blockIdx.x * (reg::kLanes - 2);
    const int i = y0 / stripe_h;
    const int c_lo = i * stripe_h;
    const int* prev = state + (1 - parity) * kFields * total + board * grid;
    int* cur = state + parity * kFields * total + board * grid;
    const bool lead = threadIdx.x == 0 && threadIdx.y == 0;
    if (lead) {
        decide(decision, TorusIntervals{prev, total, grid, stripe_h, i}, c_lo,
               c_lo + stripe_h - 1, turns + kSkipPeriod, pad_f, first);
    }
    __syncthreads();
    if (!reg_begin(decision, lead && blockIdx.x == 0 && y0 == c_lo, skipped + board,
                   &cur[4 * total + i], prev[4 * total + i], b, wr + board * words, wp, y0, x0,
                   tile_h)) {
        return;
    }
    const reg::Run run = reg_run(turns, tile_h);
    uint32_t s[reg::kRun];
    const reg::Column col = reg::column(BoardSource{b, h, wp}, x0 - 1 + run.lane);
    const int top = y0 - run.halo;
    reg::load(s, run, [&](int r) { return col(top + r); });
    const int lanes = reg::kLanes - 2;
    reg_steps(
        s, edges, kept, run, turns, rule,
        [&](const uint32_t(&v)[reg::kRun]) {
            reg::store_centre(v, run, wr + static_cast<size_t>(reg::block_z()) * h * wp, wp,
                              reg::block_y() * tile_h, reg::block_x() * lanes, tile_h);
        },
        [&](const uint32_t(&v)[reg::kRun]) {
            reg::flag_changed(v, run, kept, rowflag + static_cast<size_t>(reg::block_z()) * h, wp,
                              reg::block_y() * tile_h, reg::block_x() * lanes, tile_h,
                              decision[1], decision[2]);
        });
}

// K12: one frontier launch on one strip of a row mesh, one block per
// (row tile of a stripe, column group of 30 words).  `prev_ext` holds the
// previous launch's row intervals of this strip's stripes with the
// neighbour strips' edge stripes at both ends (int32[4][grid + 2], in this
// strip's row frame), `prev_computed` its computed flags (int32[grid]);
// `cur` (int32[5][grid]) gets this launch's.  The window's rows outside
// the strip come from `north` and `south` (n rows each).
template <class Rule>
__global__ void __launch_bounds__(reg::kMaxThreads, reg::FrontierBlocks<Rule>::value)
strip_frontier_reg_kernel(const uint32_t* __restrict__ local, const uint32_t* __restrict__ north,
                          const uint32_t* __restrict__ south, uint32_t* __restrict__ wr,
                          const int* __restrict__ prev_ext, const int* __restrict__ prev_computed,
                          int* __restrict__ cur, int* __restrict__ rowflag,
                          int* __restrict__ skipped, int h, int wp, int n, int turns,
                          int stripe_h, int tile_h, int pad_f, Rule rule) {
    __shared__ reg::Edges edges;
    __shared__ int decision[3];  // 0 skip / 1 compute, measure rows lo, hi
    extern __shared__ uint32_t kept[];  // the window at gen T (reg::keep)
    const int grid = h / stripe_h;
    const int y0 = blockIdx.y * tile_h;
    const int x0 = blockIdx.x * (reg::kLanes - 2);
    const int i = y0 / stripe_h;
    const int c_lo = i * stripe_h;
    const bool lead = threadIdx.x == 0 && threadIdx.y == 0;
    if (lead) {
        decide(decision, StripIntervals{prev_ext, grid + 2, i}, c_lo, c_lo + stripe_h - 1,
               turns + kSkipPeriod, pad_f, 0);
    }
    __syncthreads();
    if (!reg_begin(decision, lead && blockIdx.x == 0 && y0 == c_lo, skipped, &cur[4 * grid + i],
                   prev_computed[i], local, wr, wp, y0, x0, tile_h)) {
        return;
    }
    const reg::Run run = reg_run(turns, tile_h);
    uint32_t s[reg::kRun];
    const reg::Column col =
        reg::column(StripSource{local, north, south, h, wp, n}, x0 - 1 + run.lane);
    const int top = y0 - run.halo;
    reg::load(s, run, [&](int r) { return col(top + r); });
    const int lanes = reg::kLanes - 2;
    reg_steps(
        s, edges, kept, run, turns, rule,
        [&](const uint32_t(&v)[reg::kRun]) {
            reg::store_centre(v, run, wr, wp, reg::block_y() * tile_h, reg::block_x() * lanes,
                              tile_h);
        },
        [&](const uint32_t(&v)[reg::kRun]) {
            reg::flag_changed(v, run, kept, rowflag, wp, reg::block_y() * tile_h,
                              reg::block_x() * lanes, tile_h, decision[1], decision[2]);
        });
}

// K14: one launch over every strip of a row mesh, blockIdx.z the strip,
// blockIdx.y the row tile of a stripe and blockIdx.x the column group of
// 30 words.  `rd_tab` and `wr_tab` (ny entries each) give the strips'
// read and write buffers; the window's rows past strip s's edge come from
// the read buffers of strips s - 1 and s + 1 (reg::column of a
// StripSource whose north and south are those whole buffers; the halo
// <= h).  `first` forces every stripe to hit with the maximal union
// (launch 0 of a chunk).
template <class Rule>
__global__ void __launch_bounds__(reg::kMaxThreads, reg::FrontierBlocks<Rule>::value)
strip_mega_reg_kernel(const uint32_t* const* __restrict__ rd_tab,
                      uint32_t* const* __restrict__ wr_tab, int* __restrict__ state,
                      int* __restrict__ rowflag, int* __restrict__ skipped, int ny, int h, int wp,
                      int turns, int stripe_h, int tile_h, int pad_f, int parity, int first,
                      Rule rule) {
    __shared__ reg::Edges edges;
    __shared__ int decision[3];  // 0 skip / 1 compute, measure rows lo, hi
    extern __shared__ uint32_t kept[];  // the window at gen T (reg::keep)
    const int grid = h / stripe_h;
    const int strip = blockIdx.z;
    const int total = ny * grid;
    const int y0 = blockIdx.y * tile_h;
    const int x0 = blockIdx.x * (reg::kLanes - 2);
    const int i = y0 / stripe_h;
    const int c_lo = i * stripe_h;
    const int* prev = state + (1 - parity) * kFields * total;
    int* cur = state + parity * kFields * total;
    const int gi = strip * grid + i;
    const bool lead = threadIdx.x == 0 && threadIdx.y == 0;
    if (lead) {
        decide(decision, MeshIntervals{prev, total, grid, ny, h, strip, i}, c_lo,
               c_lo + stripe_h - 1, turns + kSkipPeriod, pad_f, first);
    }
    __syncthreads();
    if (!reg_begin(decision, lead && blockIdx.x == 0 && y0 == c_lo, skipped + strip,
                   &cur[4 * total + gi], prev[4 * total + gi], rd_tab[strip], wr_tab[strip], wp,
                   y0, x0, tile_h)) {
        return;
    }
    const reg::Run run = reg_run(turns, tile_h);
    uint32_t s[reg::kRun];
    const reg::Column col = reg::column(
        StripSource{rd_tab[strip], rd_tab[wrap(strip - 1, ny)], rd_tab[wrap(strip + 1, ny)], h,
                    wp, h},
        x0 - 1 + run.lane);
    const int top = y0 - run.halo;
    reg::load(s, run, [&](int r) { return col(top + r); });
    const int lanes = reg::kLanes - 2;
    reg_steps(
        s, edges, kept, run, turns, rule,
        [&](const uint32_t(&v)[reg::kRun]) {
            reg::store_centre(v, run, wr_tab[reg::block_z()], wp, reg::block_y() * tile_h,
                              reg::block_x() * lanes, tile_h);
        },
        [&](const uint32_t(&v)[reg::kRun]) {
            reg::flag_changed(v, run, kept, rowflag + static_cast<size_t>(reg::block_z()) * h, wp,
                              reg::block_y() * tile_h, reg::block_x() * lanes, tile_h,
                              decision[1], decision[2]);
        });
}

// K15: one launch over every tile of a 2-D mesh, blockIdx.z = dy * nx +
// dx, blockIdx.y the row tile of a stripe and blockIdx.x the column group
// of 30 words.  `rd_tab` and `wr_tab` (ny * nx entries each, row-major)
// give the tiles' read and write buffers; the window's rows and words past
// tile (dy, dx)'s edges come from the neighbour tiles' read buffers
// (reg::column of a MeshTileSource; the halo <= h).  `first` forces every
// stripe to hit with the maximal union (launch 0 of a chunk); otherwise
// an edge stripe computes with the maximal union if its 3x3-tile
// neighbourhood hits, and is elided if not.
template <class Rule>
__global__ void __launch_bounds__(reg::kMaxThreads, reg::FrontierBlocks<Rule>::value)
tile_mega_reg_kernel(const uint32_t* const* __restrict__ rd_tab,
                     uint32_t* const* __restrict__ wr_tab, int* __restrict__ state,
                     int* __restrict__ rowflag, int* __restrict__ skipped, int ny, int nx, int h,
                     int wp, int turns, int stripe_h, int tile_h, int pad_f, int parity, int first,
                     Rule rule) {
    __shared__ reg::Edges edges;
    __shared__ int decision[3];  // 0 skip / 1 compute / 2 elided, measure rows lo, hi
    extern __shared__ uint32_t kept[];  // the window at gen T (reg::keep)
    const int grid = h / stripe_h;
    const int v = blockIdx.z;
    const int dy = v / nx;
    const int dx = v - dy * nx;
    const int total = ny * nx * grid;
    const int y0 = blockIdx.y * tile_h;
    const int x0 = blockIdx.x * (reg::kLanes - 2);
    const int i = y0 / stripe_h;
    const int c_lo = i * stripe_h;
    const int* prev = state + (1 - parity) * kFields * total;
    int* cur = state + parity * kFields * total;
    const int gi = v * grid + i;
    const bool lead = threadIdx.x == 0 && threadIdx.y == 0;
    if (lead) {
        const int c_hi = c_lo + stripe_h - 1;
        decide(decision, TorusTileIntervals{prev, total, grid, ny, nx, h, dy, dx, i}, c_lo, c_hi,
               turns + kSkipPeriod, pad_f, first);
        if (!first && (i == 0 || i == grid - 1)) {
            if (decision[0]) {
                decision[1] = c_lo;
                decision[2] = c_hi;
            } else {
                decision[0] = 2;
            }
        }
    }
    __syncthreads();
    if (!reg_begin(decision, lead && blockIdx.x == 0 && y0 == c_lo, skipped + v,
                   &cur[4 * total + gi], prev[4 * total + gi], rd_tab[v], wr_tab[v], wp, y0, x0,
                   tile_h)) {
        return;
    }
    const reg::Run run = reg_run(turns, tile_h);
    uint32_t s[reg::kRun];
    const reg::Column col =
        reg::column(MeshTileSource{rd_tab, ny, nx, dy, dx, h, wp}, x0 - 1 + run.lane);
    const int top = y0 - run.halo;
    reg::load(s, run, [&](int r) { return col(top + r); });
    const int lanes = reg::kLanes - 2;
    reg_steps(
        s, edges, kept, run, turns, rule,
        [&](const uint32_t(&w)[reg::kRun]) {
            reg::store_centre(w, run, wr_tab[reg::block_z()], wp, reg::block_y() * tile_h,
                              reg::block_x() * lanes, tile_h);
        },
        [&](const uint32_t(&w)[reg::kRun]) {
            reg::flag_changed(w, run, kept, rowflag + static_cast<size_t>(reg::block_z()) * h, wp,
                              reg::block_y() * tile_h, reg::block_x() * lanes, tile_h,
                              decision[1], decision[2]);
        });
}

// One block per stripe of every board: block gi = b * grid + i.
__global__ void frontier_finalize(int* __restrict__ state, int* __restrict__ rowflag,
                                  int* __restrict__ act, int h, int stripe_h, int grid,
                                  int parity) {
    __shared__ int lo, hi, hi0, lo1;
    const int gi = blockIdx.x;
    const int total = gridDim.x;
    const int c_lo = (gi % grid) * stripe_h;  // board rows of board gi / grid
    rowflag += static_cast<size_t>(gi / grid) * h;
    int* cur = state + parity * kFields * total;
    if (threadIdx.x == 0) {
        lo = kEmpty;
        hi = -kEmpty;
        hi0 = -kEmpty;
        lo1 = kEmpty;
    }
    __syncthreads();
    for (int r = c_lo + threadIdx.x; r < c_lo + stripe_h; r += blockDim.x) {
        if (rowflag[r]) {
            atomicMin(&lo, r);
            atomicMax(&hi, r);
        }
    }
    __syncthreads();
    if (lo > hi) {
        if (threadIdx.x == 0) {
            cur[0 * total + gi] = kEmpty;
            cur[1 * total + gi] = -1;
            cur[2 * total + gi] = kEmpty;
            cur[3 * total + gi] = -1;
        }
        return;
    }
    const int split = (lo + hi) / 2;  // both >= 0: the floor of _measure2
    for (int r = c_lo + threadIdx.x; r < c_lo + stripe_h; r += blockDim.x) {
        if (rowflag[r]) {
            if (r <= split) {
                atomicMax(&hi0, r);
            } else {
                atomicMin(&lo1, r);
            }
            rowflag[r] = 0;
        }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        const bool one = lo1 > hi;  // nothing above the split
        cur[0 * total + gi] = lo;
        cur[1 * total + gi] = one ? hi : hi0;
        cur[2 * total + gi] = one ? kEmpty : lo1;
        cur[3 * total + gi] = one ? -1 : hi;
        act[gi] += 1;
    }
}

// The checks every register-resident frontier launch shares: a launch
// of T (a multiple of 6) + 6 <= 30 generations, whole stripes of whole
// row tiles, `warps` warps holding a tile's window (tile_h + 2 (T + 6)
// rows), and a decision reach pad_f >= T + 6.
bool bad_reg_frontier(int h, int wp, int turns, int stripe_h, int tile_h, int warps, int pad_f) {
    const int halo = turns + kSkipPeriod;
    return h < 1 || wp < 1 || turns < kSkipPeriod || turns % kSkipPeriod ||
           halo > reg::kLanes - 2 || stripe_h < 1 || h % stripe_h || tile_h < 1 ||
           stripe_h % tile_h || warps < 1 || warps > reg::kMaxWarps ||
           warps * reg::kRun < tile_h + 2 * halo || pad_f < halo;
}

// The blocks of a frontier launch over n shards of (h, wp) words: column
// groups of 30 words, row tiles of tile_h rows, blockIdx.z the shard.
dim3 reg_grid(int wp, int h, int tile_h, int n) {
    return dim3((wp + reg::kLanes - 3) / (reg::kLanes - 2), h / tile_h, n);
}

// Launch a register-resident frontier kernel's instantiation `kernel` on
// `grid` blocks of `warps` warps, with its reg::keep buffer allowed.
template <typename Kernel, typename... Args>
int launch_reg(Kernel kernel, dim3 grid, int warps, cudaStream_t stream, Args... args) {
    const long long smem = 4LL * warps * reg::kRun * reg::kLanes;  // reg::keep's words
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, dim3(reg::kLanes, warps), static_cast<size_t>(smem), stream>>>(args...);
    return cudaGetLastError();
}

// After a frontier kernel: frontier_finalize over the `stripes` stripes
// of every shard of h rows, on the state of parity `parity`.
int finalize(void* state, void* rowflag, void* act, int stripes, int h, int stripe_h, int parity,
             cudaStream_t stream) {
    frontier_finalize<<<stripes, 256, 0, stream>>>(static_cast<int*>(state),
                                                    static_cast<int*>(rowflag),
                                                    static_cast<int*>(act), h, stripe_h,
                                                    h / stripe_h, parity);
    return cudaGetLastError();
}

}  // namespace

// K5 and K8: a contiguous stack of nb boards of (h, wp) words, blockIdx.z
// the board (K5 is the stack of one board); `state`
// (int32[2][5][nb * grid]), `rowflag` (int32[nb * h], zero between
// launches), `skipped` (int32[nb]) and `act` (int32[nb * grid]) persist
// over a chunk.  The decision's reach pad_f (>= the window's row halo
// T + 6) must fit one stripe, so a window wraps around its board once at
// most; a block is `tile_h` rows of a stripe and `warps` warps; `variant`
// picks the rule's instantiation (regwin.cuh::by_rule).
extern "C" int gol_frontier_batched_launch(const void* rd, void* wr, void* state, void* rowflag,
                                           void* skipped, void* act, int nb, int h, int wp,
                                           int turns, int stripe_h, int tile_h, int warps,
                                           int pad_f, int parity, int first, int variant,
                                           unsigned born, unsigned surv, void* stream) {
    if (nb < 1 || nb > 65535 || bad_reg_frontier(h, wp, turns, stripe_h, tile_h, warps, pad_f) ||
        pad_f > stripe_h || turns + kSkipPeriod > h || (parity != 0 && parity != 1) ||
        (first != 0 && first != 1)) {
        return cudaErrorInvalidValue;
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int err = reg::by_rule(variant, born, surv, [&](auto rule) {
        return launch_reg(frontier_reg_kernel<decltype(rule)>, reg_grid(wp, h, tile_h, nb), warps,
                          s, static_cast<const uint32_t*>(rd), static_cast<uint32_t*>(wr),
                          static_cast<int*>(state), static_cast<int*>(rowflag),
                          static_cast<int*>(skipped), h, wp, turns, stripe_h, tile_h, pad_f,
                          parity, first, rule);
    });
    if (err != cudaSuccess) return err;
    return finalize(state, rowflag, act, nb * (h / stripe_h), h, stripe_h, parity, s);
}

// K12: the caller builds `prev_ext` (the exchange) and zeroes `rowflag`
// once; the launch's decision reach is pad_f (the JAX plan's
// round8(T + 6)), its window halo T + 6, within the neighbour buffers
// (T + 6 <= n).  A block is `tile_h` rows of a stripe and `warps` warps;
// `variant` picks the rule's instantiation (regwin.cuh::by_rule).
// `skipped` (int32[1]) and `act` (int32[grid]) accumulate over the
// launches of a dispatch.
extern "C" int gol_strip_frontier_launch(const void* local, const void* north, const void* south,
                                         void* wr, const void* prev_ext,
                                         const void* prev_computed, void* cur, void* rowflag,
                                         void* skipped, void* act, int h, int wp, int n,
                                         int turns, int stripe_h, int tile_h, int warps,
                                         int pad_f, int variant, unsigned born, unsigned surv,
                                         void* stream) {
    if (bad_reg_frontier(h, wp, turns, stripe_h, tile_h, warps, pad_f) ||
        turns + kSkipPeriod > n) {
        return cudaErrorInvalidValue;
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int err = reg::by_rule(variant, born, surv, [&](auto rule) {
        return launch_reg(strip_frontier_reg_kernel<decltype(rule)>, reg_grid(wp, h, tile_h, 1),
                          warps, s, static_cast<const uint32_t*>(local),
                          static_cast<const uint32_t*>(north), static_cast<const uint32_t*>(south),
                          static_cast<uint32_t*>(wr), static_cast<const int*>(prev_ext),
                          static_cast<const int*>(prev_computed), static_cast<int*>(cur),
                          static_cast<int*>(rowflag), static_cast<int*>(skipped), h, wp, n, turns,
                          stripe_h, tile_h, pad_f, rule);
    });
    if (err != cudaSuccess) return err;
    // The state of one strip is one "board" of grid stripes at parity 0.
    return finalize(cur, rowflag, act, h / stripe_h, h, stripe_h, 0, s);
}

// K14: `rd_tab` and `wr_tab` are device arrays of ny buffer pointers (no
// write buffer is a read buffer); `state` (int32[2][5][ny * grid]),
// `rowflag` (int32[ny * h], zero between launches), `skipped` (int32[ny])
// and `act` (int32[ny * grid]) persist over a chunk.  The decision's
// reach pad_f (the JAX plan's round8(T + 6), >= the window's row halo
// T + 6) must fit one stripe, so nothing past the adjacent strip is read;
// a block is `tile_h` rows of a stripe and `warps` warps; `variant` picks
// the rule's instantiation (regwin.cuh::by_rule).
extern "C" int gol_strip_mega_launch(const void* rd_tab, const void* wr_tab, void* state,
                                     void* rowflag, void* skipped, void* act, int ny, int h,
                                     int wp, int turns, int stripe_h, int tile_h, int warps,
                                     int pad_f, int parity, int first, int variant, unsigned born,
                                     unsigned surv, void* stream) {
    if (ny < 1 || ny > 65535 || bad_reg_frontier(h, wp, turns, stripe_h, tile_h, warps, pad_f) ||
        pad_f > stripe_h || (parity != 0 && parity != 1) || (first != 0 && first != 1)) {
        return cudaErrorInvalidValue;
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int err = reg::by_rule(variant, born, surv, [&](auto rule) {
        return launch_reg(strip_mega_reg_kernel<decltype(rule)>, reg_grid(wp, h, tile_h, ny),
                          warps, s, static_cast<const uint32_t* const*>(rd_tab),
                          static_cast<uint32_t* const*>(wr_tab), static_cast<int*>(state),
                          static_cast<int*>(rowflag), static_cast<int*>(skipped), ny, h, wp, turns,
                          stripe_h, tile_h, pad_f, parity, first, rule);
    });
    if (err != cudaSuccess) return err;
    return finalize(state, rowflag, act, ny * (h / stripe_h), h, stripe_h, parity, s);
}

// K15: `rd_tab` and `wr_tab` are device arrays of ny * nx tile buffer
// pointers, row-major (no write buffer is a read buffer); `state`
// (int32[2][5][ny * nx * grid]), `rowflag` (int32[ny * nx * h], zero
// between launches), `skipped` (int32[ny * nx]) and `act`
// (int32[ny * nx * grid]) persist over a chunk, indexed tile-major.  The
// decision's reach pad_f (>= the window's row halo T + 6) must fit one
// stripe, so nothing past the adjacent tiles' rows is read; a block is
// `tile_h` rows of a stripe and `warps` warps; `variant` picks the rule's
// instantiation (regwin.cuh::by_rule).
extern "C" int gol_tile_mega_launch(const void* rd_tab, const void* wr_tab, void* state,
                                    void* rowflag, void* skipped, void* act, int ny, int nx,
                                    int h, int wp, int turns, int stripe_h, int tile_h, int warps,
                                    int pad_f, int parity, int first, int variant, unsigned born,
                                    unsigned surv, void* stream) {
    if (ny < 1 || nx < 1 || ny * nx > 65535 ||
        bad_reg_frontier(h, wp, turns, stripe_h, tile_h, warps, pad_f) || pad_f > stripe_h ||
        (parity != 0 && parity != 1) || (first != 0 && first != 1)) {
        return cudaErrorInvalidValue;
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int err = reg::by_rule(variant, born, surv, [&](auto rule) {
        return launch_reg(tile_mega_reg_kernel<decltype(rule)>, reg_grid(wp, h, tile_h, ny * nx),
                          warps, s, static_cast<const uint32_t* const*>(rd_tab),
                          static_cast<uint32_t* const*>(wr_tab), static_cast<int*>(state),
                          static_cast<int*>(rowflag), static_cast<int*>(skipped), ny, nx, h, wp,
                          turns, stripe_h, tile_h, pad_f, parity, first, rule);
    });
    if (err != cudaSuccess) return err;
    return finalize(state, rowflag, act, ny * nx * (h / stripe_h), h, stripe_h, parity, s);
}
