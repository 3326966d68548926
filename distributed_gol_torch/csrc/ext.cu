// K9: the sharded strip kernel.  Replaces
// distributed_gol_tpu/parallel/pallas_halo.py::_ext_kernel in its plain
// (skip_stable=False) form, built by _build_ext_launch and driven by
// make_superstep on row meshes and by its _run_2d on 2-D meshes.
//
// Input: one shard's halo-extended block of horizontally packed words,
// (h_loc + 2*pad) x (wpl + 2*xpad), whose pad rows and xpad word columns
// were copied from the neighbour shards (parallel/halo.py::extend).  One
// launch advances it T <= pad generations and writes the (h_loc, wpl)
// centre into a fresh output; the input is never written.  Rows never
// wrap: the pad rows ARE the neighbours' rows.  Columns wrap modulo wpl
// only on a row mesh (xpad == 0), where the strip spans the board's width
// and the wrap is the exact torus; on a 2-D mesh the exchanged columns
// carry the x-halo (xpad >= ceil(T / 32)) and words outside the block read
// as zero, as they do past a ragged last tile.
//
// What bounds it on an H100: integer operations.  A launch reads the
// extended block once and writes the centre once, while each of its T
// generations costs ~12 instructions a word (chip_smoke.py::ops_per_word),
// so at T = 32 the operations outweigh the bytes by an order of magnitude.
// Its least time is the centre's light cone over the SMs' int32 rate.
//
// The design (regwin.cuh), one part for each factor between the first
// port's time and that bound:
// - The generation loop: a block is `warps` warps stacked over one
//   32-word window column, each thread one column's run of 32 rows in
//   registers; neighbour words come from the adjacent lanes by shuffle,
//   only a run's edge rows cross warps (through shared memory, one
//   barrier a generation), and the rule is a template argument (B3/S23
//   and B36/S23 at compile time; any other rule through AnyRule).
// - The grid: blocks hold no window in shared memory, so several share
//   an SM (at most 512 threads and 64 registers a thread), and the plan
//   (parallel/cuda_halo.py::ext_reg_plan) picks the block height whose
//   grid fills the card's SMs in the fewest, fullest waves.
// - The redundant work: a warp's 32 - 2*border middle words are centre
//   (border = ceil(T / 32), so a launch of at most 32 generations
//   computes 32 words for 30), a block's window is its tile plus T rows a
//   side, and each run steps only the chunks of 8 rows that meet the
//   light cone of generation g (the tile plus T - g rows a side).
//
// K10: the skip_stable form of the same kernel (ext_skip_reg_kernel,
// gol_ext_skip_launch).  Replaces _ext_kernel built with skip_stable=True
// (_advance_window's _probe_window), which make_superstep runs for the
// period-multiple part of a skip_stable dispatch's remainder and for the
// full launches of a strip or tile with no adaptive plan.  K9's window and
// loop (regwin.cuh) with K13's probe: every window row steps 6
// generations, then the window's inner region is compared with the
// extended block it was loaded from (re-read: the block is never written).
// A block that proves period-6 stable keeps its registers, whose inner
// region (the centre included) equals its input; any other goes on to T.
// The proof holds for any window, so the decision is the block's own.
//
// Blocks end at the block's edge (parallel/cuda_halo.py::ext_skip_plan):
// the last row tile is shifted up to end at the centre's last row, and the
// last column group shifted left to end at its last word, their overlap
// written twice with equal values, so no window reads past the extended
// block where it is at least a window wide.  Columns wrap modulo the
// extended width only on a row mesh (xpad == 0, the exact torus); on a 2-D
// tile words past it read zero, as the JAX skip-form kernel reads them,
// and the probe leaves out the 6 cells next to the block's x edge as it
// does next to the window's (the cells those zeros reach in 6
// generations).  On settled ash every block proves stable, so a settled
// launch is each window's 6-generation probe and its store.  Bound: as K9
// on an active strip (6 more generations where the probe fails), the
// block's read and the centre's write on a settled one.

#include "regwin.cuh"

namespace {

using namespace gol;

// K9: one block per (row tile, column group) of the centre; its window
// is warps * 32 rows (the tile and `turns` rows a side matter) by 32
// words, `border` of them a side outside the group's centre.
template <class Rule>
__global__ void __launch_bounds__(reg::kMaxThreads, 2)
ext_reg_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int h_loc, int wpl,
               int pad, int xpad, int turns, int tile_h, int border, Rule rule) {
    __shared__ reg::Edges edges;
    const reg::Run run = reg::Run::make(tile_h + 2 * turns, turns, turns, 0);
    const int y0 = blockIdx.y * tile_h;
    const int x0 = blockIdx.x * (reg::kLanes - 2 * border);
    // This lane's word column of the extended block (modulo its width on a
    // row mesh; its bounds taken once), and its window row 0.
    const int cols_in = wpl + 2 * xpad;
    const int rows_in = h_loc + 2 * pad;
    int col = xpad + x0 - border + run.lane;
    if (xpad == 0) col = wrap(col, cols_in);
    const bool col_in = col >= 0 && col < cols_in;
    const int top = pad + y0 - turns;
    uint32_t s[reg::kRun];
    reg::load(s, run, [&](int r) {
        const int y = top + r;
        return col_in && y >= 0 && y < rows_in ? in[static_cast<size_t>(y) * cols_in + col] : 0u;
    });
    reg::advance(s, edges, run, 1, turns, rule);
    const int gx = x0 + run.lane - border;
    const bool centre = run.lane >= border && run.lane < reg::kLanes - border && gx < wpl;
#pragma unroll
    for (int i = 0; i < reg::kRun; ++i) {
        const int r = run.row(i) - turns;
        if (centre && r >= 0 && r < tile_h && y0 + r < h_loc) {
            out[static_cast<size_t>(y0 + r) * wpl + gx] = s[i];
        }
    }
}

// Where a K10 block stands, read anew from blockIdx and the launch's
// arguments wherever it is needed (regwin.cuh::block_x/block_y), so no
// value of it holds a register through the generation loop.
struct SkipBlock {
    const uint32_t* in;
    int h_loc, wpl, pad, xpad, turns, tile_h, border;

    __device__ __forceinline__ int y0() const {
        return min(reg::block_y() * tile_h, h_loc - tile_h);
    }
    __device__ __forceinline__ int x0() const {
        const int centre = reg::kLanes - 2 * border;
        return min(reg::block_x() * centre, max(wpl - centre, 0));
    }
    // This lane's column of the extended block, wrapped on a row mesh.
    __device__ __forceinline__ int col() const {
        const int c = xpad + x0() - border + static_cast<int>(threadIdx.x);
        return xpad == 0 ? wrap(c, wpl) : c;
    }
    // Window row r of this lane, zero outside the block.
    __device__ __forceinline__ uint32_t operator()(int r) const {
        const int cols_in = wpl + 2 * xpad;
        const int c = col();
        const int y = pad + y0() - turns + r;
        const bool inside = c >= 0 && c < cols_in && y >= 0 && y < h_loc + 2 * pad;
        return inside ? in[static_cast<size_t>(y) * cols_in + c] : 0u;
    }
    // The cells of this lane's word the probe compares: all but the 6
    // next to the window's x edge (lanes 0 and 31) and, on a 2-D tile,
    // next to the block's (none outside it).
    __device__ __forceinline__ uint32_t probe_mask() const {
        constexpr uint32_t kFirst = 0xffffffc0u, kLast = 0x03ffffffu;
        uint32_t mask = 0xffffffffu;
        if (threadIdx.x == 0) mask &= kFirst;
        if (threadIdx.x == reg::kLanes - 1) mask &= kLast;
        if (xpad > 0) {
            const int c = col();
            const int cols_in = wpl + 2 * xpad;
            if (c < 0 || c >= cols_in) return 0u;
            if (c == 0) mask &= kFirst;
            if (c == cols_in - 1) mask &= kLast;
        }
        return mask;
    }
};

// K10: one block per (row tile, column group) of the centre, the last of
// each shifted to end at the centre's edge; its window is warps * 32 rows
// (the tile and `turns` rows a side matter) by 32 words, `border` of them
// a side outside the group's centre.  `stable[block]` is set to whether
// the block's probe held (it computed no generation past the probe).
template <class Rule>
__global__ void __launch_bounds__(reg::kMaxThreads, 2)
ext_skip_reg_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                    int* __restrict__ stable, int h_loc, int wpl, int pad, int xpad, int turns,
                    int tile_h, int border, Rule rule) {
    __shared__ reg::Edges edges;
    const SkipBlock blk{in, h_loc, wpl, pad, xpad, turns, tile_h, border};
    const reg::Run run = reg::Run::make(tile_h + 2 * turns, turns, turns, kSkipPeriod);
    uint32_t s[reg::kRun];
    reg::load(s, run, blk);
    reg::advance(s, edges, run, 1, kSkipPeriod, rule);
    uint32_t diff = 0u;
    {
        const uint32_t mask = blk.probe_mask();
#pragma unroll
        for (int i = 0; i < reg::kRun; ++i) {
            const int r = run.row(i);
            if (r >= kSkipPeriod && r < run.rows - kSkipPeriod) diff |= (s[i] ^ blk(r)) & mask;
        }
    }
    const bool proved = __syncthreads_or(diff != 0u) == 0;
    if (!proved) reg::advance(s, edges, run, kSkipPeriod + 1, turns, rule);
    if (threadIdx.x == 0 && threadIdx.y == 0) {
        stable[reg::block_y() * gridDim.x + reg::block_x()] = proved ? 1 : 0;
    }
    const int y0 = blk.y0();
    const int gx = blk.x0() + run.lane - border;
    const bool centre = run.lane >= border && run.lane < reg::kLanes - border && gx < wpl;
#pragma unroll
    for (int i = 0; i < reg::kRun; ++i) {
        const int r = run.row(i) - turns;
        if (centre && r >= 0 && r < tile_h) out[static_cast<size_t>(y0 + r) * wpl + gx] = s[i];
    }
}

}  // namespace

// K9: `tile_h` centre rows a block, `warps` warps of 32 rows holding its
// window (tile_h + 2 * turns rows), columns in groups of 32 - 2 * border
// centre words (turns <= 32 * border); `variant` picks the rule's
// instantiation (regwin.cuh::by_rule).
extern "C" int gol_ext_launch(const void* in, void* out, int h_loc, int wpl, int pad, int xpad,
                              int turns, int tile_h, int warps, int border, int variant,
                              unsigned born, unsigned surv, void* stream) {
    if (h_loc < 1 || wpl < 1 || turns < 1 || turns > pad || xpad < 0 ||
        (xpad > 0 && 32 * xpad < turns) || tile_h < 1 || warps < 1 ||
        warps > reg::kMaxWarps || warps * reg::kRun < tile_h + 2 * turns || border < 1 ||
        32 * border < turns || 2 * border >= reg::kLanes) {
        return cudaErrorInvalidValue;
    }
    const int centre = reg::kLanes - 2 * border;
    const dim3 grid((wpl + centre - 1) / centre, (h_loc + tile_h - 1) / tile_h);
    const dim3 block(reg::kLanes, warps);
    return reg::by_rule(variant, born, surv, [&](auto rule) {
        ext_reg_kernel<decltype(rule)><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), h_loc, wpl, pad, xpad,
            turns, tile_h, border, rule);
        return static_cast<int>(cudaGetLastError());
    });
}

// K10: K9's blocks (`tile_h` <= h_loc centre rows a block, the last row
// tile and column group shifted to end at the centre's edge) with the
// probe; turns a multiple of kSkipPeriod, at most 32 * border; `stable`
// holds one int a block (row-major over the grid).
extern "C" int gol_ext_skip_launch(const void* in, void* out, void* stable, int h_loc, int wpl,
                                   int pad, int xpad, int turns, int tile_h, int warps,
                                   int border, int variant, unsigned born, unsigned surv,
                                   void* stream) {
    if (h_loc < 1 || wpl < 1 || turns < kSkipPeriod || turns % kSkipPeriod || turns > pad ||
        xpad < 0 || (xpad > 0 && border > xpad) || tile_h < 1 || tile_h > h_loc || warps < 1 ||
        warps > reg::kMaxWarps || warps * reg::kRun < tile_h + 2 * turns || border < 1 ||
        32 * border < turns || 2 * border >= reg::kLanes) {
        return cudaErrorInvalidValue;
    }
    const int centre = reg::kLanes - 2 * border;
    const dim3 grid((wpl + centre - 1) / centre, (h_loc + tile_h - 1) / tile_h);
    const dim3 block(reg::kLanes, warps);
    return reg::by_rule(variant, born, surv, [&](auto rule) {
        ext_skip_reg_kernel<decltype(rule)>
            <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
                static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
                static_cast<int*>(stable), h_loc, wpl, pad, xpad, turns, tile_h, border, rule);
        return static_cast<int>(cudaGetLastError());
    });
}
