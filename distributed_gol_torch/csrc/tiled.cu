// K2: the temporally blocked tiled kernel.  Replaces
// distributed_gol_tpu/ops/pallas_packed.py::_kernel in its plain
// (skip_stable=False) form, built by _build_launch and driven by
// _run_tiled; its step is _gen.
//
// One launch advances a horizontally packed (h, wp) torus T generations
// into a fresh output.  The board is read in place as the torus: there is
// no pre-extended copy and no exchange.
//
// What bounds it on an H100: integer operations.  Per launch the board is
// read once and written once (2 * h * wp * 4 bytes), while each of its T
// generations costs ~12 instructions a word (chip_smoke.py::ops_per_word),
// so at T = 32 the operations outweigh the bytes by an order of magnitude.
// Its least time is the board's light cone over the SMs' int32 rate.
//
// The design is K9's (ext.cu, ext_reg_kernel) on regwin.cuh's register
// window, one part for each factor between the first port's time (a
// shared-memory window behind a barrier every generation, tiles sized by
// shared memory) and that bound:
// - The generation loop: a block is `warps` warps stacked over one
//   32-word window column, each thread one column's run of 32 rows in
//   registers; neighbour words come from the adjacent lanes by shuffle,
//   only a run's edge rows cross warps (shared memory, one barrier a
//   generation), and the rule is a template argument (B3/S23 and B36/S23
//   at compile time; any other rule through AnyRule).
// - The grid: blocks hold no window in shared memory, so several share an
//   SM, and the plan (ops/cuda_packed.py::tiled_reg_plan) picks the block
//   height whose grid fills the card's SMs in the fewest, fullest waves.
// - The redundant work: a warp's 32 - 2*border middle words are centre
//   (border = ceil(T / 32)), a block's window is its tile plus T rows a
//   side, and each run steps only the 8-row chunks that meet generation
//   g's light cone (the tile plus T - g rows a side).
// - The torus: the launch's one load takes window row r from board row
//   (y0 - T + r) mod h and lane l from word column (x0 - border + l) mod
//   wp (regwin.cuh's TorusBlock, which K3 shares), so a board shorter
//   than its halo (1- and 3-row tori included) fills the window with its
//   periodic cover, and on a board narrower than a warp's window the
//   lanes hold it several times over, in a period that is exactly the
//   torus.  Only the centre lanes whose word lies on the board (gx < wp)
//   store, so each word is written once.

#include "regwin.cuh"

namespace {

using namespace gol;

// K2: one block per (row tile, column group) of the board; its window is
// warps * 32 rows (the tile and `turns` rows a side matter) by 32 words,
// `border` of them a side outside the group's centre (regwin.cuh's
// TorusBlock).
template <class Rule>
__global__ void __launch_bounds__(reg::kMaxThreads, 2)
tiled_reg_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int h, int wp,
                 int turns, int tile_h, int border, Rule rule) {
    __shared__ reg::Edges edges;
    const reg::TorusBlock blk{in, h, wp, tile_h, border};
    const reg::Run run = reg::Run::make(tile_h + 2 * turns, turns, turns, 0);
    uint32_t s[reg::kRun];
    blk.load(s, run);
    reg::advance(s, edges, run, 1, turns, rule);
    blk.store(s, run, out);
}

}  // namespace

// K2: `tile_h` board rows a block, `warps` warps of 32 rows holding its
// window (tile_h + 2 * turns rows), columns in groups of 32 - 2 * border
// centre words (turns <= 32 * border); `variant` picks the rule's
// instantiation (regwin.cuh::by_rule).  The plan is
// ops/cuda_packed.py::tiled_reg_plan's.
extern "C" int gol_tiled_launch(const void* in, void* out, int h, int wp, int turns, int tile_h,
                                int warps, int border, int variant, unsigned born, unsigned surv,
                                void* stream) {
    if (h < 1 || wp < 1 || turns < 1 || tile_h < 1 || warps < 1 || warps > reg::kMaxWarps ||
        warps * reg::kRun < tile_h + 2 * turns || border < 1 || 32 * border < turns ||
        2 * border >= reg::kLanes || (h + tile_h - 1) / tile_h > 65535) {
        return cudaErrorInvalidValue;
    }
    const int centre = reg::kLanes - 2 * border;
    const dim3 grid((wp + centre - 1) / centre, (h + tile_h - 1) / tile_h);
    const dim3 block(reg::kLanes, warps);
    return reg::by_rule(variant, born, surv, [&](auto rule) {
        tiled_reg_kernel<decltype(rule)><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), h, wp, turns, tile_h,
            border, rule);
        return static_cast<int>(cudaGetLastError());
    });
}
