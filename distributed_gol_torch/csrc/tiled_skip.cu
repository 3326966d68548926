// K3: the skip form of the tiled kernel.  Replaces
// distributed_gol_tpu/ops/pallas_packed.py::_kernel in its skip_stable=True
// form (the probe of _advance_window / _probe_window), which _run_tiled
// launches for the period-multiple part of a dispatch's remainder.
//
// One launch advances a horizontally packed (h, wp) torus T generations
// (T a multiple of 6) into a fresh output, with the skip proof: each
// block steps its window 6 generations and compares the window's inner
// region with its input.  If they agree, the block's centre at generation
// T is its input, and the rest of the generations are skipped; otherwise
// the window goes on to T.  The proof holds for any window shape, so the
// decision is the block's own, and no state crosses launches: only the
// board comes out.
//
// What bounds it on an H100: as K2, integer operations on an active board
// (every window row steps until the probe, so no generation more than K2
// at the same T), and on a stable one the 6 generations of the probe, which
// a launch that carries no state cannot skip, against one read and one
// write of the board.
//
// The design is K2's (tiled.cu: regwin.cuh's register window over the
// torus read in place, regwin.cuh's TorusBlock) with K10's probe (ext.cu,
// ext_skip_reg_kernel):
// - The window: window row r comes from board row (y0 - T + r) mod h by a
//   running counter (one modulo for the run's first row) and lane l from
//   word (x0 - border + l) mod wp, so a board shorter than its halo or
//   narrower than a warp's window fills it with its periodic cover.
// - The probe: at generation 6 every thread compares its rows [6,
//   rows - 6) of the window with the board they were loaded from, re-read
//   by the same running counter (K3 never writes `in`; `out` is fresh),
//   leaving out the 6 cells next to the window's x edge (lanes 0 and 31),
//   which the warp's column wrap reaches in 6 generations.  The comparand
//   is re-read rather than kept (reg::keep) because a kept window would
//   cost each block warps * 4 KB of shared memory, and so SM occupancy, on
//   every launch for one read of the board on L2's side.
// - A block that proves stable keeps its registers, whose inner region,
//   the stored centre included, equals its input; any other steps on from
//   generation 7 to T on the light cone.  Only centre lanes with gx < wp,
//   and rows with y0 + r < h, store.

#include "regwin.cuh"

namespace {

using namespace gol;

// K3: one block per (row tile, column group) of the board; its window is
// warps * 32 rows (the tile and `turns` rows a side matter) by 32 words,
// `border` of them a side outside the group's centre.
template <class Rule>
__global__ void __launch_bounds__(reg::kMaxThreads, 2)
tiled_skip_reg_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int h,
                      int wp, int turns, int tile_h, int border, Rule rule) {
    __shared__ reg::Edges edges;
    const reg::TorusBlock blk{in, h, wp, tile_h, border};
    const reg::Run run = reg::Run::make(tile_h + 2 * turns, turns, turns, kSkipPeriod);
    uint32_t s[reg::kRun];
    blk.load(s, run);
    reg::advance(s, edges, run, 1, kSkipPeriod, rule);
    uint32_t diff = 0u;
    {
        uint32_t mask = 0xffffffffu;
        if (run.lane == 0) mask = 0xffffffc0u;                // cells 0..5 of the window row
        if (run.lane == reg::kLanes - 1) mask = 0x03ffffffu;  // its last six cells
        blk.rows(run, [&](int i, const uint32_t* word) {
            const int r = run.row(i);
            if (r >= kSkipPeriod && r < run.rows - kSkipPeriod) diff |= (s[i] ^ *word) & mask;
        });
    }
    if (__syncthreads_or(diff != 0u)) reg::advance(s, edges, run, kSkipPeriod + 1, turns, rule);
    blk.store(s, run, out);
}

}  // namespace

// K3: `tile_h` board rows a block (the last tile overhangs the board),
// `warps` warps of 32 rows holding its window (tile_h + 2 * turns rows),
// columns in groups of 32 - 2 * border centre words (turns <= 32 *
// border); turns a multiple of 6; `variant` picks the rule's
// instantiation (regwin.cuh::by_rule).  The plan is
// ops/cuda_adaptive.py::tiled_skip_reg_plan's.
extern "C" int gol_tiled_skip_launch(const void* in, void* out, int h, int wp, int turns,
                                     int tile_h, int warps, int border, int variant,
                                     unsigned born, unsigned surv, void* stream) {
    if (h < 1 || wp < 1 || turns < kSkipPeriod || turns % kSkipPeriod || tile_h < 1 ||
        warps < 1 || warps > reg::kMaxWarps || warps * reg::kRun < tile_h + 2 * turns ||
        border < 1 || 32 * border < turns || 2 * border >= reg::kLanes ||
        (h + tile_h - 1) / tile_h > 65535) {
        return cudaErrorInvalidValue;
    }
    const int centre = reg::kLanes - 2 * border;
    const dim3 grid((wp + centre - 1) / centre, (h + tile_h - 1) / tile_h);
    const dim3 block(reg::kLanes, warps);
    return reg::by_rule(variant, born, surv, [&](auto rule) {
        tiled_skip_reg_kernel<decltype(rule)>
            <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
                static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), h, wp, turns,
                tile_h, border, rule);
        return static_cast<int>(cudaGetLastError());
    });
}
