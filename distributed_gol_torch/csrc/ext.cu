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
// K10: the skip_stable form of the same kernel (gol_ext_skip_launch).
// Replaces _ext_kernel built with skip_stable=True (_advance_window's
// _probe_window), which make_superstep runs for the period-multiple part
// of a skip_stable dispatch's remainder and for the full launches of a
// strip with no adaptive plan.  The first K9 design's window (K2's tiling,
// cuda_halo.ext_tiles: a tile_h x tile_w tile stepped in shared memory by
// window.cuh::advance, the ExtSource load) plus K3's probe
// (tiled_skip.cu, window.cuh::inner_stable): 6 generations, then the
// window's inner region against the block it was loaded from; a tile that
// proves period-6 stable copies its input centre through, any other goes
// on to T.  The proof holds for any window, so the decision is the
// block's own and only the centre comes out.  Bound: as K9 on an active
// strip (6 more generations where the probe fails), the block's read and
// the centre's write on a settled one.

#include "regwin.cuh"
#include "window.cuh"

namespace {

using namespace gol;

// The extended block (rows_in x cols_in words) as a window source: rows
// as they are, columns modulo cols_in when `wrap_cols`, zero outside.
struct ExtSource {
    const uint32_t* in;
    int rows_in, cols_in;
    bool wrap_cols;
    __device__ __forceinline__ uint32_t operator()(int y, int x) const {
        if (wrap_cols) x = wrap(x, cols_in);
        const bool inside = y >= 0 && y < rows_in && x >= 0 && x < cols_in;
        return inside ? in[static_cast<size_t>(y) * cols_in + x] : 0u;
    }
};

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
    // This lane's word column of the extended block (ExtSource's wrap and
    // bounds, taken once), and its window row 0.
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

// K10: K9 with K3's probe.  The window is K9's; after 6 generations its
// inner region is compared with the extended block it was loaded from
// (window.cuh::inner_stable).  If they agree, the centre at generation T
// (a multiple of 6) is the input centre, copied through from the block;
// otherwise the window goes on to T and its centre is stored.
__global__ void __launch_bounds__(kThreads)
ext_skip_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int h_loc, int wpl,
                int pad, int xpad, int turns, int tile_h, int tile_w, int xw, uint32_t born,
                uint32_t surv) {
    extern __shared__ uint32_t smem[];
    const int y0 = blockIdx.y * tile_h;
    const int x0 = blockIdx.x * tile_w;
    const int cols_in = wpl + 2 * xpad;
    const ExtSource src{in, h_loc + 2 * pad, cols_in, xpad == 0};
    const Window w{tile_h + 2 * turns, tile_w + 2 * xw, pad + y0 - turns, xpad + x0 - xw};
    uint32_t* a = smem;
    uint32_t* b = smem + w.rows * w.cols;
    load_window(src, a, w);
    uint32_t* res = advance(a, b, w, kSkipPeriod, born, surv);
    if (inner_stable(res, src, w)) {
        for (int i = thread_id(); i < tile_h * tile_w; i += kThreads) {
            const int r = i / tile_w;
            const int c = i - r * tile_w;
            const int gy = y0 + r;
            const int gx = x0 + c;
            if (gy < h_loc && gx < wpl) {
                out[static_cast<size_t>(gy) * wpl + gx] =
                    in[static_cast<size_t>(pad + gy) * cols_in + xpad + gx];
            }
        }
        return;
    }
    res = advance(res, res == a ? b : a, w, turns - kSkipPeriod, born, surv);
    store_centre(res, out, h_loc, wpl, w, turns, xw, y0, x0, tile_h, tile_w);
}

// K10's checks and launch: one block per tile, two window buffers of
// shared memory each.
template <typename Kernel>
int launch_ext(Kernel kernel, const void* in, void* out, int h_loc, int wpl, int pad, int xpad,
               int turns, int tile_h, int tile_w, unsigned born, unsigned surv, void* stream) {
    const int xw = (turns + 31) / 32;
    if (h_loc < 1 || wpl < 1 || turns < 1 || turns > pad || xpad < 0 ||
        (xpad > 0 && xpad < xw) || tile_h < 1 || tile_w < 1 || tile_w + 2 * xw > kCols) {
        return cudaErrorInvalidValue;
    }
    const long long smem = window_smem(tile_h + 2 * turns, tile_w + 2 * xw);
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((wpl + tile_w - 1) / tile_w, (h_loc + tile_h - 1) / tile_h);
    const dim3 block(kCols, kSegs);
    kernel<<<grid, block, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), h_loc, wpl, pad, xpad,
        turns, tile_h, tile_w, xw, born, surv);
    return cudaGetLastError();
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

// K10: turns must be a positive multiple of kSkipPeriod.
extern "C" int gol_ext_skip_launch(const void* in, void* out, int h_loc, int wpl, int pad,
                                   int xpad, int turns, int tile_h, int tile_w, unsigned born,
                                   unsigned surv, void* stream) {
    if (turns < kSkipPeriod || turns % kSkipPeriod) return cudaErrorInvalidValue;
    return launch_ext(ext_skip_kernel, in, out, h_loc, wpl, pad, xpad, turns, tile_h, tile_w,
                      born, surv, stream);
}
