// K9: the sharded strip kernel.  Replaces
// distributed_gol_tpu/parallel/pallas_halo.py::_ext_kernel in its plain
// (skip_stable=False) form, built by _build_ext_launch and driven by
// make_superstep on row meshes and by its _run_2d on 2-D meshes.
//
// Input: one shard's halo-extended block of horizontally packed words,
// (h_loc + 2*pad) x (wpl + 2*xpad), whose pad rows and xpad word columns
// were copied from the neighbour shards (parallel/halo.py::extend).  One
// launch advances it T <= pad generations and writes the (h_loc, wpl)
// centre into a fresh output; the input is never written.
//
// The tiling is K2's (tiled.cu): each block owns a tile_h x tile_w tile of
// the centre and steps a (tile_h + 2T) x (tile_w + 2*xw) window in shared
// memory, xw = ceil(T / 32), with window.cuh's advance.  Only the load
// differs.  Rows never wrap: the pad rows ARE the neighbours' rows, and
// pad >= T.  Columns wrap modulo wpl only on a row mesh (xpad == 0), where
// the strip spans the board's width and the wrap is the exact torus; on a
// 2-D mesh the exchanged columns carry the x-halo (xpad >= xw) and nothing
// wraps.  Window words outside the extended block (past a ragged last
// tile) read as zero: they lie more than T rows or cells from every cell
// the block stores.  K9 tiles the centre only; it is not K2 run on the
// extended block, which would add a second halo around every tile.
//
// What bounds it on an H100: integer operations, as for K2.  A launch reads
// the extended block once and writes the centre once, while each of its T
// generations costs ~12 instructions per word (chip_smoke.py::ops_per_word);
// at T = 32 the operations outweigh the bytes by an order of magnitude, so
// the shared memory goes to depth.

#include "window.cuh"

namespace {

using namespace gol;

// Gather the window from the extended block (rows_in x cols_in words):
// rows as they are, columns modulo cols_in when `wrap_cols`, zero outside.
__device__ void load_ext_window(const uint32_t* __restrict__ in, uint32_t* win, int rows_in,
                                int cols_in, bool wrap_cols, const Window& w) {
    const int n = w.rows * w.cols;
    for (int i = thread_id(); i < n; i += kThreads) {
        const int r = i / w.cols;
        const int c = i - r * w.cols;
        const int y = w.top + r;
        const int x = wrap_cols ? wrap(w.left + c, cols_in) : w.left + c;
        const bool inside = y >= 0 && y < rows_in && x >= 0 && x < cols_in;
        win[i] = inside ? in[static_cast<size_t>(y) * cols_in + x] : 0u;
    }
    __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
ext_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int h_loc, int wpl,
           int pad, int xpad, int turns, int tile_h, int tile_w, int xw, uint32_t born,
           uint32_t surv) {
    extern __shared__ uint32_t smem[];
    const int y0 = blockIdx.y * tile_h;
    const int x0 = blockIdx.x * tile_w;
    // Window word (0, 0) in the extended block's coordinates.
    const Window w{tile_h + 2 * turns, tile_w + 2 * xw, pad + y0 - turns, xpad + x0 - xw};
    uint32_t* a = smem;
    load_ext_window(in, a, h_loc + 2 * pad, wpl + 2 * xpad, xpad == 0, w);
    const uint32_t* res = advance(a, a + w.rows * w.cols, w, turns, born, surv);
    store_centre(res, out, h_loc, wpl, w, turns, xw, y0, x0, tile_h, tile_w);
}

}  // namespace

extern "C" int gol_ext_launch(const void* in, void* out, int h_loc, int wpl, int pad, int xpad,
                              int turns, int tile_h, int tile_w, unsigned born, unsigned surv,
                              void* stream) {
    const int xw = (turns + 31) / 32;
    if (h_loc < 1 || wpl < 1 || turns < 1 || turns > pad || xpad < 0 ||
        (xpad > 0 && xpad < xw) || tile_h < 1 || tile_w < 1 || tile_w + 2 * xw > kCols) {
        return cudaErrorInvalidValue;
    }
    const long long smem = window_smem(tile_h + 2 * turns, tile_w + 2 * xw);
    cudaError_t err = allow_smem(ext_kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((wpl + tile_w - 1) / tile_w, (h_loc + tile_h - 1) / tile_h);
    const dim3 block(kCols, kSegs);
    ext_kernel<<<grid, block, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), h_loc, wpl, pad, xpad,
        turns, tile_h, tile_w, xw, born, surv);
    return cudaGetLastError();
}
