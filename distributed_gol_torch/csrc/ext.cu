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
//
// K10: the skip_stable form of the same kernel (gol_ext_skip_launch).
// Replaces _ext_kernel built with skip_stable=True (_advance_window's
// _probe_window), which make_superstep runs for the period-multiple part
// of a skip_stable dispatch's remainder and for the full launches of a
// strip with no adaptive plan.  K9's window and load plus K3's probe
// (tiled_skip.cu, window.cuh::inner_stable): 6 generations, then the
// window's inner region against the block it was loaded from; a tile that
// proves period-6 stable copies its input centre through, any other goes
// on to T.  The proof holds for any window, so the decision is the
// block's own and only the centre comes out.  Bound: as K9 on an active
// strip (6 more generations where the probe fails), the block's read and
// the centre's write on a settled one.

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
    load_window(ExtSource{in, h_loc + 2 * pad, wpl + 2 * xpad, xpad == 0}, a, w);
    const uint32_t* res = advance(a, a + w.rows * w.cols, w, turns, born, surv);
    store_centre(res, out, h_loc, wpl, w, turns, xw, y0, x0, tile_h, tile_w);
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

// The checks and the launch shared by K9 and K10: one block per tile, two
// window buffers of shared memory each.
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

extern "C" int gol_ext_launch(const void* in, void* out, int h_loc, int wpl, int pad, int xpad,
                              int turns, int tile_h, int tile_w, unsigned born, unsigned surv,
                              void* stream) {
    return launch_ext(ext_kernel, in, out, h_loc, wpl, pad, xpad, turns, tile_h, tile_w, born,
                      surv, stream);
}

// K10: turns must be a positive multiple of kSkipPeriod.
extern "C" int gol_ext_skip_launch(const void* in, void* out, int h_loc, int wpl, int pad,
                                   int xpad, int turns, int tile_h, int tile_w, unsigned born,
                                   unsigned surv, void* stream) {
    if (turns < kSkipPeriod || turns % kSkipPeriod) return cudaErrorInvalidValue;
    return launch_ext(ext_skip_kernel, in, out, h_loc, wpl, pad, xpad, turns, tile_h, tile_w,
                      born, surv, stream);
}
