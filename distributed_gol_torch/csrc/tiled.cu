// K2: the temporally blocked tiled kernel.  Replaces
// distributed_gol_tpu/ops/pallas_packed.py::_kernel in its plain
// (skip_stable=False) form, built by _build_launch and driven by
// _run_tiled; its step is _gen.
//
// One launch advances T generations.  Each block owns an output tile of
// tile_h rows x tile_w words and loads a window of (tile_h + 2T) rows x
// (tile_w + 2*xpad) words into shared memory, xpad*32 >= T, gathered
// modulo the board (window.cuh).  After T generations the centre is exact
// and only it is written back.  The window ping-pongs between two buffers
// in shared memory.
//
// What bounds it on an H100: integer operations.  Per launch the board is
// read once and written once (2 * H * W/8 bytes), while the generations
// cost ~45 ops per word each; at T = 32 the operations outweigh the bytes
// by more than an order of magnitude.  The design therefore spends shared
// memory on depth, and computes each word's horizontal sum once per
// generation (window.cuh::advance).

#include "window.cuh"

namespace {

using namespace gol;

__global__ void __launch_bounds__(kThreads)
tiled_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int h, int wp,
             int turns, int tile_h, int tile_w, int xpad, uint32_t born, uint32_t surv) {
    extern __shared__ uint32_t smem[];
    const int y0 = blockIdx.y * tile_h;
    const int x0 = blockIdx.x * tile_w;
    const Window w{tile_h + 2 * turns, tile_w + 2 * xpad, y0 - turns, x0 - xpad};
    uint32_t* a = smem;
    load_window(in, a, h, wp, w);
    const uint32_t* res = advance(a, a + w.rows * w.cols, w, turns, born, surv);
    store_centre(res, out, h, wp, w, turns, xpad, y0, x0, tile_h, tile_w);
}

}  // namespace

extern "C" int gol_tiled_launch(const void* in, void* out, int h, int wp, int turns, int tile_h,
                                int tile_w, int xpad, unsigned born, unsigned surv,
                                void* stream) {
    if (h < 1 || wp < 1 || turns < 1 || tile_h < 1 || tile_w < 1 || xpad * 32 < turns ||
        tile_w + 2 * xpad > kCols) {
        return cudaErrorInvalidValue;
    }
    const long long smem = window_smem(tile_h + 2 * turns, tile_w + 2 * xpad);
    cudaError_t err = allow_smem(tiled_kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((wp + tile_w - 1) / tile_w, (h + tile_h - 1) / tile_h);
    const dim3 block(kCols, kSegs);
    tiled_kernel<<<grid, block, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), h, wp, turns, tile_h,
        tile_w, xpad, born, surv);
    return cudaGetLastError();
}
