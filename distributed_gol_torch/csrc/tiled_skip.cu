// K3: the skip form of the tiled kernel.  Replaces
// distributed_gol_tpu/ops/pallas_packed.py::_kernel in its skip_stable=True
// form (the probe of _advance_window / _probe_window), which _run_tiled
// launches for the period-multiple part of a dispatch's remainder.
//
// K2 with the probe: each block loads K2's window (tile_h + 2T rows x
// tile_w + 2*xpad words, T a multiple of 6), advances it 6 generations and
// compares the inner region with the input (window.cuh::inner_stable).  If
// they agree, the centre at generation T is the input, and it is copied
// through; otherwise the window goes on to T and its centre is written.
// The proof holds for any window shape, so the decision is the block's
// own; only the board comes out.
//
// What bounds it: as K2, integer operations on an active board (6 extra
// generations when the probe fails), and the two passes over the board's
// bytes (read, then write or copy) on a stable one.

#include "window.cuh"

namespace {

using namespace gol;

__global__ void __launch_bounds__(kThreads)
tiled_skip_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int h, int wp,
                  int turns, int tile_h, int tile_w, int xpad, uint32_t born, uint32_t surv) {
    extern __shared__ uint32_t smem[];
    const int y0 = blockIdx.y * tile_h;
    const int x0 = blockIdx.x * tile_w;
    const Window w{tile_h + 2 * turns, tile_w + 2 * xpad, y0 - turns, x0 - xpad};
    uint32_t* a = smem;
    uint32_t* b = smem + w.rows * w.cols;
    load_window(in, a, h, wp, w);
    uint32_t* res = advance(a, b, w, kSkipPeriod, born, surv);
    if (inner_stable(res, in, h, wp, w)) {
        copy_tile(in, out, h, wp, y0, x0, tile_h, tile_w);
        return;
    }
    res = advance(res, res == a ? b : a, w, turns - kSkipPeriod, born, surv);
    store_centre(res, out, h, wp, w, turns, xpad, y0, x0, tile_h, tile_w);
}

}  // namespace

extern "C" int gol_tiled_skip_launch(const void* in, void* out, int h, int wp, int turns,
                                     int tile_h, int tile_w, int xpad, unsigned born,
                                     unsigned surv, void* stream) {
    if (h < 1 || wp < 1 || turns < kSkipPeriod || turns % kSkipPeriod || tile_h < 1 ||
        tile_w < 1 || xpad * 32 < turns || tile_w + 2 * xpad > kCols) {
        return cudaErrorInvalidValue;
    }
    const long long smem = window_smem(tile_h + 2 * turns, tile_w + 2 * xpad);
    cudaError_t err = allow_smem(tiled_skip_kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((wp + tile_w - 1) / tile_w, (h + tile_h - 1) / tile_h);
    const dim3 block(kCols, kSegs);
    tiled_skip_kernel<<<grid, block, static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), h, wp, turns, tile_h,
        tile_w, xpad, born, surv);
    return cudaGetLastError();
}
