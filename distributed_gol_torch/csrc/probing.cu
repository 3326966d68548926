// K4: the probing kernel.  Replaces
// distributed_gol_tpu/ops/pallas_packed.py::_kernel_adaptive (body
// _route_active), the per-launch adaptive form that _run_tiled runs for
// the tail of a dispatch below one frontier chunk, and for every launch on
// a geometry with no frontier plan.
//
// One launch advances T generations (a multiple of 6) of a board cut into
// row stripes of stripe_h rows.  It takes the previous launch's per-stripe
// stable bitmap `prev` and writes this launch's, `st`, which the wrapper
// sets to all ones before the launch:
// - a stripe whose own flag and both neighbours' flags (mod the stripe
//   count) were 1 does nothing: flag 1, no read, no write.  Its rows in
//   `out` — the buffer written two launches ago — already hold the state
//   of two launches ago, which equals this launch's (write elision);
// - otherwise every tile of the stripe probes as K3 does, with the JAX
//   kernel's halo pad = round8(T), so that the inner region each tile
//   tests is a piece of the region _probe_state tests on the stripe's
//   window (rows [6, stripe_h + 2*pad - 6) and every cell), and their
//   union is all of it.  A tile that fails clears the stripe's flag: the
//   flag is the AND over the stripe's tiles, which is the JAX flag.
//
// Tiles are 2-D (row sub-tiles of a stripe x word columns with a one-word
// column halo), so a stripe of any height fits shared memory; every tile
// writes its centre (the input when its own probe passed — exact by the
// same proof).  Launch 1 of a run gets an all-zero `prev`, so it writes
// every stripe and both ping-pong buffers are defined before any elision.
//
// What bounds it: integer operations on the stripes it computes (6 + T
// generations on a failed probe, 6 on a passed one) and nothing on the
// stripes it elides.

#include "window.cuh"

namespace {

using namespace gol;

__global__ void __launch_bounds__(kThreads)
probing_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
               const int* __restrict__ prev, int* __restrict__ st, int h, int wp, int turns,
               int stripe_h, int tile_h, int tile_w, int xpad, int pad, uint32_t born,
               uint32_t surv) {
    extern __shared__ uint32_t smem[];
    const int grid = h / stripe_h;
    const int y0 = blockIdx.y * tile_h;
    const int x0 = blockIdx.x * tile_w;
    const int i = y0 / stripe_h;
    const int left = (i + grid - 1) % grid;
    const int right = (i + 1) % grid;
    if (prev[left] && prev[i] && prev[right]) return;  // elided: st[i] stays 1

    const Window w{tile_h + 2 * pad, tile_w + 2 * xpad, y0 - pad, x0 - xpad};
    uint32_t* a = smem;
    uint32_t* b = smem + w.rows * w.cols;
    load_window(in, a, h, wp, w);
    uint32_t* res = advance(a, b, w, kSkipPeriod, born, surv);
    if (inner_stable(res, in, h, wp, w)) {
        copy_tile(in, out, h, wp, y0, x0, tile_h, tile_w);
        return;
    }
    if (thread_id() == 0) st[i] = 0;
    res = advance(res, res == a ? b : a, w, turns - kSkipPeriod, born, surv);
    store_centre(res, out, h, wp, w, pad, xpad, y0, x0, tile_h, tile_w);
}

}  // namespace

extern "C" int gol_probing_launch(const void* in, void* out, const void* prev, void* st, int h,
                                  int wp, int turns, int stripe_h, int tile_h, int tile_w,
                                  int xpad, int pad, unsigned born, unsigned surv,
                                  void* stream) {
    if (h < 1 || wp < 1 || turns < kSkipPeriod || turns % kSkipPeriod || stripe_h < 1 ||
        h % stripe_h || tile_h < 1 || stripe_h % tile_h || tile_w < 1 || pad < turns ||
        xpad * 32 < turns || tile_w + 2 * xpad > kCols) {
        return cudaErrorInvalidValue;
    }
    const long long smem = window_smem(tile_h + 2 * pad, tile_w + 2 * xpad);
    cudaError_t err = allow_smem(probing_kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((wp + tile_w - 1) / tile_w, h / tile_h);
    const dim3 block(kCols, kSegs);
    probing_kernel<<<grid, block, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
        static_cast<const int*>(prev), static_cast<int*>(st), h, wp, turns, stripe_h, tile_h,
        tile_w, xpad, pad, born, surv);
    return cudaGetLastError();
}
