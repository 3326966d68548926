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
//
// K11: the probing strip launch (gol_strip_probing_launch).  Replaces
// distributed_gol_tpu/parallel/pallas_halo.py::_ext_kernel_adaptive (its
// window load _dma_strip_window_in), the launch a skip_stable dispatch on
// a row mesh runs where the strip has an adaptive plan but no frontier
// plan.  K4 on one strip: the stripes do not wrap inside the strip; a
// window's rows above and below it come from the north and south buffers
// the exchange filled (window.cuh::StripSource); the elision reads the
// previous bitmap extended with the neighbour strips' edge flags, so it
// sees across the seam; the write elision writes into the strip's buffer
// of two launches ago.  The tiles and the probe are K4's.
//
// K13: the probing tile launch (gol_tile_probing_launch).  Replaces
// distributed_gol_tpu/parallel/pallas_halo.py::_ext_kernel_adaptive_2d,
// the launch a skip_stable dispatch on a 2-D mesh runs for its full
// launches where the tile has an adaptive plan.  The input is the tile
// pre-extended by the exchange (parallel/halo.py::extend): pad =
// round8(T) rows and xpad words a side, corners included.  The elision
// decision arrives precomputed (`elig`, the 3x3 conjunction of the
// previous launch's flags over the stripe and its neighbours across both
// mesh axes), so the kernel knows nothing of the mesh.  The JAX kernel
// steps each stripe's whole extended window with its lane rotate
// wrapping modulo the extended width wpe = wpl + 2*xpad, and its probe
// compares every column, the wrapped halo columns included.  K13 does the
// same with K4's tiles: they cover the extended width, read columns
// modulo wpe (TileSource), and their inner regions together are the JAX
// probe's region, so the flags agree with the JAX kernel's.  Only the
// centre columns are stored (TileSink): with T + 6 <= 32*xpad the wrap's
// error never reaches them.  The write elision is K11's: `out` is the
// tile's buffer of two launches ago.

#include "window.cuh"

namespace {

using namespace gol;

// Where a probing tile's centre goes.  BoardSink: a board or strip `in`
// of h x wp words into `out` of the same shape; a proved tile copies its
// centre through from `in` (the same words as the source there).
struct BoardSink {
    const uint32_t* in;
    uint32_t* out;
    int h, wp;
    __device__ void copy(int y0, int x0, int tile_h, int tile_w) const {
        copy_tile(in, out, h, wp, y0, x0, tile_h, tile_w);
    }
    __device__ void store(const uint32_t* win, const Window& w, int pad, int xpad, int y0, int x0,
                          int tile_h, int tile_w) const {
        store_centre(win, out, h, wp, w, pad, xpad, y0, x0, tile_h, tile_w);
    }
};

// K13's source: the pre-extended tile, (h_loc + 2*pad) x wpe words, with
// centre row y at extended row y + pad and word columns modulo wpe (the
// JAX kernel's lane rotate).  Windows stay within its rows.
struct TileSource {
    const uint32_t* ext;
    int wpe, pad;
    __device__ __forceinline__ uint32_t operator()(int y, int x) const {
        return ext[static_cast<size_t>(y + pad) * wpe + wrap(x, wpe)];
    }
};

// K13's sink: tile columns are extended columns; only those in the centre
// [xpad, xpad + wpl) are stored, at column x - xpad of the (h_loc, wpl)
// `out`.  A proved tile copies them from the extended tile.
struct TileSink {
    const uint32_t* ext;
    uint32_t* out;
    int h_loc, wpl, wpe, pad, xpad;
    __device__ void copy(int y0, int x0, int tile_h, int tile_w) const {
        for (int i = thread_id(); i < tile_h * tile_w; i += kThreads) {
            const int r = i / tile_w;
            const int c = i - r * tile_w;
            const int gy = y0 + r;
            const int gx = x0 + c - xpad;
            if (gy < h_loc && gx >= 0 && gx < wpl) {
                out[static_cast<size_t>(gy) * wpl + gx] =
                    ext[static_cast<size_t>(gy + pad) * wpe + x0 + c];
            }
        }
    }
    __device__ void store(const uint32_t* win, const Window& w, int halo, int xw, int y0, int x0,
                          int tile_h, int tile_w) const {
        for (int i = thread_id(); i < tile_h * tile_w; i += kThreads) {
            const int r = i / tile_w;
            const int c = i - r * tile_w;
            const int gy = y0 + r;
            const int gx = x0 + c - xpad;
            if (gy < h_loc && gx >= 0 && gx < wpl) {
                out[static_cast<size_t>(gy) * wpl + gx] = win[(r + halo) * w.cols + c + xw];
            }
        }
    }
};

// One tile of a probing launch, its stripe not elided: K3's probe on the
// window from `src` (pad-row halo, xpad-word column halo).  A tile that
// proves stable copies its centre through (`sink.copy`); one that fails
// clears the stripe's flag `*st` and stores its gen-T centre.
template <class Source, class Sink>
__device__ void probe_tile(uint32_t* smem, const Source& src, const Sink& sink, int* st,
                           int turns, int tile_h, int tile_w, int xpad, int pad, int y0, int x0,
                           uint32_t born, uint32_t surv) {
    const Window w{tile_h + 2 * pad, tile_w + 2 * xpad, y0 - pad, x0 - xpad};
    uint32_t* a = smem;
    uint32_t* b = smem + w.rows * w.cols;
    load_window(src, a, w);
    uint32_t* res = advance(a, b, w, kSkipPeriod, born, surv);
    if (inner_stable(res, src, w)) {
        sink.copy(y0, x0, tile_h, tile_w);
        return;
    }
    if (thread_id() == 0) *st = 0;
    res = advance(res, res == a ? b : a, w, turns - kSkipPeriod, born, surv);
    sink.store(res, w, pad, xpad, y0, x0, tile_h, tile_w);
}

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
    probe_tile(smem, BoardSource{in, h, wp}, BoardSink{in, out, h, wp}, &st[i], turns, tile_h,
               tile_w, xpad, pad, y0, x0, born, surv);
}

// K11: one strip of a row mesh.  `prev_ext` is the previous launch's
// bitmap of this strip's stripes with the neighbour strips' edge flags at
// both ends (grid + 2 entries: stripe i's sources are entries i, i + 1,
// i + 2); the window's rows outside the strip come from `north` and
// `south` (n rows each).
__global__ void __launch_bounds__(kThreads)
strip_probing_kernel(const uint32_t* __restrict__ local, const uint32_t* __restrict__ north,
                     const uint32_t* __restrict__ south, uint32_t* __restrict__ out,
                     const int* __restrict__ prev_ext, int* __restrict__ st, int h, int wp,
                     int n, int turns, int stripe_h, int tile_h, int tile_w, int xpad, int pad,
                     uint32_t born, uint32_t surv) {
    extern __shared__ uint32_t smem[];
    const int y0 = blockIdx.y * tile_h;
    const int x0 = blockIdx.x * tile_w;
    const int i = y0 / stripe_h;
    if (prev_ext[i] && prev_ext[i + 1] && prev_ext[i + 2]) return;  // elided: st[i] stays 1
    probe_tile(smem, StripSource{local, north, south, h, wp, n}, BoardSink{local, out, h, wp},
               &st[i], turns, tile_h, tile_w, xpad, pad, y0, x0, born, surv);
}

// K13: one tile of a 2-D mesh.  `ext` is the pre-extended tile,
// (h_loc + 2*pad) x (wpl + 2*xpad) words; `elig` this launch's elision
// flags (grid entries, the 3x3 conjunction); blocks tile the extended
// width, tile_w words with an xw-word window border (xw >= 1, so the
// tiles' inner regions cover every column).
__global__ void __launch_bounds__(kThreads)
tile_probing_kernel(const uint32_t* __restrict__ ext, uint32_t* __restrict__ out,
                    const int* __restrict__ elig, int* __restrict__ st, int h_loc, int wpl,
                    int xpad, int turns, int stripe_h, int tile_h, int tile_w, int xw, int pad,
                    uint32_t born, uint32_t surv) {
    extern __shared__ uint32_t smem[];
    const int y0 = blockIdx.y * tile_h;
    const int x0 = blockIdx.x * tile_w;
    const int i = y0 / stripe_h;
    if (elig[i]) return;  // elided: st[i] stays 1
    const int wpe = wpl + 2 * xpad;
    probe_tile(smem, TileSource{ext, wpe, pad}, TileSink{ext, out, h_loc, wpl, wpe, pad, xpad},
               &st[i], turns, tile_h, tile_w, xw, pad, y0, x0, born, surv);
}

bool bad_probing_plan(int h, int wp, int turns, int stripe_h, int tile_h, int tile_w, int xpad,
                      int pad) {
    return h < 1 || wp < 1 || turns < kSkipPeriod || turns % kSkipPeriod || stripe_h < 1 ||
           h % stripe_h || tile_h < 1 || stripe_h % tile_h || tile_w < 1 || pad < turns ||
           xpad * 32 < turns || tile_w + 2 * xpad > kCols;
}

}  // namespace

extern "C" int gol_probing_launch(const void* in, void* out, const void* prev, void* st, int h,
                                  int wp, int turns, int stripe_h, int tile_h, int tile_w,
                                  int xpad, int pad, unsigned born, unsigned surv,
                                  void* stream) {
    if (bad_probing_plan(h, wp, turns, stripe_h, tile_h, tile_w, xpad, pad)) {
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

// K11: `out` is the strip's buffer of two launches ago (an elided stripe
// leaves its rows as they are); `st` is set to all ones by the caller.
// The halo must lie within the neighbour buffers (pad <= n) and within one
// stripe (pad <= stripe_h), since stripe i's elision reads only the flags
// of stripes i - 1, i and i + 1.
extern "C" int gol_strip_probing_launch(const void* local, const void* north, const void* south,
                                        void* out, const void* prev_ext, void* st, int h, int wp,
                                        int n, int turns, int stripe_h, int tile_h, int tile_w,
                                        int xpad, int pad, unsigned born, unsigned surv,
                                        void* stream) {
    if (bad_probing_plan(h, wp, turns, stripe_h, tile_h, tile_w, xpad, pad) || pad > n ||
        pad > stripe_h) {
        return cudaErrorInvalidValue;
    }
    const long long smem = window_smem(tile_h + 2 * pad, tile_w + 2 * xpad);
    cudaError_t err = allow_smem(strip_probing_kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((wp + tile_w - 1) / tile_w, h / tile_h);
    const dim3 block(kCols, kSegs);
    strip_probing_kernel<<<grid, block, static_cast<size_t>(smem),
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(local), static_cast<const uint32_t*>(north),
        static_cast<const uint32_t*>(south), static_cast<uint32_t*>(out),
        static_cast<const int*>(prev_ext), static_cast<int*>(st), h, wp, n, turns, stripe_h,
        tile_h, tile_w, xpad, pad, born, surv);
    return cudaGetLastError();
}

// K13: `ext` is the (h_loc + 2*pad) x (wpl + 2*xpad) pre-extended tile,
// `out` the tile's buffer of two launches ago (an elided stripe leaves its
// rows as they are), `st` set to all ones by the caller.  The probe halo
// lies within one stripe (pad <= stripe_h: the 3x3 elision reads only the
// adjacent stripes' flags) and within the x-halo with the probe's reach
// (turns + 6 <= 32 * xpad, the JAX plan's x-depth rule).
extern "C" int gol_tile_probing_launch(const void* ext, void* out, const void* elig, void* st,
                                       int h_loc, int wpl, int xpad, int turns, int stripe_h,
                                       int tile_h, int tile_w, int xw, int pad, unsigned born,
                                       unsigned surv, void* stream) {
    if (bad_probing_plan(h_loc, wpl + 2 * xpad, turns, stripe_h, tile_h, tile_w, xw, pad) ||
        pad > stripe_h || xpad < 1 || xpad > wpl || turns + kSkipPeriod > 32 * xpad) {
        return cudaErrorInvalidValue;
    }
    const long long smem = window_smem(tile_h + 2 * pad, tile_w + 2 * xw);
    cudaError_t err = allow_smem(tile_probing_kernel, smem);
    if (err != cudaSuccess) return err;
    const int wpe = wpl + 2 * xpad;
    const dim3 grid((wpe + tile_w - 1) / tile_w, h_loc / tile_h);
    const dim3 block(kCols, kSegs);
    tile_probing_kernel<<<grid, block, static_cast<size_t>(smem),
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(ext), static_cast<uint32_t*>(out),
        static_cast<const int*>(elig), static_cast<int*>(st), h_loc, wpl, xpad, turns, stripe_h,
        tile_h, tile_w, xw, pad, born, surv);
    return cudaGetLastError();
}
