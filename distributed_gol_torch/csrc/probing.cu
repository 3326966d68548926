// K4: the probing kernel (gol_probing_launch).  Replaces
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
// - otherwise its blocks probe with the JAX kernel's halo pad = round8(T),
//   each on its window's inner region, and the union of a stripe's
//   blocks' regions is the region _probe_state tests on the stripe's
//   window (rows [6, stripe_h + 2*pad - 6) and every cell).  A block that
//   fails clears the stripe's flag: the flag is the AND over the stripe's
//   blocks, which is the JAX flag.
// Launch 1 of a run gets an all-zero `prev`, so it writes every stripe
// and both ping-pong buffers are defined before any elision.
//
// It is K11's and K13's register probing block (probe_reg_block) on a
// third source, the board itself read in place as the torus
// (BoardProbeSource: reg::column of a BoardSource, rows wrapping once
// around the board since pad <= stripe_h <= h, words modulo wp): no
// pre-extended copy.  A block divides a stripe or spans up to 32 whole
// stripes, as K11's (ops/cuda_adaptive.py::probing_reg_plan).  A board
// narrower than a warp's window wraps it onto itself as K11's strips do,
// each lane but the edge ones beside its true neighbours, and a board of
// one stripe is its own neighbour on both sides.
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
// same block by block: blocks cover the extended width, read columns
// modulo wpe, and their inner regions together are the JAX
// probe's region, so the flags agree with the JAX kernel's (a stripe's
// flag is the AND of its blocks' probes).  Only the centre columns are
// stored: with T + 6 <= 32*xpad the wrap's error never reaches them.  The
// write elision: `out` is the tile's buffer of two launches ago, whose
// rows an elided stripe leaves as they are.
//
// K11: the probing strip launch (gol_strip_probing_launch).  Replaces
// distributed_gol_tpu/parallel/pallas_halo.py::_ext_kernel_adaptive (its
// window load _dma_strip_window_in, built by _build_ext_launch_adaptive),
// the launch a skip_stable dispatch on a row mesh runs where the strip has
// an adaptive plan but no frontier plan, and the in-kernel tier's loose
// tail.  It is K13's register block (probe_reg_block, in
// strip_probing_reg_kernel) on another source: the strip itself, its
// window rows above and below it from the north and south buffers the
// exchange filled (reg::column of a StripSource), read in place, no
// pre-extended copy.  A strip spans the board's width, so its columns
// wrap modulo wp, the true torus, and it has no x-halo: a window of 32
// words from one left of its 30 centre words wraps onto itself where wp <
// 30, each lane but the edge ones still beside its true neighbours, so
// the error stays within the window's edge words as on a wide strip.  Stripe
// i elides when the previous bitmap extended with the neighbour strips'
// edge flags has entries i, i + 1 and i + 2 set; the write elision writes
// into the strip's buffer of two launches ago.
//
// What bounds K4, K13 and K11 on an H100: integer operations on the
// stripes they compute (6 + T generations where the probe fails, 6 where
// it passes), nothing on the stripes they elide; a settled K13 launch,
// whose stripes at the wrap still fail the probe, lasts as long as its
// slowest block, and a settled K4 or K11 launch, whose every stripe
// elides, as long as its grid's early returns.
//
// Their design (regwin.cuh; K11's since it took K13's kernel, K4's since
// it took K11's), for each factor between the first port's time and that
// bound:
// - The generation loop: a block is `warps` warps stacked over one
//   32-word window column, each thread a run of 32 rows in registers;
//   neighbour words by shuffle, only run edges through shared memory, one
//   barrier a generation, the rule a template argument (B3/S23 and
//   B36/S23 at compile time, any other through AnyRule).
// - The grid: several blocks share an SM (at most 512 threads, 64
//   registers a thread), and the plan (ops/cuda_adaptive.py::
//   stripe_reg_plan) splits each stripe into the blocks whose grid fills
//   the card's SMs in the fewest, fullest waves; shorter blocks also
//   shorten a settled launch, which waits for its slowest block.
// - The redundant work: 30 of a warp's 32 words are centre, and after the
//   probe (which needs the whole window at generation 6) each run steps
//   only the chunks of 8 rows within T - g rows of the block's tile.  A
//   K4 or K11 block may span several whole stripes
//   (cuda_adaptive.probing_reg_plan),
//   each probed on its own region, so a short stripe's 2·pad rows of halo
//   are shared by its neighbours: path (g)'s 16-row stripes with a 16-row
//   halo take 8 a block.
// K13 compiles the block with kStripes false (one stripe a block, as its
// plan tile_reg_plan makes them).

#include "regwin.cuh"

namespace {

using namespace gol;

// K13's column: words `stride` apart, row y (the centre's row frame,
// which starts pad rows above the pre-extended tile's centre) at
// c[y * stride].
struct Strided {
    const uint32_t* c;
    int stride;
    __device__ __forceinline__ uint32_t operator()(int y) const {
        return c[static_cast<ptrdiff_t>(y) * stride];
    }
};

// The sources of probe_reg_block.  Each says whether stripe i elides and
// how wide its rows are (the blocks' column groups cover them), and gives
// word column x (unwrapped) of the window rows over the centre's row
// frame (row r of a block at centre row y0 is y0 - pad + r).
//
// K13: the pre-extended tile, (h + 2*pad) x wpe words with columns modulo
// wpe (the JAX kernel's lane rotate), every window row in it, and this
// launch's elision flags.
struct ExtTileSource {
    const uint32_t* ext;
    const int* elig;
    int h, pad, wpe;
    __device__ __forceinline__ bool elided(int i) const { return elig[i]; }
    __host__ __device__ __forceinline__ int width() const { return wpe; }
    __device__ __forceinline__ Strided column(int x) const {
        return Strided{ext + static_cast<size_t>(pad) * wpe + wrap(x, wpe), wpe};
    }
};

// K11: a strip of a row mesh and its neighbour rows, columns modulo wp, and
// the previous bitmap with the neighbour strips' edge flags at both ends
// (grid + 2 entries: stripe i's sources are entries i, i + 1, i + 2); the
// windows of the strip's edge stripes read the north or south buffer.
struct StripProbeSource {
    StripSource strip;
    const int* prev_ext;
    __device__ __forceinline__ bool elided(int i) const {
        return prev_ext[i] && prev_ext[i + 1] && prev_ext[i + 2];
    }
    __host__ __device__ __forceinline__ int width() const { return strip.wp; }
    __device__ __forceinline__ reg::Column column(int x) const { return reg::column(strip, x); }
};

// K4: the whole board, a torus of h rows read in place (rows wrap once
// around it: pad <= stripe_h <= h), words modulo wp, and the previous
// bitmap, whose stripes wrap around the stripe count `grid`.  `elided`
// stays out of line: inlined at its three call sites around the
// generation loops, it pushed the block past 64 registers (ptxas spilled
// 12-28 bytes, whether it wrapped by modulo, by compare or read an
// extended bitmap as K11 does); out of line no instantiation spills, and
// it runs only outside the loops, once a stripe.
struct BoardProbeSource {
    BoardSource board;
    const int* prev;
    int grid;
    __device__ __noinline__ bool elided(int i) const {
        const int left = i == 0 ? grid - 1 : i - 1;
        const int right = i + 1 == grid ? 0 : i + 1;
        return prev[left] && prev[i] && prev[right];
    }
    __host__ __device__ __forceinline__ int width() const { return board.wp; }
    __device__ __forceinline__ reg::Column column(int x) const { return reg::column(board, x); }
};

// Bit j: stripe s0 + j of a block spanning `ns` stripes computes (its
// elision does not hold).
template <class Source>
__device__ __forceinline__ uint32_t live_stripes(const Source& src, int s0, int ns) {
    uint32_t live = 0u;
    for (int j = 0; j < ns; ++j) {
        if (!src.elided(s0 + j)) live |= 1u << j;
    }
    return live;
}

// The probe of a block spanning ns >= 2 whole stripes, each on its own
// region: bit j set where window rows [j * stripe_h + 6, (j + 1) * stripe_h +
// 2 * pad - 6) (the JAX probe's region of stripe j's window) differ from
// generation 0 (`from(row)`) in a cell at least 6 from the window's x edge
// (reg::inner_stable's masks).  Each thread gathers its changed rows as
// bits and tests each stripe's range of them; the warps' ORs meet in the
// shared word `flags` (zero on entry) behind one barrier.  The same value
// in every thread.
template <class Load>
__device__ uint32_t unstable_stripes(const uint32_t (&s)[reg::kRun], const reg::Run& run,
                                     const Load& from, int ns, int stripe_h, int pad,
                                     uint32_t* flags) {
    uint32_t mask = 0xffffffffu;
    if (run.lane == 0) mask = 0xffffffc0u;
    if (run.lane == reg::kLanes - 1) mask = 0x03ffffffu;
    uint32_t changed = 0u;
#pragma unroll
    for (int i = 0; i < reg::kRun; ++i) {
        if ((s[i] ^ from(run.row(i))) & mask) changed |= 1u << i;
    }
    const int top = run.row(0);
    uint32_t bits = 0u;
    for (int j = 0; j < ns; ++j) {
        const int lo = max(j * stripe_h + kSkipPeriod - top, 0);
        const int hi = min((j + 1) * stripe_h + 2 * pad - kSkipPeriod - top, reg::kRun);
        if (lo < hi && ((changed >> lo) << (reg::kRun - (hi - lo))) != 0u) bits |= 1u << j;
    }
    bits = __reduce_or_sync(reg::kFull, bits);
    if (run.lane == 0 && bits) atomicOr(flags, bits);
    __syncthreads();
    return *flags;
}

// K13, K11 and K4: one block per (row tile, column group) of the source; a
// row tile is a divisor of a stripe or several whole stripes (K11, K4).
// Its window is warps * 32 rows from pad rows above its tile (the tile's
// rows and pad rows a side matter) by the 32 columns from x0 - 1, of
// which the middle 30 are the group's.  Each thread keeps its run at
// generation 0 in shared memory (`kept`) for the probe (reg::keep), which
// so reads no global memory again.  A block whose stripes all elide does
// nothing.  Otherwise it probes at generation 6: a block within a stripe
// on its window's inner region, a block of several stripes each on its
// own region; each stripe that fails clears its flag (a stripe's flag is
// the AND of its blocks'), and if one that computes failed, the block
// steps on to T.  A block whose computing stripes passed keeps its window
// at generation 6, whose inner regions (the stored rows included) equal
// its input; a stripe that passed in a block that steps on is exact at T
// by the same proof.  The rows of the stripes that compute, inside the
// source's centre columns [xpad, xpad + wpl), are stored into `out`, wpl
// words a row.
template <bool kStripes, class Rule, class Source>
__device__ __forceinline__ void probe_reg_block(const Source& src, uint32_t* __restrict__ out,
                                                int* __restrict__ st, int wpl, int xpad,
                                                int turns, int stripe_h, int tile_h, int pad,
                                                const Rule& rule, reg::Edges& edges,
                                                uint32_t* kept, uint32_t* flags) {
    const int y0 = blockIdx.y * tile_h;
    // Stripes of the block: blocks of several stripes only where kStripes.
    const int ns = kStripes ? max(tile_h / stripe_h, 1) : 1;
    if (!live_stripes(src, y0 / stripe_h, ns)) return;  // elided: their flags stay 1
    const reg::Run run = reg::Run::make(tile_h + 2 * pad, pad, turns, kSkipPeriod);
    uint32_t s[reg::kRun];
    {
        // The column is made anew for the store: nothing of it holds a
        // register through the loop.
        const auto col = src.column(reg::block_x() * (reg::kLanes - 2) - 1 + run.lane);
        reg::load(s, run, [&](int r) { return col(y0 - pad + r); });
    }
    reg::keep(s, run, kept);
    // Zeroed before advance's barriers, which order it before any atomicOr.
    if (kStripes && threadIdx.x == 0 && threadIdx.y == 0) *flags = 0u;
    reg::advance(s, edges, run, 1, kSkipPeriod, rule);
    const auto gen0 = [&](int r) { return kept[r * reg::kLanes + run.lane]; };
    const int s0 = reg::block_y() * tile_h / stripe_h;
    const uint32_t unstable =
        ns == 1 ? (reg::inner_stable(s, run, gen0) ? 0u : 1u)
                : unstable_stripes(s, run, gen0, ns, stripe_h, pad, flags) &
                      live_stripes(src, s0, ns);
    if (unstable) {
        if (run.lane == 0 && run.warp == 0) {
            for (int j = 0; j < ns; ++j) {
                if ((unstable >> j) & 1u) st[s0 + j] = 0;
            }
        }
        reg::advance(s, edges, run, kSkipPeriod + 1, turns, rule);
    }
    const int col = reg::block_x() * (reg::kLanes - 2) - 1 + run.lane;
    const int gx = col - xpad;
    const bool centre = run.lane >= 1 && run.lane < reg::kLanes - 1 && col < src.width() &&
                        gx >= 0 && gx < wpl;
    if constexpr (!kStripes) {
#pragma unroll
        for (int k = 0; k < reg::kRun; ++k) {
            const int r = run.row(k) - pad;
            if (centre && r >= 0 && r < tile_h) {
                out[static_cast<size_t>(reg::block_y() * tile_h + r) * wpl + gx] = s[k];
            }
        }
        return;
    }
    // This thread's rows' stripe in the block, advanced as they cross a
    // stripe's last row; only the stripes that compute are stored.
    const uint32_t live = ns == 1 ? 1u : live_stripes(src, reg::block_y() * tile_h / stripe_h, ns);
    const int r0 = run.row(0) - pad;
    int j = r0 > 0 ? r0 / stripe_h : 0;
    int next = (j + 1) * stripe_h;
#pragma unroll
    for (int k = 0; k < reg::kRun; ++k) {
        const int r = run.row(k) - pad;
        if (r >= next) {
            ++j;
            next += stripe_h;
        }
        if (centre && r >= 0 && r < tile_h && ((live >> j) & 1u)) {
            out[static_cast<size_t>(reg::block_y() * tile_h + r) * wpl + gx] = s[k];
        }
    }
}

// K13: probe_reg_block on the pre-extended tile, blocks within a stripe.
template <class Rule>
__global__ void __launch_bounds__(reg::kMaxThreads, 2)
tile_probing_reg_kernel(const ExtTileSource src, uint32_t* __restrict__ out,
                        int* __restrict__ st, int wpl, int xpad, int turns, int stripe_h,
                        int tile_h, int pad, Rule rule) {
    __shared__ reg::Edges edges;
    extern __shared__ uint32_t kept[];  // the window at generation 0 (reg::keep)
    probe_reg_block<false>(src, out, st, wpl, xpad, turns, stripe_h, tile_h, pad, rule, edges,
                           kept, nullptr);
}

// K11: probe_reg_block on the strip and its neighbour rows (xpad 0, wpl =
// wp: every column is centre), blocks within a stripe or of several.
template <class Rule>
__global__ void __launch_bounds__(reg::kMaxThreads, 2)
strip_probing_reg_kernel(const StripProbeSource src, uint32_t* __restrict__ out,
                         int* __restrict__ st, int wpl, int xpad, int turns, int stripe_h,
                         int tile_h, int pad, Rule rule) {
    __shared__ reg::Edges edges;
    __shared__ uint32_t flags;          // the stripes' probes (unstable_stripes)
    extern __shared__ uint32_t kept[];  // the window at generation 0 (reg::keep)
    probe_reg_block<true>(src, out, st, wpl, xpad, turns, stripe_h, tile_h, pad, rule, edges,
                          kept, &flags);
}

// K4: probe_reg_block on the board in place (xpad 0, wpl = wp: every
// column is centre), blocks within a stripe or of several.
template <class Rule>
__global__ void __launch_bounds__(reg::kMaxThreads, 2)
board_probing_reg_kernel(const BoardProbeSource src, uint32_t* __restrict__ out,
                         int* __restrict__ st, int wpl, int xpad, int turns, int stripe_h,
                         int tile_h, int pad, Rule rule) {
    __shared__ reg::Edges edges;
    __shared__ uint32_t flags;          // the stripes' probes (unstable_stripes)
    extern __shared__ uint32_t kept[];  // the window at generation 0 (reg::keep)
    probe_reg_block<true>(src, out, st, wpl, xpad, turns, stripe_h, tile_h, pad, rule, edges,
                          kept, &flags);
}

// Launch `pick(rule)` (K13's, K11's or K4's kernel in the rule's
// instantiation, `variant`: regwin.cuh::by_rule) on `src` (h centre rows,
// src.width() columns); `warps` warps of 32 rows hold a block's window
// (tile_h + 2 * pad rows).
template <class Source, class Pick>
int launch_probing_reg(const Source& src, const Pick& pick, void* out, void* st, int h, int wpl,
                       int xpad, int turns, int stripe_h, int tile_h, int warps, int pad,
                       int variant, unsigned born, unsigned surv, void* stream) {
    const dim3 grid((src.width() + reg::kLanes - 3) / (reg::kLanes - 2), h / tile_h);
    const dim3 block(reg::kLanes, warps);
    const long long smem = 4LL * warps * reg::kRun * reg::kLanes;  // reg::keep's words
    return reg::by_rule(variant, born, surv, [&](auto rule) {
        const auto kernel = pick(rule);
        const cudaError_t err = allow_smem(kernel, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        kernel<<<grid, block, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
            src, static_cast<uint32_t*>(out), static_cast<int*>(st), wpl, xpad, turns, stripe_h,
            tile_h, pad, rule);
        return static_cast<int>(cudaGetLastError());
    });
}

// A register probing launch's common refusals: T a multiple of 6 up to 32,
// whole stripes of whole row tiles, a row tile that divides a stripe or
// is up to 32 whole stripes (a probe's bits), a probe halo of at least T
// rows within one stripe (the elision reads only the adjacent stripes'
// flags), and a window of `warps` warps that holds a block's tile_h +
// 2 * pad rows.
bool bad_reg_probing_plan(int h, int width, int turns, int stripe_h, int tile_h, int warps,
                          int pad) {
    return h < 1 || width < 1 || turns < kSkipPeriod || turns % kSkipPeriod || turns > 32 ||
           stripe_h < 1 || h % stripe_h || tile_h < 1 || h % tile_h ||
           (stripe_h % tile_h && tile_h % stripe_h) || tile_h / stripe_h > 32 || pad < turns ||
           pad > stripe_h || warps < 1 || warps > reg::kMaxWarps ||
           warps * reg::kRun < tile_h + 2 * pad;
}

}  // namespace

// K4: `in` is the board (h x wp words, read as the torus), `out` its
// buffer of two launches ago (an elided stripe leaves its rows as they
// are), `prev` the previous launch's bitmap and `st` this launch's, set to
// all ones by the caller (h / stripe_h entries each); a block is `tile_h`
// rows, a divisor of a stripe or up to 32 whole stripes, and `warps` warps
// of 32 rows hold its window (tile_h + 2 * pad rows); `variant` picks the
// rule's instantiation (regwin.cuh::by_rule).
extern "C" int gol_probing_launch(const void* in, void* out, const void* prev, void* st, int h,
                                  int wp, int turns, int stripe_h, int tile_h, int warps,
                                  int pad, int variant, unsigned born, unsigned surv,
                                  void* stream) {
    if (bad_reg_probing_plan(h, wp, turns, stripe_h, tile_h, warps, pad)) {
        return cudaErrorInvalidValue;
    }
    const BoardProbeSource src{BoardSource{static_cast<const uint32_t*>(in), h, wp},
                               static_cast<const int*>(prev), h / stripe_h};
    const auto pick = [](auto rule) { return board_probing_reg_kernel<decltype(rule)>; };
    return launch_probing_reg(src, pick, out, st, h, wp, 0, turns, stripe_h, tile_h, warps, pad,
                              variant, born, surv, stream);
}

// K11: `local` is the strip (h x wp words), `north` and `south` its
// neighbours' boundary rows (n each, pad <= n), `out` the strip's buffer
// of two launches ago (an elided stripe leaves its rows as they are),
// `prev_ext` the previous bitmap with the neighbours' edge flags (grid + 2
// entries), `st` set to all ones by the caller; a block is `tile_h` rows,
// a divisor of a stripe or up to 32 whole stripes, and `warps` warps of 32
// rows hold its window (tile_h + 2 * pad rows).
extern "C" int gol_strip_probing_launch(const void* local, const void* north, const void* south,
                                        void* out, const void* prev_ext, void* st, int h, int wp,
                                        int n, int turns, int stripe_h, int tile_h, int warps,
                                        int pad, int variant, unsigned born, unsigned surv,
                                        void* stream) {
    if (bad_reg_probing_plan(h, wp, turns, stripe_h, tile_h, warps, pad) || pad > n) {
        return cudaErrorInvalidValue;
    }
    const StripProbeSource src{
        StripSource{static_cast<const uint32_t*>(local), static_cast<const uint32_t*>(north),
                    static_cast<const uint32_t*>(south), h, wp, n},
        static_cast<const int*>(prev_ext)};
    const auto pick = [](auto rule) { return strip_probing_reg_kernel<decltype(rule)>; };
    return launch_probing_reg(src, pick, out, st, h, wp, 0, turns, stripe_h, tile_h, warps, pad,
                              variant, born, surv, stream);
}

// K13: `ext` is the (h_loc + 2*pad) x (wpl + 2*xpad) pre-extended tile,
// `out` the tile's buffer of two launches ago (an elided stripe leaves its
// rows as they are), `st` set to all ones by the caller.  The probe halo
// lies within one stripe (pad <= stripe_h: the 3x3 elision reads only the
// adjacent stripes' flags) and within the x-halo with the probe's reach
// (turns + 6 <= 32 * xpad, the JAX plan's x-depth rule); a block is
// `tile_h` rows of one stripe (tile_h divides it) and `warps` warps of 32
// rows hold its window (tile_h + 2 * pad rows); `variant` picks the rule's
// instantiation (regwin.cuh::by_rule).
extern "C" int gol_tile_probing_launch(const void* ext, void* out, const void* elig, void* st,
                                       int h_loc, int wpl, int xpad, int turns, int stripe_h,
                                       int tile_h, int warps, int pad, int variant,
                                       unsigned born, unsigned surv, void* stream) {
    if (bad_reg_probing_plan(h_loc, wpl, turns, stripe_h, tile_h, warps, pad) ||
        tile_h > stripe_h || xpad < 1 || xpad > wpl || turns + kSkipPeriod > 32 * xpad) {
        return cudaErrorInvalidValue;
    }
    const int wpe = wpl + 2 * xpad;
    const ExtTileSource src{static_cast<const uint32_t*>(ext), static_cast<const int*>(elig), h_loc,
                            pad, wpe};
    const auto pick = [](auto rule) { return tile_probing_reg_kernel<decltype(rule)>; };
    return launch_probing_reg(src, pick, out, st, h_loc, wpl, xpad, turns, stripe_h, tile_h,
                              warps, pad, variant, born, surv, stream);
}
