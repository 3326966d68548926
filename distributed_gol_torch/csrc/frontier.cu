// The frontier kernels: K5 and K8 (gol_frontier_batched_launch), K12
// (gol_strip_frontier_launch), K14 (gol_strip_mega_launch) and K15
// (gol_tile_mega_launch).  Each replaces a Pallas kernel of the JAX
// package that runs the tracked-interval skip/compute/measure state
// machine of a skip_stable dispatch, and each steps its windows in
// registers (regwin.cuh's frontier window).
//
// K5: replaces distributed_gol_tpu/ops/pallas_packed.py::
// _kernel_frontier_mega (its decisions _hit_union, _frontier_placement and
// _col_placement, its measure _measure2, its routes and change-rectangle
// writes), the kernel _run_tiled runs for whole chunks of launches.  The
// TPU kernel runs a chunk of launches as one pallas_call with the
// per-stripe state in SMEM.  Here one launch (T generations, T a multiple
// of 6, T + 6 <= 30) is two CUDA kernels chained on the stream, and the
// state lives in device memory, so there is no host round trip between
// launches:
//
//   state   int32[2][10][grid]: per launch parity, each stripe's two
//           tracked row intervals (lo0, hi0, lo1, hi1; empty = (2^30, -1),
//           board rows, inside the stripe), its column interval (clo, chi,
//           board words) and its change rectangle (r8, n8, c128, n128: the
//           cells its launch may have changed, in chunks of 8 rows and 128
//           words);
//   rowflag int32[H], colspan int32[grid][2]: the measure's rows and each
//           stripe's least and greatest word, cleared between launches;
//   route   int32[grid]: each stripe's route this launch;
//   skipped int32[1], act int32[grid]: the skip count and the per-stripe
//           activity, accumulated over the chunk.
//
// frontier_reg_kernel, one block per (row tile of a stripe, column group
// of 30 words).  One thread of each block decides for its stripe, as the
// TPU kernel does, with the same arithmetic (its idx8 * 8 and cidx * 128
// floors), so each stripe takes the TPU kernel's route:
// - from the neighbour stripes' state of the previous parity (rows placed
//   in this stripe's frame across the torus wrap), `hit` and the clamped
//   row and column unions (_hit_union, reach pad_f = round8(T + 6));
//   launch 0 of a chunk forces hit and the maximal union;
// - the routes, at the plan geometry (cuda_adaptive.frontier_geometry:
//   a sub-window of sub_rows = round8(4T + margin) rows, a column window
//   of col_window words): skip where it does not hit; the RECTANGLE route
//   where the measure fits the sub-window's validity rows, the column
//   union and its reach fit the column window's validity words, and the
//   window lies inside the board; else the ROW tier where the rows fit;
//   else the FULL window;
// - the writes (the change-rectangle protocol): launch l reads the board
//   written at l - 1 and writes the buffer written at l - 2, and a stripe
//   writes only C(l - 1) and C(l), its previous and its new change
//   rectangle.  A skipped stripe copies C(l - 1) from its input (twice
//   skipped, it does nothing); the rectangle route copies C(l - 1) and
//   writes the window's rows of its centre, col_window words (gen T in
//   the window's validity region, rows and words at least T and
//   ceil((T + 6) / 32) words inside it, its input elsewhere), and
//   publishes them; the row tier and the full window write the whole
//   centre (gen T in the sub-window's validity rows, or everywhere) and
//   publish it.
// There is no staging: a block steps its whole window from the read
// buffer, and only blocks whose tile meets the cells their stripe writes
// as gen T step at all; the others copy what their stripe copies.  Cells
// in a validity region are the true state at gen T (their light cone lies
// in the window), so stepping the block's own window gives the TPU
// kernel's values there; the 128-word quantum lives only in the decision
// arithmetic.  A stepping block keeps gen T, steps 6 more, flags the rows
// of its measure region (the JAX m_lo..m_hi; on the rectangle route only
// the column window's validity words) where gen T + 6 differs from gen T,
// widens its stripe's column extremes, and stores its written cells.
// frontier_finalize, one block per stripe: turns the stripe's row flags
// into the two intervals of _measure2 (split at the midpoint of the
// stripe-wide span) and its extremes into its column interval, counts the
// stripe active when the first is nonempty, and clears both.
//
// K8: the same kernel on a contiguous stack of B same-shape boards, the
// nboards > 1 form of _kernel_frontier_mega (its leading grid axis over
// boards stacked along the row axis, driven by _run_tiled_batched),
// blockIdx.z the board.  Every array gains the board axis, indexed
// board-globally as the JAX kernel's gi = b * grid + i: state
// int32[2][10][B * grid], rowflag int32[B * H], skipped int32[B] (one count
// per board), act int32[B * grid].  Each board is its own torus: block
// (., ., b) reads board b's words (its column wraps within the board), its
// neighbour stripes i +- 1 mod grid and its interval placement across the
// wrap all stay inside board b, and the rectangle route's window inside
// its rows; a dead board beside a live one is never read.  Board b's rows
// and rectangles are in its own frame.  K5 is this kernel with B = 1.
//
// K12: the frontier strip launch.  Replaces
// distributed_gol_tpu/parallel/pallas_halo.py::_ext_kernel_frontier, the
// launch a skip_stable dispatch on a row mesh runs for every full launch
// where the strip has a frontier plan.  K5 on one strip, state in the
// strip's row frame: stripes 0 and grid - 1 take their outer neighbours'
// intervals (rows and columns) from an extended array that the exchange
// fills from the neighbour strips' edge stripes (rows shifted by -/+
// h_loc, so nothing wraps inside the strip); a window's rows outside the
// strip come from the north and south buffers (window.cuh::StripSource);
// the first launch of a dispatch starts from full intervals, as the JAX
// make_superstep does.  It takes _frontier_body's three tiers (the
// column window, the row tier, the full window) with the ps write
// protocol: a stripe that hits writes its whole centre, one that skips
// copies it if it computed last launch.
//
// K14: the strip megakernel.  Replaces
// distributed_gol_tpu/parallel/pallas_halo.py::_kernel_frontier_mega_strip,
// the in-kernel exchange tier of a skip_stable dispatch on a row mesh: on
// a TPU one pallas_call per device runs a chunk of launches, shipping
// round8(T + 6) boundary rows and its edge stripes' intervals to both
// y-neighbours between launches by remote DMA.  Here a launch covers the
// strips a table of shard ids names (blockIdx.z indexes the table): on
// one card the table names every strip, and the exchange happens inside
// the launch; in the peer form (strips on several cards of one process,
// its remote build) each card launches over its own strips.  A window's
// rows past its strip's edge are read straight from the neighbour strip's
// read buffer (window.cuh::StripSource, north and south the neighbours'
// whole buffers), and an edge stripe takes its outer neighbour's
// intervals from the neighbour strip's entries of the one state array,
// rows shifted by -/+ h_loc into its own row frame (MeshIntervals).  The
// pointer tables hold every strip's buffers and the state array lies on
// the mesh's first card: a neighbour's buffer on another card, or the
// state, is read and written through CUDA peer access (with unified
// addressing a peer pointer is a pointer), so nothing is copied between
// launches.  Stream order between the chained launches of one card, and
// an event from each neighbour card's previous launch (the caller's,
// cuda_halo.py), stand in for the TPU kernel's semaphores and entry
// barrier, the two write buffers and the two state parities for its
// parity slots.  Every array gains the strip axis as K8's gains the board
// axis, each card touching only its strips' entries, so K8's finalize
// serves, over the launch's shard ids.  Its routes and writes are K5's,
// the rectangle route's window inside the strip's own rows (an edge
// window takes the row tier, whose window reads the neighbour strips).
// With ny = 1 the strip is its own neighbour: the JAX package's loopback
// build.
//
// K15: the 2-D megakernel.  Replaces
// distributed_gol_tpu/parallel/pallas_halo.py::_kernel_frontier_mega_2d,
// the in-kernel exchange tier of a skip_stable dispatch on an (ny, nx)
// mesh, whose TPU form ships N/S rows, E/W word columns, four corner
// blocks and both x-neighbours' interval state over ten remote-DMA
// channels every launch.  Here a launch covers the tiles its table of
// shard ids names (blockIdx.z indexes the table; tile v = dy * nx + dx):
// every tile on one card, or one card's tiles in the peer form, as for
// K14.  A window reads whatever it needs past its tile's edges straight
// from the neighbour tiles' read buffers, corners included
// (window.cuh::MeshTileSource; on a mesh of cards the diagonal neighbour
// may be a third card), and a stripe decides from nine tracked states in
// the one state array
// (TorusTileIntervals: its own stripes i - 1..i + 1 and those of the W and
// E tiles, whose column intervals move by -/+ wp into the tile's words).
// The arrays gain the tile axis as K14's gain the strip axis, so K8's
// finalize serves, over the launch's shard ids.  An interior stripe takes K5's routes (the
// JAX kernel's rectangle route, whose window stays inside the tile's rows
// and words, the row tier, the full window) and writes, copies and
// publishes as K5 does; its column interval is measured in the tile's own
// words, as _frontier_body(xpad=) publishes it.
//
// The JAX kernel forces a tile's first and last stripes to compute every
// launch, since its y-neighbours' interval state never crosses the wire.
// A forced stripe always takes the full route there: its union reaches
// T + 6 rows past the centre on both sides, and the row tier would need
// sub_rows > stripe_h + pad_f + T + 5, which the geometry gate
// (sub_rows + 64 <= stripe_h + 2 pad_f) rules out since pad_f =
// round8(T + 6).  Here that state lies in the same array, so an edge
// stripe also decides, by an explicit branch (forced_route): its
// neighbours past the tile's edge are the N (or S) tile row's edge
// stripes, moved into its row frame, which makes its nine the 3x3-tile
// neighbourhood.  An edge
// stripe that hits computes its full window with the maximal measure rows,
// as the JAX kernel's forced one; one that does not is proved stable, so
// its gen-T and gen-(T + 6) rows equal its input and the JAX kernel's
// measure of it is empty: it computes nothing, writes empty intervals (its
// rows stay unflagged) and, to keep the skip count, the activity and the
// state the JAX kernel's, counts as computed (it copies its previous change
// rectangle, as a skipped stripe does, and publishes its whole centre).
// Launch 0 of a chunk forces every stripe to the full route.  K14 never
// forced its edge stripes, so it has no such elision.
//
// The window (regwin.cuh): a block is `warps` warps over a tile of
// `tile_h` rows of one stripe (a divisor of it) with T + 6 rows a side,
// and one 32-word column group whose middle 30 words are its centre
// (T + 6 <= 30 < 32: one border word a side holds the lanes' wrap error,
// and a board narrower than 30 words wraps inside the group, its copies
// past wp never stored or measured).  It steps T generations, keeps gen T
// in shared memory, steps 6 more, measures and stores; each run steps only
// the chunks of the light cone of generation T + 6 on the centre.  The
// plan (ops/cuda_adaptive.py::frontier_blocks: frontier_reg_plan on the
// launch's shards' rows stacked) picks the block height.  What bounds a launch:
// integer operations on the blocks that step (T + 6 generations of their
// windows); on a settled board, the decisions of the many blocks that do
// not and the few that do.

#include <vector>

#include "regwin.cuh"
#include "window.cuh"

namespace {

using namespace gol;

constexpr int kEmpty = 1 << 30;  // pallas_packed._EMPTY_LO
// A stripe's state (cuda_adaptive.STATE_FIELDS): lo0, hi0, lo1, hi1, its
// column interval clo, chi, and its change rectangle r8, n8, c128, n128.
constexpr int kFields = 10;
constexpr int kClo = 4, kChi = 5, kR8 = 6;
// K12's state: the six intervals, then whether the stripe computed.
constexpr int kStripFields = 7;
constexpr int kComputed = 6;
// A stripe's route (cuda_adaptive.ROUTE_*).
constexpr int kSkip = 0, kTier = 1, kRow = 2, kFull = 3, kElided = 4;

// Stripe i's neighbourhood on a whole board: the previous launch's
// state of stripes i - 1, i and i + 1 (modulo grid), their rows placed in
// stripe i's row frame across the torus wrap.
//
// Each neighbourhood lists kSize stripes; value(n, f) gives field f of its
// stripe n (kNeighbourFields: lo0, hi0, lo1, hi1 placed in stripe i's row
// frame, then clo, chi in board words, unmoved).
constexpr int kNeighbourFields = 6;

struct TorusIntervals {
    static constexpr int kSize = 3;
    const int* prev;  // the previous parity's state of this board
    int total, grid, stripe_h, i;
    __device__ int value(int n, int f) const {
        const int slot = n - 1;
        const int j = wrap(i + slot, grid);
        return prev[f * total + j] + (f < kClo ? (i + slot - j) * stripe_h : 0);
    }
};

// Stripe i's neighbourhood on a strip of a row mesh (K12): an extended
// array of grid + 2 entries per field (lo0, hi0, lo1, hi1, clo, chi), the
// neighbour strips' edge stripes at both ends, already placed in this
// strip's row frame by the exchange.
struct StripIntervals {
    static constexpr int kSize = 3;
    const int* ext;  // int32[6][grid + 2]
    int stride, i;   // stride = grid + 2
    __device__ int value(int n, int f) const { return ext[f * stride + i + n]; }
};

// Stripe i of strip s of a row mesh whose strips share one state array
// (K14): a neighbour past the strip's edge is the last stripe of strip
// s - 1 or the first of strip s + 1 (modulo ny), whose row intervals, in
// that strip's row frame, move by -/+ h_loc into strip s's.  An empty
// interval stays empty: both ends move together.
struct MeshIntervals {
    static constexpr int kSize = 3;
    const int* prev;  // the previous parity's state of every strip
    int total, grid, ny, h_loc, s, i;
    __device__ int value(int n, int f) const {
        int j = i + n - 1;
        int t = s;
        int off = 0;
        if (j < 0) {
            j = grid - 1;
            t = wrap(s - 1, ny);
            off = -h_loc;
        } else if (j >= grid) {
            j = 0;
            t = wrap(s + 1, ny);
            off = h_loc;
        }
        return prev[f * total + t * grid + j] + (f < kClo ? off : 0);
    }
};

// Stripe i of tile (dy, dx) of a 2-D mesh whose tiles share one state
// array (K15): its own stripes i - 1, i and i + 1 and the same three of
// the W and E tiles (modulo nx), whose row frames are this tile's and
// whose column intervals move by -wp (W) and +wp (E) into this tile's
// words, by the neighbour's side and not by its tile (on a (1, 2) mesh the
// W and E tiles are one tile, seen at both shifts); an empty interval
// stays empty (both ends move together).  A neighbour past the tile's edge
// is the last stripe of the tile row above or the first of the row below
// (modulo ny), its rows moved by -/+ h into this tile's frame as
// MeshIntervals moves a strip's.  An interior stripe's nine are
// _kernel_frontier_mega_2d's; an edge stripe's are its 3x3-tile
// neighbourhood.
struct TorusTileIntervals {
    static constexpr int kSize = 9;
    const int* prev;  // the previous parity's state of every tile
    int total, grid, ny, nx, h, wp, dy, dx, i;
    __device__ int value(int n, int f) const {
        const int side = n / 3 - 1;  // W, own, E
        const int tx = wrap(dx + side, nx);
        int j = i + n % 3 - 1;
        int ty = dy;
        int off = 0;
        if (j < 0) {
            j = grid - 1;
            ty = wrap(dy - 1, ny);
            off = -h;
        } else if (j >= grid) {
            j = 0;
            ty = wrap(dy + 1, ny);
            off = h;
        }
        return prev[f * total + (ty * nx + tx) * grid + j] + (f < kClo ? off : side * wp);
    }
};

// The shared memory of a stripe's decision: its neighbourhood's fields
// (kSize x kNeighbourFields, at most nine stripes) and its previous change
// rectangle (4).
constexpr int kGathered = 9 * kNeighbourFields + 4;

// Gather a neighbourhood's fields into `vals` (vals[n * 6 + f]) and the
// stripe's previous change rectangle (`rect`, 4 fields `stride` ints
// apart; null: none) after them, by the 32 lanes of one warp at once:
// one thread's loads would follow one another, and the decision waits on
// them in every block.
template <class Intervals>
__device__ void gather(const Intervals& iv, const int* rect, int stride, int* vals) {
    constexpr int n = Intervals::kSize * kNeighbourFields;
    for (int k = threadIdx.x; k < n + 4; k += reg::kLanes) {
        if (k < n) {
            vals[k] = iv.value(k / kNeighbourFields, k % kNeighbourFields);
        } else if (rect != nullptr) {
            vals[k] = rect[(k - n) * stride];
        }
    }
    __syncwarp();
}

// A stripe's neighbourhood folded (_hit_union): whether a row interval and
// its 6-row pin margin reach the stripe's window (rows c_lo - pad_f ..
// c_hi + pad_f), the union of the row intervals each clamped to t6 rows
// of the stripe, and the union of the nonempty column intervals; from
// the `size` stripes' fields gathered in `vals`.
struct Union {
    int hit, lo, hi, clo, chi;
};

__device__ Union hit_union(const int* vals, int size, int c_lo, int c_hi, int t6, int pad_f) {
    Union u{0, kEmpty, -kEmpty, kEmpty, -kEmpty};
    const int w_lo = c_lo - pad_f;
    const int w_hi = c_hi + pad_f;
    for (int n = 0; n < size; ++n) {
        const int* v = vals + n * kNeighbourFields;
        for (int k = 0; k < 2; ++k) {
            const int lo = v[2 * k];
            const int hi = v[2 * k + 1];
            if (lo > hi) continue;
            if (lo - kSkipPeriod <= w_hi && hi + kSkipPeriod >= w_lo) u.hit = 1;
            const int clo = max(lo, c_lo - t6);
            const int chi = min(hi, c_hi + t6);
            if (clo <= chi) {
                u.lo = min(u.lo, clo);
                u.hi = max(u.hi, chi);
            }
        }
        if (v[kClo] <= v[kChi]) {
            u.clo = min(u.clo, v[kClo]);
            u.chi = max(u.chi, v[kChi]);
        }
    }
    return u;
}

// The union of launch 0 of a chunk: every stripe hits with the maximal
// union (the stale column state is not read).
__device__ Union forced_union(int c_lo, int c_hi, int t6) {
    return Union{1, c_lo - t6, c_hi + t6, kEmpty, -kEmpty};
}

// The compute tiers' geometry of a launch (cuda_adaptive.frontier_geometry):
// the row tier's sub-window rows and the column window's words, 0 = off.
struct Geometry {
    int turns, stripe_h, pad_f, sub_rows, col_window, wp;
};

// What one stripe does in a launch (cuda_adaptive.Routes), decided by one
// thread of each of its blocks, in shared memory: its route, its measure
// rows [m_lo, m_hi], the cells [v_lo, v_hi) x [vc_lo, vc_hi) where its
// window holds the true generation T (also the measure's words), the
// cells [w_lo, w_hi) x [wc_lo, wc_hi) it writes (gen T in the former, its
// input elsewhere), the cells [p_lo, p_hi) x [pc_lo, pc_hi) it copies from
// its input (its previous change rectangle), and the change rectangle it
// publishes, in chunk units.  Rows in the frame of its board, strip or
// tile.
struct Decision {
    int route;
    int m_lo, m_hi;
    int v_lo, v_hi, vc_lo, vc_hi;
    int w_lo, w_hi, wc_lo, wc_hi;
    int p_lo, p_hi, pc_lo, pc_hi;
    int rect[4];
};

// A stripe's route from its union, as _frontier_placement and
// _col_placement place its windows (their idx8 * 8 and cidx * 128 floors):
// skip where it does not hit; the column window where both placements are
// eligible and, for the rectangle route (`rect`: K5, K8, K14, K15), the
// window's rows lie in [0, rows); the row tier where the row placement
// is; else the full window.  The rectangle route writes and publishes the
// window's rows of its own centre, col_window words; the column tier of
// K12 and every other route write the whole centre, which the classic
// routes publish.  Copies nothing (the caller sets the p_ fields).
__device__ void decide(Decision& d, const Union& u, int c_lo, const Geometry& g, bool rect,
                       int rows) {
    const int sh = g.stripe_h, pad = g.pad_f, t = g.turns, t6 = g.turns + kSkipPeriod;
    const int sub = g.sub_rows, cwin = g.col_window;
    const int w0 = c_lo - pad;  // the window's first row
    const int d_lo = u.lo - w0;
    const int d_hi = u.hi - w0;
    const int m_lo = max(d_lo - t6, pad);
    const int m_hi = min(d_hi + t6, pad + sh - 1);
    int win_lo = 0;
    bool row_ok = false;
    if (sub) {
        win_lo = min(max(d_lo - 2 * t - 16, 0), sh + 2 * pad - sub) / 8 * 8;
        row_ok = win_lo + t6 <= m_lo && m_hi < win_lo + sub - t6;
    }
    const int g_lo = w0 + win_lo;
    bool tier = false;
    int win_c = 0, cw = 0;
    if (cwin) {
        cw = (t6 + 31) / 32;
        const int need_lo = u.clo - cw;
        const int need_hi = u.chi + cw;
        win_c = min(max(need_lo - cw, 0), g.wp - cwin) / 128 * 128;
        tier = row_ok && win_c + cw <= need_lo && need_hi < win_c + cwin - cw;
        if (rect) tier = tier && g_lo >= 0 && g_lo + sub <= rows;
    }
    d.route = !u.hit ? kSkip : tier ? kTier : row_ok ? kRow : kFull;
    d.m_lo = m_lo + w0;
    d.m_hi = m_hi + w0;
    const bool windowed = d.route == kTier || d.route == kRow;
    d.v_lo = windowed ? g_lo + t : c_lo;
    d.v_hi = windowed ? g_lo + sub - t : c_lo + sh;
    const bool is_tier = d.route == kTier;
    d.vc_lo = is_tier ? win_c + cw : 0;
    d.vc_hi = is_tier ? win_c + cwin - cw : g.wp;
    const bool r = is_tier && rect;
    const bool skip = d.route == kSkip;
    d.w_lo = skip ? 0 : r ? max(g_lo, c_lo) : c_lo;
    d.w_hi = skip ? 0 : r ? min(g_lo + sub, c_lo + sh) : c_lo + sh;
    d.wc_lo = r ? win_c : 0;
    d.wc_hi = r ? win_c + cwin : g.wp;
    d.rect[0] = skip ? 0 : d.w_lo / 8;
    d.rect[1] = skip ? 0 : (d.w_hi - d.w_lo) / 8;
    d.rect[2] = skip ? 0 : d.wc_lo / 128;
    d.rect[3] = skip ? 0 : r ? cwin / 128 : g.wp / 128;
    d.p_lo = d.p_hi = 0;
    d.pc_lo = 0;
    d.pc_hi = g.wp;
}

// A forced stripe of K15 (launch 0 of a chunk, or a tile's edge stripe),
// by its own branch: the full route with the maximal measure rows, as the
// JAX kernel's forced union places it (its row window never fits: see the
// K15 notes above), where it `computes`; elided where it does not (an
// edge stripe whose 3x3-tile neighbourhood does not hit): it writes
// nothing and, as the full route, publishes its whole centre.  Copies
// nothing (the caller sets the p_ fields).
__device__ void forced_route(Decision& d, int c_lo, const Geometry& g, bool computes) {
    const int sh = g.stripe_h;
    d.route = computes ? kFull : kElided;
    d.m_lo = c_lo;
    d.m_hi = c_lo + sh - 1;
    d.v_lo = c_lo;
    d.v_hi = c_lo + sh;
    d.vc_lo = 0;
    d.vc_hi = g.wp;
    d.w_lo = computes ? c_lo : 0;
    d.w_hi = computes ? c_lo + sh : 0;
    d.wc_lo = 0;
    d.wc_hi = g.wp;
    d.rect[0] = c_lo / 8;
    d.rect[1] = sh / 8;
    d.rect[2] = 0;
    d.rect[3] = g.wp / 128;
    d.p_lo = d.p_hi = 0;
    d.pc_lo = 0;
    d.pc_hi = g.wp;
}

// Copy a published change rectangle (`rect`: r8, n8, c128, n128 at
// `stride` ints apart) as _copy_rect's two families do: one col_window
// words wide spans its words, any other (the classic routes' whole
// centre) the whole width; n8 <= 0 copies nothing.
__device__ void copy_rect(Decision& d, const int* rect, int stride, const Geometry& g) {
    const int r8 = rect[0], n8 = rect[stride], c128 = rect[2 * stride], n128 = rect[3 * stride];
    if (n8 <= 0) return;
    d.p_lo = r8 * 8;
    d.p_hi = (r8 + n8) * 8;
    const bool windowed = g.col_window && n128 == g.col_window / 128;
    d.pc_lo = windowed ? c128 * 128 : 0;
    d.pc_hi = windowed ? c128 * 128 + g.col_window : g.wp;
}

// Whether a block's tile (rows [y0, y0 + tile_h), centre words [x0, x0 +
// 30) within wp) meets the cells [lo, hi) x [clo, chi).
__device__ __forceinline__ bool meets(int lo, int hi, int clo, int chi, int y0, int tile_h,
                                      int x0, int wp) {
    return max(lo, y0) < min(hi, y0 + tile_h) &&
           max(clo, x0) < min(chi, min(x0 + reg::kLanes - 2, wp));
}

// Whether the block steps: its tile meets the cells its stripe writes as
// gen T (they hold the measure too).
__device__ __forceinline__ bool steps(const Decision& d, int y0, int tile_h, int x0, int wp) {
    return meets(max(d.w_lo, d.v_lo), min(d.w_hi, d.v_hi), max(d.wc_lo, d.vc_lo),
                 min(d.wc_hi, d.vc_hi), y0, tile_h, x0, wp);
}

// The block's copies from `rd` to `wr`, as the whole block: the cells of
// its tile that its stripe copies and does not write and, where the block
// does not step, the cells it writes (all outside the gen-T cells: the
// input is their value).
__device__ void copy_cells(const Decision& d, bool stepping, const uint32_t* __restrict__ rd,
                           uint32_t* __restrict__ wr, int wp, int y0, int x0, int tile_h) {
    if (!meets(d.p_lo, d.p_hi, d.pc_lo, d.pc_hi, y0, tile_h, x0, wp) &&
        (stepping || !meets(d.w_lo, d.w_hi, d.wc_lo, d.wc_hi, y0, tile_h, x0, wp))) {
        return;
    }
    const int gx = x0 - 1 + static_cast<int>(threadIdx.x);
    if (threadIdx.x < 1 || threadIdx.x >= reg::kLanes - 1 || gx >= wp) return;
    const bool wc = gx >= d.wc_lo && gx < d.wc_hi;
    const bool pc = gx >= d.pc_lo && gx < d.pc_hi;
    if (!wc && !pc) return;
    for (int r = threadIdx.y; r < tile_h; r += blockDim.y) {
        const int y = y0 + r;
        const bool w = wc && y >= d.w_lo && y < d.w_hi;
        const bool p = pc && y >= d.p_lo && y < d.p_hi;
        if (w ? !stepping : p) {
            const size_t at = static_cast<size_t>(y) * wp + gx;
            wr[at] = rd[at];
        }
    }
}

// The measure (_measure2's cells): in the block's centre words inside
// [vc_lo, vc_hi), set rowflag[y] for each row y of its tile in [m_lo,
// m_hi] where the registers (gen T + 6) differ from `kept` (gen T,
// reg::keep), and widen the stripe's column extremes `colspan` (least,
// greatest) to those words.  Each lane gathers its own 32 rows as bits,
// the warp ORs them and lane l reports the warp's row l; the warp's least
// and greatest word go to `colspan` once.
__device__ __forceinline__ void measure(const uint32_t (&s)[reg::kRun], const reg::Run& run,
                                        const uint32_t* kept, const Decision& d,
                                        int* __restrict__ rowflag, int* __restrict__ colspan,
                                        int wp, int y0, int x0, int tile_h) {
    int gx;
    const bool centre = reg::centre_lane(run, x0, wp, gx) && gx >= d.vc_lo && gx < d.vc_hi;
    const int lo = max(d.m_lo, y0);
    const int hi = min(d.m_hi, y0 + tile_h - 1);
    uint32_t bits = 0u;
#pragma unroll
    for (int i = 0; i < reg::kRun; ++i) {
        const int y = y0 + run.row(i) - run.halo;
        if (centre && y >= lo && y <= hi && s[i] != kept[run.row(i) * reg::kLanes + run.lane]) {
            bits |= 1u << i;
        }
    }
    const uint32_t rows = __reduce_or_sync(reg::kFull, bits);
    if ((rows >> run.lane) & 1u) rowflag[y0 + run.row(run.lane) - run.halo] = 1;
    const int cmin = __reduce_min_sync(reg::kFull, bits ? gx : kEmpty);
    const int cmax = __reduce_max_sync(reg::kFull, bits ? gx : -kEmpty);
    if (run.lane == 0 && cmin <= cmax) {
        atomicMin(colspan, cmin);
        atomicMax(colspan + 1, cmax);
    }
}

// Store the block's written cells of its tile (its centre lanes' rows of
// [w_lo, w_hi) x [wc_lo, wc_hi)) from `kept` (gen T) where they lie in
// the gen-T cells, from `rd` (the input) elsewhere.
__device__ __forceinline__ void store_kept(const reg::Run& run, const uint32_t* kept,
                                           const Decision& d, const uint32_t* __restrict__ rd,
                                           uint32_t* __restrict__ wr, int wp, int y0, int x0,
                                           int tile_h) {
    int gx;
    const bool wc = reg::centre_lane(run, x0, wp, gx) && gx >= d.wc_lo && gx < d.wc_hi;
    if (!wc) return;
    const bool vc = gx >= d.vc_lo && gx < d.vc_hi;
    const int lo = max(d.w_lo, y0);
    const int hi = min(d.w_hi, y0 + tile_h);
#pragma unroll
    for (int i = 0; i < reg::kRun; ++i) {
        const int y = y0 + run.row(i) - run.halo;
        if (y >= lo && y < hi) {
            const size_t at = static_cast<size_t>(y) * wp + gx;
            wr[at] = vc && y >= d.v_lo && y < d.v_hi ? kept[run.row(i) * reg::kLanes + run.lane]
                                                     : rd[at];
        }
    }
}

// The window's rows and generations: a tile of `tile_h` rows with
// T + 6 rows a side, stepped T + 6 generations, its cone every row but g
// a side at generation g.
__device__ __forceinline__ reg::Run reg_run(int turns, int tile_h) {
    const int halo = turns + kSkipPeriod;
    return reg::Run::make(tile_h + 2 * halo, halo, halo, 0);
}

// A stepping block's T + 6 generations from `col` (its word column of the
// window source), then its measure and its writes: T, gen T kept
// (reg::keep), 6 more, measure(s), then the written cells from the kept
// gen T.  The block's place is read anew (reg::block_x, ...) after the
// loops, so that nothing computed before them holds a register through
// them; `rd`, `wr`, `rowflag` and `colspan` give shard z's input, output,
// row flags and the column extremes of its stripe at row y.
template <class Rule, class Shard>
__device__ __forceinline__ void step_block(reg::Edges& edges, uint32_t* kept, const Decision& d,
                                           const reg::Column& col, int turns, int tile_h, int wp,
                                           const Rule& rule, const Shard& shard) {
    const reg::Run run = reg_run(turns, tile_h);
    uint32_t s[reg::kRun];
    const int top = reg::block_y() * tile_h - run.halo;
    reg::load(s, run, [&](int r) { return col(top + r); });
    reg::advance(s, edges, run, 1, turns, rule);
    reg::keep(s, run, kept);
    reg::advance(s, edges, run, turns + 1, turns + kSkipPeriod, rule);
    const int z = reg::block_z();
    const int y0 = reg::block_y() * tile_h;
    const int x0 = reg::block_x() * (reg::kLanes - 2);
    measure(s, run, kept, d, shard.rowflag(z), shard.colspan(z, y0), wp, y0, x0, tile_h);
    store_kept(run, kept, d, shard.rd(z), shard.wr(z), wp, y0, x0, tile_h);
}

// Shard z of a contiguous stack of boards of h x wp words (K5/K8).
struct StackShard {
    const uint32_t* rd_;
    uint32_t* wr_;
    int* rowflag_;
    int* colspan_;
    int h, wp, stripe_h;
    __device__ const uint32_t* rd(int z) const { return rd_ + static_cast<size_t>(z) * h * wp; }
    __device__ uint32_t* wr(int z) const { return wr_ + static_cast<size_t>(z) * h * wp; }
    __device__ int* rowflag(int z) const { return rowflag_ + static_cast<size_t>(z) * h; }
    __device__ int* colspan(int z, int y) const {
        return colspan_ + 2 * (z * (h / stripe_h) + y / stripe_h);
    }
};

// Shard ids[z] of a mesh whose shards' buffers are in pointer tables
// (K14, K15), z the launch's entry of its table of shard ids.
struct TableShard {
    const uint32_t* const* rd_;
    uint32_t* const* wr_;
    const int* ids;
    int* rowflag_;
    int* colspan_;
    int h, stripe_h;
    __device__ const uint32_t* rd(int z) const { return rd_[ids[z]]; }
    __device__ uint32_t* wr(int z) const { return wr_[ids[z]]; }
    __device__ int* rowflag(int z) const { return rowflag_ + static_cast<size_t>(ids[z]) * h; }
    __device__ int* colspan(int z, int y) const {
        return colspan_ + 2 * (ids[z] * (h / stripe_h) + y / stripe_h);
    }
};

// One shard's buffers as a table of one (K12).
struct SoloShard {
    const uint32_t* rd_;
    uint32_t* wr_;
    int* rowflag_;
    int* colspan_;
    int stripe_h;
    __device__ const uint32_t* rd(int) const { return rd_; }
    __device__ uint32_t* wr(int) const { return wr_; }
    __device__ int* rowflag(int) const { return rowflag_; }
    __device__ int* colspan(int, int y) const { return colspan_ + 2 * (y / stripe_h); }
};

// The stripe's bookkeeping, by its leader (thread 0 of the block of its
// first row tile and first column group): the published change rectangle
// into `rect` (4 fields `stride` ints apart), a skip counted, the route
// recorded.
__device__ void publish(const Decision& d, int* rect, int stride, int* skipped, int* route) {
    for (int f = 0; f < 4; ++f) rect[f * stride] = d.rect[f];
    if (d.route == kSkip) atomicAdd(skipped, 1);
    *route = d.route;
}

// K5 and K8: one frontier launch over a contiguous stack of boards of
// (h, wp) words, blockIdx.z the board, blockIdx.y the row tile of a
// stripe and blockIdx.x the column group of 30 words.  Board b's stripes
// keep their state at b * grid + i, in its own row frame; `first` forces
// every stripe to hit with the maximal union (launch 0 of a chunk).  The
// window's rows wrap around board b alone (reg::column of a BoardSource;
// the halo <= h); the rectangle route's window stays within the board's
// rows.
template <class Rule>
__global__ void __launch_bounds__(reg::kMaxThreads, reg::FrontierBlocks<Rule>::value)
frontier_reg_kernel(const uint32_t* __restrict__ rd, uint32_t* __restrict__ wr,
                    int* __restrict__ state, int* __restrict__ rowflag, int* __restrict__ colspan,
                    int* __restrict__ skipped, int* __restrict__ route, int h, int wp, int turns,
                    int stripe_h, int tile_h, int pad_f, int sub_rows, int col_window, int parity,
                    int first, Rule rule) {
    __shared__ reg::Edges edges;
    __shared__ Decision dec;
    __shared__ int nb[kGathered];
    extern __shared__ uint32_t kept[];  // the window at gen T (reg::keep)
    const int grid = h / stripe_h;
    const int board = blockIdx.z;
    const int total = gridDim.z * grid;
    const size_t words = static_cast<size_t>(h) * wp;
    const uint32_t* b = rd + board * words;
    const int y0 = blockIdx.y * tile_h;
    const int x0 = blockIdx.x * (reg::kLanes - 2);
    const int i = y0 / stripe_h;
    const int c_lo = i * stripe_h;
    if (threadIdx.y == 0) {
        const int* prev = state + (1 - parity) * kFields * total + board * grid;
        if (!first) {
            gather(TorusIntervals{prev, total, grid, stripe_h, i}, prev + kR8 * total + i, total,
                   nb);
        }
        if (threadIdx.x == 0) {
            const int t6 = turns + kSkipPeriod;
            const Geometry g{turns, stripe_h, pad_f, sub_rows, col_window, wp};
            const Union u =
                first ? forced_union(c_lo, c_lo + stripe_h - 1, t6)
                      : hit_union(nb, TorusIntervals::kSize, c_lo, c_lo + stripe_h - 1, t6, pad_f);
            decide(dec, u, c_lo, g, true, h);
            if (!first && (dec.route == kSkip || dec.route == kTier)) {
                copy_rect(dec, nb + TorusIntervals::kSize * kNeighbourFields, 1, g);
            }
            if (blockIdx.x == 0 && y0 == c_lo) {
                int* cur = state + parity * kFields * total + board * grid;
                publish(dec, cur + kR8 * total + i, total, skipped + board,
                        route + board * grid + i);
            }
        }
    }
    __syncthreads();
    const bool stepping = steps(dec, y0, tile_h, x0, wp);
    copy_cells(dec, stepping, b, wr + board * words, wp, y0, x0, tile_h);
    if (!stepping) return;
    step_block(edges, kept, dec, reg::column(BoardSource{b, h, wp}, x0 - 1 + threadIdx.x), turns,
               tile_h, wp, rule, StackShard{rd, wr, rowflag, colspan, h, wp, stripe_h});
}

// K12: one frontier launch on one strip of a row mesh, one block per
// (row tile of a stripe, column group of 30 words).  `prev_ext` holds the
// previous launch's intervals of this strip's stripes with the neighbour
// strips' edge stripes at both ends (int32[6][grid + 2], rows in this
// strip's frame), `prev_computed` its computed flags (int32[grid]); `cur`
// (int32[7][grid]) gets this launch's.  The window's rows outside the
// strip come from `north` and `south` (n rows each).  K12 keeps the ps
// protocol: a stripe that hits writes its whole centre, one that skips
// after a launch that computed copies it.
template <class Rule>
__global__ void __launch_bounds__(reg::kMaxThreads, reg::FrontierBlocks<Rule>::value)
strip_frontier_reg_kernel(const uint32_t* __restrict__ local, const uint32_t* __restrict__ north,
                          const uint32_t* __restrict__ south, uint32_t* __restrict__ wr,
                          const int* __restrict__ prev_ext, const int* __restrict__ prev_computed,
                          int* __restrict__ cur, int* __restrict__ rowflag,
                          int* __restrict__ colspan, int* __restrict__ skipped,
                          int* __restrict__ route, int h, int wp, int n, int turns, int stripe_h,
                          int tile_h, int pad_f, int sub_rows, int col_window, Rule rule) {
    __shared__ reg::Edges edges;
    __shared__ Decision dec;
    __shared__ int nb[kGathered];
    extern __shared__ uint32_t kept[];  // the window at gen T (reg::keep)
    const int grid = h / stripe_h;
    const int y0 = blockIdx.y * tile_h;
    const int x0 = blockIdx.x * (reg::kLanes - 2);
    const int i = y0 / stripe_h;
    const int c_lo = i * stripe_h;
    if (threadIdx.y == 0) {
        gather(StripIntervals{prev_ext, grid + 2, i}, nullptr, 0, nb);
        if (threadIdx.x == 0) {
            const Geometry g{turns, stripe_h, pad_f, sub_rows, col_window, wp};
            decide(dec,
                   hit_union(nb, StripIntervals::kSize, c_lo, c_lo + stripe_h - 1,
                             turns + kSkipPeriod, pad_f),
                   c_lo, g, false, h);
            if (dec.route == kSkip && prev_computed[i]) {
                dec.p_lo = c_lo;
                dec.p_hi = c_lo + stripe_h;
            }
            if (blockIdx.x == 0 && y0 == c_lo) {
                cur[kComputed * grid + i] = dec.route != kSkip;
                if (dec.route == kSkip) atomicAdd(skipped, 1);
                route[i] = dec.route;
            }
        }
    }
    __syncthreads();
    const bool stepping = steps(dec, y0, tile_h, x0, wp);
    copy_cells(dec, stepping, local, wr, wp, y0, x0, tile_h);
    if (!stepping) return;
    step_block(edges, kept, dec,
               reg::column(StripSource{local, north, south, h, wp, n}, x0 - 1 + threadIdx.x),
               turns, tile_h, wp, rule, SoloShard{local, wr, rowflag, colspan, stripe_h});
}

// K14: one launch over the strips of a row mesh that `ids` names,
// blockIdx.z the entry of `ids` (the strip), blockIdx.y the row tile of a
// stripe and blockIdx.x the column group of 30 words.  `rd_tab` and
// `wr_tab` (ny entries each, every strip's, whatever card it lies on)
// give the strips' read and write buffers; the window's rows past strip
// s's edge come from the read buffers of strips s - 1 and s + 1
// (reg::column of a StripSource whose north and south are those whole
// buffers; the halo <= h).  `first` forces every stripe to hit with the maximal union
// (launch 0 of a chunk).  The rectangle route's window stays within the
// strip's own rows.
template <class Rule>
__global__ void __launch_bounds__(reg::kMaxThreads, reg::FrontierBlocks<Rule>::value)
strip_mega_reg_kernel(const uint32_t* const* __restrict__ rd_tab,
                      uint32_t* const* __restrict__ wr_tab, const int* __restrict__ ids,
                      int* __restrict__ state, int* __restrict__ rowflag,
                      int* __restrict__ colspan,
                      int* __restrict__ skipped, int* __restrict__ route, int ny, int h, int wp,
                      int turns, int stripe_h, int tile_h, int pad_f, int sub_rows,
                      int col_window, int parity, int first, Rule rule) {
    __shared__ reg::Edges edges;
    __shared__ Decision dec;
    __shared__ int nb[kGathered];
    extern __shared__ uint32_t kept[];  // the window at gen T (reg::keep)
    const int grid = h / stripe_h;
    const int strip = ids[blockIdx.z];
    const int total = ny * grid;
    const int y0 = blockIdx.y * tile_h;
    const int x0 = blockIdx.x * (reg::kLanes - 2);
    const int i = y0 / stripe_h;
    const int c_lo = i * stripe_h;
    const int gi = strip * grid + i;
    if (threadIdx.y == 0) {
        const int* prev = state + (1 - parity) * kFields * total;
        if (!first) {
            gather(MeshIntervals{prev, total, grid, ny, h, strip, i}, prev + kR8 * total + gi,
                   total, nb);
        }
        if (threadIdx.x == 0) {
            const int t6 = turns + kSkipPeriod;
            const Geometry g{turns, stripe_h, pad_f, sub_rows, col_window, wp};
            const Union u =
                first ? forced_union(c_lo, c_lo + stripe_h - 1, t6)
                      : hit_union(nb, MeshIntervals::kSize, c_lo, c_lo + stripe_h - 1, t6, pad_f);
            decide(dec, u, c_lo, g, true, h);
            if (!first && (dec.route == kSkip || dec.route == kTier)) {
                copy_rect(dec, nb + MeshIntervals::kSize * kNeighbourFields, 1, g);
            }
            if (blockIdx.x == 0 && y0 == c_lo) {
                publish(dec, state + parity * kFields * total + kR8 * total + gi, total,
                        skipped + strip, route + gi);
            }
        }
    }
    __syncthreads();
    const bool stepping = steps(dec, y0, tile_h, x0, wp);
    copy_cells(dec, stepping, rd_tab[strip], wr_tab[strip], wp, y0, x0, tile_h);
    if (!stepping) return;
    step_block(edges, kept, dec,
               reg::column(StripSource{rd_tab[strip], rd_tab[wrap(strip - 1, ny)],
                                       rd_tab[wrap(strip + 1, ny)], h, wp, h},
                           x0 - 1 + threadIdx.x),
               turns, tile_h, wp, rule,
               TableShard{rd_tab, wr_tab, ids, rowflag, colspan, h, stripe_h});
}

// K15: one launch over the tiles of a 2-D mesh that `ids` names,
// blockIdx.z the entry of `ids` (the tile, dy * nx + dx), blockIdx.y the
// row tile of a stripe and blockIdx.x the column group of 30 words.
// `rd_tab` and `wr_tab` (ny * nx entries each, row-major, every tile's)
// give the tiles' read and write buffers; the window's rows and words past
// tile (dy, dx)'s edges come from the neighbour tiles' read buffers
// (reg::column of a MeshTileSource; the halo <= h).  `first` forces every
// stripe to the full route (launch 0 of a chunk); otherwise an edge stripe
// takes the full route with the maximal measure rows if its 3x3-tile
// neighbourhood hits and is elided if not (forced_route), and an interior
// stripe takes K5's routes (decide), the rectangle route's window inside
// the tile's own rows and words.
template <class Rule>
__global__ void __launch_bounds__(reg::kMaxThreads, reg::FrontierBlocks<Rule>::value)
tile_mega_reg_kernel(const uint32_t* const* __restrict__ rd_tab,
                     uint32_t* const* __restrict__ wr_tab, const int* __restrict__ ids,
                     int* __restrict__ state, int* __restrict__ rowflag,
                     int* __restrict__ colspan,
                     int* __restrict__ skipped, int* __restrict__ route, int ny, int nx, int h,
                     int wp, int turns, int stripe_h, int tile_h, int pad_f, int sub_rows,
                     int col_window, int parity, int first, Rule rule) {
    __shared__ reg::Edges edges;
    __shared__ Decision dec;
    __shared__ int nb[kGathered];
    extern __shared__ uint32_t kept[];  // the window at gen T (reg::keep)
    const int grid = h / stripe_h;
    const int v = ids[blockIdx.z];
    const int dy = v / nx;
    const int dx = v - dy * nx;
    const int total = ny * nx * grid;
    const int y0 = blockIdx.y * tile_h;
    const int x0 = blockIdx.x * (reg::kLanes - 2);
    const int i = y0 / stripe_h;
    const int c_lo = i * stripe_h;
    const int gi = v * grid + i;
    if (threadIdx.y == 0) {
        const int* prev = state + (1 - parity) * kFields * total;
        if (!first) {
            gather(TorusTileIntervals{prev, total, grid, ny, nx, h, wp, dy, dx, i},
                   prev + kR8 * total + gi, total, nb);
        }
        if (threadIdx.x == 0) {
            const Geometry g{turns, stripe_h, pad_f, sub_rows, col_window, wp};
            if (first) {
                forced_route(dec, c_lo, g, true);
            } else {
                const Union u = hit_union(nb, TorusTileIntervals::kSize, c_lo,
                                          c_lo + stripe_h - 1, turns + kSkipPeriod, pad_f);
                if (i == 0 || i == grid - 1) {
                    forced_route(dec, c_lo, g, u.hit);
                } else {
                    decide(dec, u, c_lo, g, true, h);
                }
                if (dec.route == kSkip || dec.route == kTier || dec.route == kElided) {
                    copy_rect(dec, nb + TorusTileIntervals::kSize * kNeighbourFields, 1, g);
                }
            }
            if (blockIdx.x == 0 && y0 == c_lo) {
                publish(dec, state + parity * kFields * total + kR8 * total + gi, total,
                        skipped + v, route + gi);
            }
        }
    }
    __syncthreads();
    const bool stepping = steps(dec, y0, tile_h, x0, wp);
    copy_cells(dec, stepping, rd_tab[v], wr_tab[v], wp, y0, x0, tile_h);
    if (!stepping) return;
    step_block(edges, kept, dec,
               reg::column(MeshTileSource{rd_tab, ny, nx, dy, dx, h, wp}, x0 - 1 + threadIdx.x),
               turns, tile_h, wp, rule,
               TableShard{rd_tab, wr_tab, ids, rowflag, colspan, h, stripe_h});
}

// One block per stripe of the launch's shards: block k * grid + i is
// stripe i of shard s = ids[k] (s = k without a table), gi = s * grid + i
// of the `total` stripes of every shard.  The stripe's rows flagged by its
// blocks become the two row intervals of _measure2 (split at the midpoint
// of their span), its column extremes its column interval (fields 4 and
// 5); the stripe counts active when the first row interval is nonempty;
// the flags and extremes are cleared.  `fields` is the state's field
// count (K12's 7, the others' 10).
__global__ void frontier_finalize(int* __restrict__ state, int* __restrict__ rowflag,
                                  int* __restrict__ colspan, int* __restrict__ act,
                                  const int* __restrict__ ids, int total, int h, int stripe_h,
                                  int grid, int parity, int fields) {
    __shared__ int lo, hi, hi0, lo1;
    const int k = blockIdx.x / grid;
    const int gi = (ids != nullptr ? ids[k] : k) * grid + blockIdx.x % grid;
    const int c_lo = (gi % grid) * stripe_h;  // rows of shard gi / grid
    rowflag += static_cast<size_t>(gi / grid) * h;
    int* cur = state + parity * fields * total;
    if (threadIdx.x == 0) {
        lo = kEmpty;
        hi = -kEmpty;
        hi0 = -kEmpty;
        lo1 = kEmpty;
    }
    __syncthreads();
    for (int r = c_lo + threadIdx.x; r < c_lo + stripe_h; r += blockDim.x) {
        if (rowflag[r]) {
            atomicMin(&lo, r);
            atomicMax(&hi, r);
        }
    }
    __syncthreads();
    if (lo > hi) {
        if (threadIdx.x == 0) {
            cur[0 * total + gi] = kEmpty;
            cur[1 * total + gi] = -1;
            cur[2 * total + gi] = kEmpty;
            cur[3 * total + gi] = -1;
            cur[kClo * total + gi] = kEmpty;
            cur[kChi * total + gi] = -1;
            colspan[2 * gi] = kEmpty;
            colspan[2 * gi + 1] = -kEmpty;
        }
        return;
    }
    const int split = (lo + hi) / 2;  // both >= 0: the floor of _measure2
    for (int r = c_lo + threadIdx.x; r < c_lo + stripe_h; r += blockDim.x) {
        if (rowflag[r]) {
            if (r <= split) {
                atomicMax(&hi0, r);
            } else {
                atomicMin(&lo1, r);
            }
            rowflag[r] = 0;
        }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        const bool one = lo1 > hi;  // nothing above the split
        cur[0 * total + gi] = lo;
        cur[1 * total + gi] = one ? hi : hi0;
        cur[2 * total + gi] = one ? kEmpty : lo1;
        cur[3 * total + gi] = one ? -1 : hi;
        cur[kClo * total + gi] = colspan[2 * gi];
        cur[kChi * total + gi] = colspan[2 * gi + 1];
        colspan[2 * gi] = kEmpty;
        colspan[2 * gi + 1] = -kEmpty;
        act[gi] += 1;
    }
}

// The checks every register-resident frontier launch shares: a launch
// of T (a multiple of 6) + 6 <= 30 generations, whole stripes of whole
// row tiles, `warps` warps holding a tile's window (tile_h + 2 (T + 6)
// rows), and a decision reach pad_f >= T + 6; where a row tier is given,
// its sub-window (a multiple of 8) and 64 rows more fit a stripe's window
// of multiple-of-8 rows, and a column window (a multiple of 128 words, at
// most half the width) comes only with one.
bool bad_reg_frontier(int h, int wp, int turns, int stripe_h, int tile_h, int warps, int pad_f,
                      int sub_rows, int col_window) {
    const int halo = turns + kSkipPeriod;
    const bool bad_tiers =
        sub_rows < 0 || col_window < 0 ||
        (sub_rows && (sub_rows % 8 || stripe_h % 8 || pad_f % 8 ||
                      sub_rows + 64 > stripe_h + 2 * pad_f)) ||
        (col_window && (!sub_rows || col_window % 128 || wp < 2 * col_window));
    return h < 1 || wp < 1 || turns < kSkipPeriod || turns % kSkipPeriod ||
           halo > reg::kLanes - 2 || stripe_h < 1 || h % stripe_h || tile_h < 1 ||
           stripe_h % tile_h || warps < 1 || warps > reg::kMaxWarps ||
           warps * reg::kRun < tile_h + 2 * halo || pad_f < halo || bad_tiers;
}

// The blocks of a frontier launch over n shards of (h, wp) words: column
// groups of 30 words, row tiles of tile_h rows, blockIdx.z the shard.
dim3 reg_grid(int wp, int h, int tile_h, int n) {
    return dim3((wp + reg::kLanes - 3) / (reg::kLanes - 2), h / tile_h, n);
}

// Launch a register-resident frontier kernel's instantiation `kernel` on
// `grid` blocks of `warps` warps, with its reg::keep buffer allowed.
template <typename Kernel, typename... Args>
int launch_reg(Kernel kernel, dim3 grid, int warps, cudaStream_t stream, Args... args) {
    const long long smem = 4LL * warps * reg::kRun * reg::kLanes;  // reg::keep's words
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, dim3(reg::kLanes, warps), static_cast<size_t>(smem), stream>>>(args...);
    return cudaGetLastError();
}

// After a frontier kernel: frontier_finalize over the stripes of the n
// shards of h rows that `ids` names (null: shards 0..n - 1) of `total`
// stripes in all, on the state of parity `parity`.
int finalize(void* state, void* rowflag, void* colspan, void* act, const void* ids, int n,
             int total, int h, int stripe_h, int parity, int fields, cudaStream_t stream) {
    const int grid = h / stripe_h;
    frontier_finalize<<<n * grid, 256, 0, stream>>>(
        static_cast<int*>(state), static_cast<int*>(rowflag), static_cast<int*>(colspan),
        static_cast<int*>(act), static_cast<const int*>(ids), total, h, stripe_h, grid, parity,
        fields);
    return cudaGetLastError();
}

// Whether `ids` (n shard ids, on the host) fails to name n distinct
// shards of `shards`.
bool bad_ids(const int* ids, int n, int shards) {
    if (ids == nullptr || n < 1 || n > shards || n > 65535) return true;
    std::vector<bool> seen(shards);
    for (int k = 0; k < n; ++k) {
        if (ids[k] < 0 || ids[k] >= shards || seen[ids[k]]) return true;
        seen[ids[k]] = true;
    }
    return false;
}

}  // namespace

// K5 and K8: a contiguous stack of nb boards of (h, wp) words, blockIdx.z
// the board (K5 is the stack of one board); `state`
// (int32[2][10][nb * grid]), `rowflag` (int32[nb * h], zero between
// launches), `colspan` (int32[nb * grid][2], (2^30, -2^30) between
// launches), `skipped` (int32[nb]) and `act` (int32[nb * grid]) persist
// over a chunk; `route` (int32[nb * grid]) gets this launch's routes.
// The decision's reach pad_f (>= the window's row halo T + 6) must fit
// one stripe, so a window wraps around its board once at most; sub_rows
// and col_window are the compute tiers' geometry (0 = off); a block is
// `tile_h` rows of a stripe and `warps` warps; `variant` picks the rule's
// instantiation (regwin.cuh::by_rule).
extern "C" int gol_frontier_batched_launch(const void* rd, void* wr, void* state, void* rowflag,
                                           void* colspan, void* skipped, void* act, void* route,
                                           int nb, int h, int wp, int turns, int stripe_h,
                                           int tile_h, int warps, int pad_f, int sub_rows,
                                           int col_window, int parity, int first, int variant,
                                           unsigned born, unsigned surv, void* stream) {
    if (nb < 1 || nb > 65535 ||
        bad_reg_frontier(h, wp, turns, stripe_h, tile_h, warps, pad_f, sub_rows, col_window) ||
        pad_f > stripe_h || turns + kSkipPeriod > h || (parity != 0 && parity != 1) ||
        (first != 0 && first != 1)) {
        return cudaErrorInvalidValue;
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int err = reg::by_rule(variant, born, surv, [&](auto rule) {
        return launch_reg(frontier_reg_kernel<decltype(rule)>, reg_grid(wp, h, tile_h, nb), warps,
                          s, static_cast<const uint32_t*>(rd), static_cast<uint32_t*>(wr),
                          static_cast<int*>(state), static_cast<int*>(rowflag),
                          static_cast<int*>(colspan), static_cast<int*>(skipped),
                          static_cast<int*>(route), h, wp, turns, stripe_h, tile_h, pad_f,
                          sub_rows, col_window, parity, first, rule);
    });
    if (err != cudaSuccess) return err;
    return finalize(state, rowflag, colspan, act, nullptr, nb, nb * (h / stripe_h), h, stripe_h,
                    parity, kFields, s);
}

// K12: the caller builds `prev_ext` (the exchange), zeroes `rowflag` and
// sets `colspan` (int32[grid][2]) to (2^30, -2^30) once; the launch's
// decision reach is pad_f (the JAX plan's round8(T + 6)), its window halo
// T + 6, within the neighbour buffers (T + 6 <= n); sub_rows and
// col_window are the compute tiers' geometry (0 = off).  A block is
// `tile_h` rows of a stripe and `warps` warps; `variant` picks the rule's
// instantiation (regwin.cuh::by_rule).  `skipped` (int32[1]) and `act`
// (int32[grid]) accumulate over the launches of a dispatch; `route`
// (int32[grid]) gets this launch's routes.
extern "C" int gol_strip_frontier_launch(const void* local, const void* north, const void* south,
                                         void* wr, const void* prev_ext,
                                         const void* prev_computed, void* cur, void* rowflag,
                                         void* colspan, void* skipped, void* act, void* route,
                                         int h, int wp, int n, int turns, int stripe_h,
                                         int tile_h, int warps, int pad_f, int sub_rows,
                                         int col_window, int variant, unsigned born,
                                         unsigned surv, void* stream) {
    if (bad_reg_frontier(h, wp, turns, stripe_h, tile_h, warps, pad_f, sub_rows, col_window) ||
        turns + kSkipPeriod > n) {
        return cudaErrorInvalidValue;
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int err = reg::by_rule(variant, born, surv, [&](auto rule) {
        return launch_reg(strip_frontier_reg_kernel<decltype(rule)>, reg_grid(wp, h, tile_h, 1),
                          warps, s, static_cast<const uint32_t*>(local),
                          static_cast<const uint32_t*>(north), static_cast<const uint32_t*>(south),
                          static_cast<uint32_t*>(wr), static_cast<const int*>(prev_ext),
                          static_cast<const int*>(prev_computed), static_cast<int*>(cur),
                          static_cast<int*>(rowflag), static_cast<int*>(colspan),
                          static_cast<int*>(skipped), static_cast<int*>(route), h, wp, n, turns,
                          stripe_h, tile_h, pad_f, sub_rows, col_window, rule);
    });
    if (err != cudaSuccess) return err;
    // The state of one strip is one shard of grid stripes at parity 0.
    return finalize(cur, rowflag, colspan, act, nullptr, 1, h / stripe_h, h, stripe_h, 0,
                    kStripFields, s);
}

// K14: `rd_tab` and `wr_tab` are device arrays of ny buffer pointers,
// every strip's (no write buffer is a read buffer), `ids` a device array
// of the nids strips this launch covers and `host_ids` the same on the
// host, checked here (each in range, none twice): every strip on one
// card, or one card's strips in the peer form, whose other pointers, and
// `state`, may lie on other cards (peer access enabled by the caller);
// `state` (int32[2][10][ny * grid]), `rowflag` (int32[ny * h], zero
// between launches), `colspan` (int32[ny * grid][2]), `skipped`
// (int32[ny]) and `act` (int32[ny * grid]) persist over a chunk, the
// launch touching only its strips' entries; `route` (int32[ny * grid])
// gets this launch's routes of its strips.  The decision's reach pad_f
// (the JAX plan's round8(T + 6), >= the window's row halo T + 6) must fit
// one stripe, so nothing past the adjacent strip is read; sub_rows and
// col_window are the compute tiers' geometry (0 = off); a block is
// `tile_h` rows of a stripe and `warps` warps; `variant` picks the rule's
// instantiation (regwin.cuh::by_rule).  The launch runs on the current
// device, `stream` one of its streams.
extern "C" int gol_strip_mega_launch(const void* rd_tab, const void* wr_tab, const void* ids,
                                     const int* host_ids, void* state, void* rowflag,
                                     void* colspan, void* skipped, void* act, void* route,
                                     int nids, int ny, int h, int wp, int turns, int stripe_h,
                                     int tile_h, int warps, int pad_f, int sub_rows,
                                     int col_window, int parity, int first, int variant,
                                     unsigned born, unsigned surv, void* stream) {
    if (ny < 1 || ny > 65535 || ids == nullptr || bad_ids(host_ids, nids, ny) ||
        bad_reg_frontier(h, wp, turns, stripe_h, tile_h, warps, pad_f, sub_rows, col_window) ||
        pad_f > stripe_h || (parity != 0 && parity != 1) || (first != 0 && first != 1)) {
        return cudaErrorInvalidValue;
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int err = reg::by_rule(variant, born, surv, [&](auto rule) {
        return launch_reg(strip_mega_reg_kernel<decltype(rule)>, reg_grid(wp, h, tile_h, nids),
                          warps, s, static_cast<const uint32_t* const*>(rd_tab),
                          static_cast<uint32_t* const*>(wr_tab), static_cast<const int*>(ids),
                          static_cast<int*>(state), static_cast<int*>(rowflag),
                          static_cast<int*>(colspan), static_cast<int*>(skipped),
                          static_cast<int*>(route), ny, h, wp, turns, stripe_h, tile_h, pad_f,
                          sub_rows, col_window, parity, first, rule);
    });
    if (err != cudaSuccess) return err;
    return finalize(state, rowflag, colspan, act, ids, nids, ny * (h / stripe_h), h, stripe_h,
                    parity, kFields, s);
}

// K15: `rd_tab` and `wr_tab` are device arrays of ny * nx tile buffer
// pointers, row-major, every tile's (no write buffer is a read buffer),
// `ids` and `host_ids` the nids tiles this launch covers, as K14's;
// `state` (int32[2][10][ny * nx * grid]), `rowflag` (int32[ny * nx * h],
// zero between launches), `colspan` (int32[ny * nx * grid][2]), `skipped`
// (int32[ny * nx]) and `act` (int32[ny * nx * grid]) persist over a
// chunk, indexed tile-major, the launch touching only its tiles' entries;
// `route` (int32[ny * nx * grid]) gets this launch's routes of its tiles.
// The decision's reach pad_f (>= the window's row halo T + 6) must fit one
// stripe, so nothing past the adjacent tiles' rows is read; sub_rows and
// col_window are the compute tiers' geometry on one tile of (h, wp) words
// (0 = off); a block is `tile_h` rows of a stripe and `warps` warps;
// `variant` picks the rule's instantiation (regwin.cuh::by_rule).  The
// launch runs on the current device, `stream` one of its streams.
extern "C" int gol_tile_mega_launch(const void* rd_tab, const void* wr_tab, const void* ids,
                                    const int* host_ids, void* state, void* rowflag,
                                    void* colspan, void* skipped, void* act, void* route,
                                    int nids, int ny, int nx, int h, int wp, int turns,
                                    int stripe_h, int tile_h, int warps, int pad_f, int sub_rows,
                                    int col_window, int parity, int first, int variant,
                                    unsigned born, unsigned surv, void* stream) {
    if (ny < 1 || nx < 1 || ny * nx > 65535 || ids == nullptr ||
        bad_ids(host_ids, nids, ny * nx) ||
        bad_reg_frontier(h, wp, turns, stripe_h, tile_h, warps, pad_f, sub_rows, col_window) ||
        pad_f > stripe_h || (parity != 0 && parity != 1) || (first != 0 && first != 1)) {
        return cudaErrorInvalidValue;
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int err = reg::by_rule(variant, born, surv, [&](auto rule) {
        return launch_reg(tile_mega_reg_kernel<decltype(rule)>, reg_grid(wp, h, tile_h, nids),
                          warps, s, static_cast<const uint32_t* const*>(rd_tab),
                          static_cast<uint32_t* const*>(wr_tab), static_cast<const int*>(ids),
                          static_cast<int*>(state), static_cast<int*>(rowflag),
                          static_cast<int*>(colspan), static_cast<int*>(skipped),
                          static_cast<int*>(route), ny, nx, h, wp, turns, stripe_h, tile_h, pad_f,
                          sub_rows, col_window, parity, first, rule);
    });
    if (err != cudaSuccess) return err;
    return finalize(state, rowflag, colspan, act, ids, nids, ny * nx * (h / stripe_h), h,
                    stripe_h, parity, kFields, s);
}

// Let `device` read and write `peer`'s memory (the peer form of K14 and
// K15: a card's launches read its neighbour cards' buffers and the
// mesh's state on its first card).  Access already enabled, by an earlier
// call or by PyTorch's own copies between the two cards, counts as
// success; any other error is returned (cudaErrorTooManyPeers among
// them).  The calling thread's current device is restored.
extern "C" int gol_enable_peer_access(int device, int peer) {
    int saved = 0;
    cudaError_t err = cudaGetDevice(&saved);
    if (err != cudaSuccess) return err;
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceEnablePeerAccess(peer, 0);
    cudaGetLastError();  // the result is in err: leave nothing for a later launch check
    if (err == cudaErrorPeerAccessAlreadyEnabled) err = cudaSuccess;
    const cudaError_t back = cudaSetDevice(saved);
    return err != cudaSuccess ? err : back;
}
