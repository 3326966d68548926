// K5: the frontier kernel.  Replaces
// distributed_gol_tpu/ops/pallas_packed.py::_kernel_frontier_mega (its
// decisions _hit_union, its measure _measure2), the kernel _run_tiled runs
// for whole chunks of launches of a skip_stable dispatch.
//
// The TPU kernel runs a chunk of launches as one pallas_call with the
// per-stripe state in SMEM.  Here one launch (T generations, T a multiple
// of 6, T + 6 <= 32) is two CUDA kernels chained on the stream, and the
// state lives in device memory, so there is no host round trip between
// launches:
//
//   state  int32[2][5][grid]: per launch parity, the two tracked row
//          intervals of each stripe (lo0, hi0, lo1, hi1; empty = (2^30, -1),
//          board rows, inside the stripe) and whether the stripe computed;
//   rowflag int32[H]: rows whose gen-(T+6) state differs from gen T,
//          inside each stripe's measure region — zero between launches;
//   skipped int32[1], act int32[grid]: the skip count and the per-stripe
//          activity, accumulated over the chunk.
//
// frontier_kernel, one block per tile (row sub-tiles of a stripe x word
// columns with a one-word column halo):
// - reads the neighbour stripes' intervals from the previous parity,
//   placed in this stripe's row frame across the torus wrap, and decides
//   `hit` and the clamped union exactly as _hit_union does, with the JAX
//   kernel's pad_f = round8(T + 6); launch 0 of a chunk forces hit and the
//   maximal union;
// - a stripe that does not hit counts one skip, and copies its centre from
//   the read buffer to the write buffer if it computed last launch (the
//   write buffer holds the state of two launches ago; a stripe that also
//   skipped last launch has nothing to do);
// - a stripe that hits loads a window with a T + 6 row halo, computes T
//   generations, writes the gen-T centre, computes 6 more and flags the
//   rows of its measure region (the JAX m_lo..m_hi, in the centre) where
//   gen T + 6 differs from gen T.  The TPU kernel's row, column and
//   rectangle tiers only narrow what it computes; cells in their validity
//   regions are the true state, so computing the whole window gives the
//   same board and the same measure.
// frontier_finalize, one block per stripe: turns the stripe's row flags
// into the two intervals of _measure2 (split at the midpoint of the
// stripe-wide span), counts the stripe active when the first is nonempty,
// and clears the flags.
//
// What bounds it: integer operations on the stripes that hit (T + 6
// generations of their windows); a settled board costs two small launches.
//
// K8: the batched form (gol_frontier_batched_launch).  Replaces the
// nboards > 1 form of _kernel_frontier_mega (its leading grid axis over
// boards stacked along the row axis, driven by _run_tiled_batched): a
// contiguous stack of B same-shape boards, blockIdx.z the board.  Every
// array gains the board axis, indexed board-globally as the JAX kernel's
// gi = b * grid + i: state int32[2][5][B * grid], rowflag int32[B * H],
// skipped int32[B] (one count per board), act int32[B * grid].  Each board
// is its own torus: block (., ., b) offsets its board pointers and row
// flags by b boards, so the window gather (modulo H), the neighbour
// stripes (i +- 1 mod grid) and the interval placement across the wrap
// all stay inside board b; a dead board beside a live one is never read.
// K5 is this kernel with B = 1.

#include "window.cuh"

namespace {

using namespace gol;

constexpr int kEmpty = 1 << 30;  // pallas_packed._EMPTY_LO
constexpr int kFields = 5;       // lo0, hi0, lo1, hi1, computed

__global__ void __launch_bounds__(kThreads)
frontier_kernel(const uint32_t* __restrict__ rd, uint32_t* __restrict__ wr,
                int* __restrict__ state, int* __restrict__ rowflag, int* __restrict__ skipped,
                int h, int wp, int turns, int stripe_h, int tile_h, int tile_w, int xpad,
                int halo, int parity, int first, uint32_t born, uint32_t surv) {
    extern __shared__ uint32_t smem[];
    __shared__ int decision[3];  // hit, measure rows lo, hi
    const int grid = h / stripe_h;
    // Board b of the stack: its words, its row flags, its skip count; its
    // stripes' state at board-global index b * grid + i.
    const int board = blockIdx.z;
    const int total = gridDim.z * grid;
    rd += static_cast<size_t>(board) * h * wp;
    wr += static_cast<size_t>(board) * h * wp;
    rowflag += static_cast<size_t>(board) * h;
    skipped += board;
    const int y0 = blockIdx.y * tile_h;
    const int x0 = blockIdx.x * tile_w;
    const int i = y0 / stripe_h;
    const int c_lo = i * stripe_h;
    const int c_hi = c_lo + stripe_h - 1;
    const int t6 = turns + kSkipPeriod;
    const int* prev = state + (1 - parity) * kFields * total + board * grid;
    int* cur = state + parity * kFields * total + board * grid;
    const bool leader = thread_id() == 0 && blockIdx.x == 0 && y0 == c_lo;

    if (thread_id() == 0) {
        int hit = first;
        int u_lo = c_lo - t6;
        int u_hi = c_hi + t6;
        if (!first) {
            const int pad_f = (t6 + 7) / 8 * 8;
            const int w_lo = c_lo - pad_f;
            const int w_hi = c_hi + pad_f;
            u_lo = kEmpty;
            u_hi = -kEmpty;
            for (int slot = -1; slot <= 1; ++slot) {
                const int j = wrap(i + slot, grid);
                const int off = (i + slot - j) * stripe_h;
                for (int k = 0; k < 2; ++k) {
                    const int lo = prev[(2 * k) * total + j] + off;
                    const int hi = prev[(2 * k + 1) * total + j] + off;
                    if (lo > hi) continue;
                    if (lo - kSkipPeriod <= w_hi && hi + kSkipPeriod >= w_lo) hit = 1;
                    const int clo = max(lo, c_lo - t6);
                    const int chi = min(hi, c_hi + t6);
                    if (clo <= chi) {
                        u_lo = min(u_lo, clo);
                        u_hi = max(u_hi, chi);
                    }
                }
            }
        }
        decision[0] = hit;
        decision[1] = max(u_lo - t6, c_lo);
        decision[2] = min(u_hi + t6, c_hi);
    }
    __syncthreads();

    if (!decision[0]) {
        if (leader) {
            atomicAdd(skipped, 1);
            cur[4 * total + i] = 0;
        }
        if (prev[4 * total + i]) copy_tile(rd, wr, h, wp, y0, x0, tile_h, tile_w);
        return;
    }
    if (leader) cur[4 * total + i] = 1;

    const Window w{tile_h + 2 * halo, tile_w + 2 * xpad, y0 - halo, x0 - xpad};
    uint32_t* a = smem;
    uint32_t* b = smem + w.rows * w.cols;
    load_window(rd, a, h, wp, w);
    uint32_t* res = advance(a, b, w, turns, born, surv);
    store_centre(res, wr, h, wp, w, halo, xpad, y0, x0, tile_h, tile_w);
    __syncthreads();  // the gen-T centre in `wr` is what the measure reads
    res = advance(res, res == a ? b : a, w, kSkipPeriod, born, surv);

    // Measure: one warp per row, a flag per row that differs anywhere in
    // this tile's centre words.
    const int lane = thread_id() % 32;
    const int r_lo = max(decision[1], y0);
    const int r_hi = min(decision[2], y0 + tile_h - 1);
    for (int r = r_lo + thread_id() / 32; r <= r_hi; r += kThreads / 32) {
        const uint32_t* row = res + (r - y0 + halo) * w.cols + xpad;
        uint32_t diff = 0u;
        for (int c = lane; c < tile_w && x0 + c < wp; c += 32) {
            diff |= row[c] ^ wr[static_cast<size_t>(r) * wp + x0 + c];
        }
        if (__any_sync(0xffffffffu, diff != 0u) && lane == 0) rowflag[r] = 1;
    }
}

// One block per stripe of every board: block gi = b * grid + i.
__global__ void frontier_finalize(int* __restrict__ state, int* __restrict__ rowflag,
                                  int* __restrict__ act, int h, int stripe_h, int grid,
                                  int parity) {
    __shared__ int lo, hi, hi0, lo1;
    const int gi = blockIdx.x;
    const int total = gridDim.x;
    const int c_lo = (gi % grid) * stripe_h;  // board rows of board gi / grid
    rowflag += static_cast<size_t>(gi / grid) * h;
    int* cur = state + parity * kFields * total;
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
        act[gi] += 1;
    }
}

}  // namespace

// K8: a contiguous stack of nb boards of (h, wp) words, blockIdx.z the
// board; K5 is the stack of one board.
extern "C" int gol_frontier_batched_launch(const void* rd, void* wr, void* state, void* rowflag,
                                           void* skipped, void* act, int nb, int h, int wp,
                                           int turns, int stripe_h, int tile_h, int tile_w,
                                           int xpad, int halo, int parity, int first,
                                           unsigned born, unsigned surv, void* stream) {
    if (nb < 1 || nb > 65535 || h < 1 || wp < 1 || turns < kSkipPeriod ||
        turns % kSkipPeriod || stripe_h < 1 || h % stripe_h || tile_h < 1 ||
        stripe_h % tile_h || tile_w < 1 || halo < turns + kSkipPeriod ||
        xpad * 32 < turns + kSkipPeriod || tile_w + 2 * xpad > kCols ||
        (parity != 0 && parity != 1)) {
        return cudaErrorInvalidValue;
    }
    const long long smem = window_smem(tile_h + 2 * halo, tile_w + 2 * xpad);
    cudaError_t err = allow_smem(frontier_kernel, smem);
    if (err != cudaSuccess) return err;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid((wp + tile_w - 1) / tile_w, h / tile_h, nb);
    frontier_kernel<<<grid, dim3(kCols, kSegs), static_cast<size_t>(smem), s>>>(
        static_cast<const uint32_t*>(rd), static_cast<uint32_t*>(wr), static_cast<int*>(state),
        static_cast<int*>(rowflag), static_cast<int*>(skipped), h, wp, turns, stripe_h, tile_h,
        tile_w, xpad, halo, parity, first, born, surv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    frontier_finalize<<<nb * (h / stripe_h), 256, 0, s>>>(static_cast<int*>(state),
                                                          static_cast<int*>(rowflag),
                                                          static_cast<int*>(act), h, stripe_h,
                                                          h / stripe_h, parity);
    return cudaGetLastError();
}

