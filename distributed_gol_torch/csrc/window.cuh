// Shared device code of the tiled kernels (K2 tiled.cu, K3 tiled_skip.cu,
// K4, K11 and K13 probing.cu, K5, K8 and K12 frontier.cu, K9 and K10 ext.cu): a
// window of the horizontally packed board in shared memory, stepped
// generation by generation.
//
// Layout: the horizontally packed board (H, W/32), bit k of word (y, wx) =
// cell (y, 32*wx + k) — the JAX package's pack layout.
//
// A window is `rows` x `cols` words whose word (0, 0) is board word
// (top, left); every index is taken modulo H and modulo W/32, so the
// window is a patch of the board's periodic cover: exact for any H (halos
// taller than the board included) and any W % 32 == 0.  Cells outside the
// window read as zero; the wrong border this causes grows one cell per
// side per generation, so after g generations the cells at least g rows
// and g cells from the window's edge hold the board's true state.
//
// A thread walks one window column down a row segment and keeps the
// horizontal 2-bit sums of the rows above, at and below the current row in
// registers, so each word's horizontal sum is computed once per generation
// and each generation costs one __syncthreads.  Blocks are kCols x kSegs
// threads; every function here is called by all threads of the block.
#pragma once

#include <cuda_runtime.h>

#include "life_rule.cuh"

namespace gol {

constexpr int kCols = 64;  // blockDim.x: the widest window, in words
constexpr int kSegs = 16;  // blockDim.y: row segments of the window
constexpr int kThreads = kCols * kSegs;
constexpr int kSkipPeriod = 6;  // the skip proof's stability window

struct Window {
    int rows, cols;  // size in words
    int top, left;   // board row and word column of window word (0, 0), unwrapped
};

__device__ __forceinline__ int wrap(int v, int n) {
    const int r = v % n;
    return r < 0 ? r + n : r;
}

__device__ __forceinline__ int thread_id() { return threadIdx.y * kCols + threadIdx.x; }

__device__ __forceinline__ uint32_t board_word(const uint32_t* b, int h, int wp, int y, int x) {
    return b[static_cast<size_t>(wrap(y, h)) * wp + wrap(x, wp)];
}

// Where a window's words come from.  A source maps a word's unwrapped
// (row, word column) to the word; the window code below takes any source.
//
// BoardSource: the whole torus, rows modulo h and words modulo wp.
struct BoardSource {
    const uint32_t* b;
    int h, wp;
    __device__ __forceinline__ uint32_t operator()(int y, int x) const {
        return board_word(b, h, wp, y, x);
    }
};

// StripSource: one row strip of a row mesh (h rows of the board's full
// width wp) with its neighbours' boundary rows in separate buffers of n
// rows each: row y < 0 is north[n + y] (north's last row borders the
// strip's first), row y >= h is south[y - h]; words modulo wp, since the
// strip spans the board's width.  Rows stay within [-n, h + n).
struct StripSource {
    const uint32_t* local;
    const uint32_t* north;
    const uint32_t* south;
    int h, wp, n;
    __device__ __forceinline__ uint32_t operator()(int y, int x) const {
        const uint32_t* row = y < 0    ? north + static_cast<size_t>(n + y) * wp
                              : y >= h ? south + static_cast<size_t>(y - h) * wp
                                       : local + static_cast<size_t>(y) * wp;
        return row[wrap(x, wp)];
    }
};

// Gather the window from `src` into `win`.
template <class Source>
__device__ void load_window(const Source& src, uint32_t* win, const Window& w) {
    const int n = w.rows * w.cols;
    for (int i = thread_id(); i < n; i += kThreads) {
        const int r = i / w.cols;
        const int c = i - r * w.cols;
        win[i] = src(w.top + r, w.left + c);
    }
    __syncthreads();
}

// Gather the window from the board into `win`.
__device__ void load_window(const uint32_t* __restrict__ in, uint32_t* win, int h, int wp,
                            const Window& w) {
    load_window(BoardSource{in, h, wp}, win, w);
}

// Word (r, c) of the window and the 2-bit horizontal sum of its cell with
// its west and east neighbours; rows and columns outside the window read
// as zero.
__device__ __forceinline__ void row_sum(const uint32_t* win, int rows_w, int cols_w, int r,
                                        int c, uint32_t& a, uint32_t& h0, uint32_t& h1) {
    if (r < 0 || r >= rows_w) {
        a = h0 = h1 = 0u;
        return;
    }
    const uint32_t* row = win + r * cols_w;
    a = row[c];
    const uint32_t left = c > 0 ? row[c - 1] : 0u;
    const uint32_t right = c + 1 < cols_w ? row[c + 1] : 0u;
    const uint32_t west = (a << 1) | (left >> 31);
    const uint32_t east = (a >> 1) | (right << 31);
    h0 = a ^ west ^ east;
    h1 = gol_maj(a, west, east);
}

// `gens` generations of the window in `src`, ping-ponging with `dst`;
// returns the buffer that holds the result (`src` when gens == 0).
__device__ uint32_t* advance(uint32_t* src, uint32_t* dst, const Window& w, int gens,
                             uint32_t born, uint32_t surv) {
    const int c = threadIdx.x;
    const int seg = (w.rows + kSegs - 1) / kSegs;
    const int r_begin = threadIdx.y * seg;
    const int r_end = min(r_begin + seg, w.rows);
    for (int g = 0; g < gens; ++g) {
        if (c < w.cols && r_begin < r_end) {
            uint32_t a_up, n0, n1, a, h0, h1;
            row_sum(src, w.rows, w.cols, r_begin - 1, c, a_up, n0, n1);
            row_sum(src, w.rows, w.cols, r_begin, c, a, h0, h1);
            for (int r = r_begin; r < r_end; ++r) {
                uint32_t a_dn, s0, s1;
                row_sum(src, w.rows, w.cols, r + 1, c, a_dn, s0, s1);
                const uint32_t t0 = h0 ^ n0 ^ s0;
                const uint32_t cc = gol_maj(h0, n0, s0);
                const uint32_t p1 = h1 ^ n1 ^ s1;
                const uint32_t q = gol_maj(h1, n1, s1);
                const uint32_t k = p1 & cc;
                dst[r * w.cols + c] = gol_apply_rule(t0, p1 ^ cc, q ^ k, q & k, a, born, surv);
                n0 = h0;
                n1 = h1;
                h0 = s0;
                h1 = s1;
                a = a_dn;
            }
        }
        __syncthreads();
        uint32_t* tmp = src;
        src = dst;
        dst = tmp;
    }
    return src;
}

// The skip proof's test: whether the window `win`, kSkipPeriod generations
// on, equals the source `src` it was loaded from on the window's inner
// region — rows and cells at least kSkipPeriod from the window's edge,
// where the gen-6 state is exact.  If it does, the board is period-6
// stable there, and by induction the window's cells at least T rows and T
// cells from its edge hold their gen-0 value at every generation T that
// is a multiple of 6.  The same value in every thread.
template <class Source>
__device__ bool inner_stable(const uint32_t* win, const Source& src, const Window& w) {
    const int r0 = kSkipPeriod;
    const int n = (w.rows - 2 * kSkipPeriod) * w.cols;
    uint32_t diff = 0u;
    for (int i = thread_id(); i < n; i += kThreads) {
        const int r = r0 + i / w.cols;
        const int c = i % w.cols;
        uint32_t mask = 0xffffffffu;
        if (c == 0) mask &= 0xffffffc0u;           // cells 0..5 of the window row
        if (c == w.cols - 1) mask &= 0x03ffffffu;  // its last six cells
        diff |= (win[r * w.cols + c] ^ src(w.top + r, w.left + c)) & mask;
    }
    return __syncthreads_or(diff != 0u) == 0;
}

__device__ bool inner_stable(const uint32_t* win, const uint32_t* __restrict__ in, int h, int wp,
                             const Window& w) {
    return inner_stable(win, BoardSource{in, h, wp}, w);
}

// Write the window's centre — rows [halo, halo + tile_h), words
// [xpad, xpad + tile_w) — to the tile of `out` at (y0, x0), clipped to
// the board.
__device__ void store_centre(const uint32_t* win, uint32_t* __restrict__ out, int h, int wp,
                             const Window& w, int halo, int xpad, int y0, int x0, int tile_h,
                             int tile_w) {
    for (int i = thread_id(); i < tile_h * tile_w; i += kThreads) {
        const int r = i / tile_w;
        const int c = i - r * tile_w;
        const int gy = y0 + r;
        const int gx = x0 + c;
        if (gy < h && gx < wp) {
            out[static_cast<size_t>(gy) * wp + gx] = win[(r + halo) * w.cols + c + xpad];
        }
    }
}

// Copy the tile at (y0, x0) from board `in` to board `out`, clipped.
__device__ void copy_tile(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int h,
                          int wp, int y0, int x0, int tile_h, int tile_w) {
    for (int i = thread_id(); i < tile_h * tile_w; i += kThreads) {
        const int r = i / tile_w;
        const int c = i - r * tile_w;
        const int gy = y0 + r;
        const int gx = x0 + c;
        if (gy < h && gx < wp) {
            const size_t at = static_cast<size_t>(gy) * wp + gx;
            out[at] = in[at];
        }
    }
}

// Allow `smem` bytes of dynamic shared memory for `kernel`.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long long smem) {
    if (smem > (1 << 30)) return cudaErrorInvalidValue;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
}

__host__ __forceinline__ long long window_smem(int rows, int cols) {
    return 2LL * rows * cols * static_cast<long long>(sizeof(uint32_t));
}

}  // namespace gol

extern "C" const char* gol_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
