// K2: the temporally blocked tiled kernel.  Replaces
// distributed_gol_tpu/ops/pallas_packed.py::_kernel in its plain
// (skip_stable=False) form, built by _build_launch and driven by
// _run_tiled; its step is _gen.
//
// Layout: the horizontally packed board (H, W/32), bit k of word (y, wx) =
// cell (y, 32*wx + k) — the JAX package's pack layout.
//
// One launch advances T generations.  Each block owns an output tile of
// tile_h rows x tile_w words and loads a window of (tile_h + 2T) rows x
// (tile_w + 2*xpad) words into shared memory, xpad*32 >= T.  Every window
// index is taken modulo H and modulo W/32, so the window is a patch of
// the board's periodic cover: exact for any H (halos taller than the board
// included) and any W % 32 == 0.  Cells outside the window read as zero;
// the wrong border this causes grows one cell per side per generation and
// stays inside the halo, so after T generations the centre is exact and
// only it is written back.  The window ping-pongs between two buffers in
// shared memory.
//
// What bounds it on an H100: integer operations.  Per launch the board is
// read once and written once (2 * H * W/8 bytes), while the generations
// cost ~45 ops per word each; at T = 32 the operations outweigh the bytes
// by more than an order of magnitude.  The design therefore spends shared
// memory on depth: a thread walks one window column down a row segment and
// keeps the horizontal 2-bit sums of the rows above, at and below the
// current row in registers, so each word's horizontal sum is computed once
// per generation and each generation costs one __syncthreads.

#include <cuda_runtime.h>

#include "life_rule.cuh"

namespace {

constexpr int kCols = 64;  // blockDim.x: the widest window, in words
constexpr int kSegs = 16;  // blockDim.y: row segments of the window

__device__ __forceinline__ int wrap(int v, int n) {
    const int r = v % n;
    return r < 0 ? r + n : r;
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

__global__ void __launch_bounds__(kCols * kSegs)
tiled_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int h, int wp,
             int turns, int tile_h, int tile_w, int xpad, uint32_t born, uint32_t surv) {
    extern __shared__ uint32_t smem[];
    const int rows_w = tile_h + 2 * turns;
    const int cols_w = tile_w + 2 * xpad;
    const int y0 = blockIdx.y * tile_h;
    const int x0 = blockIdx.x * tile_w;
    uint32_t* src = smem;
    uint32_t* dst = smem + rows_w * cols_w;
    const int tid = threadIdx.y * kCols + threadIdx.x;

    const int n = rows_w * cols_w;
    for (int i = tid; i < n; i += kCols * kSegs) {
        const int r = i / cols_w;
        const int c = i - r * cols_w;
        src[i] = in[static_cast<size_t>(wrap(y0 - turns + r, h)) * wp + wrap(x0 - xpad + c, wp)];
    }
    __syncthreads();

    const int c = threadIdx.x;
    const int seg = (rows_w + kSegs - 1) / kSegs;
    const int r_begin = threadIdx.y * seg;
    const int r_end = min(r_begin + seg, rows_w);
    for (int g = 0; g < turns; ++g) {
        if (c < cols_w && r_begin < r_end) {
            uint32_t a_up, n0, n1, a, h0, h1;
            row_sum(src, rows_w, cols_w, r_begin - 1, c, a_up, n0, n1);
            row_sum(src, rows_w, cols_w, r_begin, c, a, h0, h1);
            for (int r = r_begin; r < r_end; ++r) {
                uint32_t a_dn, s0, s1;
                row_sum(src, rows_w, cols_w, r + 1, c, a_dn, s0, s1);
                const uint32_t t0 = h0 ^ n0 ^ s0;
                const uint32_t cc = gol_maj(h0, n0, s0);
                const uint32_t p1 = h1 ^ n1 ^ s1;
                const uint32_t q = gol_maj(h1, n1, s1);
                const uint32_t k = p1 & cc;
                dst[r * cols_w + c] = gol_apply_rule(t0, p1 ^ cc, q ^ k, q & k, a, born, surv);
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

    for (int i = tid; i < tile_h * tile_w; i += kCols * kSegs) {
        const int r = i / tile_w;
        const int c2 = i - r * tile_w;
        const int gy = y0 + r;
        const int gx = x0 + c2;
        if (gy < h && gx < wp) {
            out[static_cast<size_t>(gy) * wp + gx] = src[(r + turns) * cols_w + c2 + xpad];
        }
    }
}

}  // namespace

extern "C" int gol_tiled_launch(const void* in, void* out, int h, int wp, int turns, int tile_h,
                                int tile_w, int xpad, unsigned born, unsigned surv,
                                void* stream) {
    if (h < 1 || wp < 1 || turns < 1 || tile_h < 1 || tile_w < 1 || xpad * 32 < turns ||
        tile_w + 2 * xpad > kCols) {
        return cudaErrorInvalidValue;
    }
    const long long smem =
        2LL * (tile_h + 2LL * turns) * (tile_w + 2LL * xpad) * static_cast<long long>(sizeof(uint32_t));
    if (smem > (1 << 30)) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((wp + tile_w - 1) / tile_w, (h + tile_h - 1) / tile_h);
    const dim3 block(kCols, kSegs);
    tiled_kernel<<<grid, block, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), h, wp, turns, tile_h,
        tile_w, xpad, born, surv);
    return cudaGetLastError();
}

extern "C" const char* gol_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
