// K6: the byte stencil kernel.  Replaces
// distributed_gol_tpu/ops/pallas_stencil.py::_stencil_kernel (built by
// _build_step, driven by make_step_fn / make_superstep /
// make_steps_with_counts): one generation of a uint8 {0, 255} torus under
// any outer-totalistic rule, every output byte exactly 0 or 255.
//
// Each block owns a tile of kTileH rows x kTileW cells and stages it in
// shared memory with a one-cell ring, every row and column index of the
// ring taken modulo the board, so any H >= 1 and any W % 4 == 0 qualify
// (ops/cuda_stencil.py::supports).  A lane owns one 4-cell word of a row in
// each of kRowsPerThread rows.  The alive bits (v & 1) of the three rows
// are summed bytewise (SWAR: no byte total exceeds 9, so no carry crosses
// a byte), then the three columns, giving each cell's 9-cell total; the
// rule is the kernels' pair of 9-bit masks over that total (born: dead
// cell with total k; surv: live cell with total k, i.e. k - 1 neighbours),
// exactly as in life_rule.cuh.
//
// The TPU kernel's 8-row halo (Mosaic's sublane alignment), its int32
// widening and its arithmetic rule terms (no i8 vector math or i1 selects
// in Mosaic) and its 12 MiB VMEM budget are TPU constraints and are not
// carried over.
//
// What bounds it on an H100: bytes.  A generation must read the board once
// and write it once (2 * H * W bytes), while a cell costs a handful of
// integer instructions.  So every load and store of the board is a 4-byte
// word, a warp covering 128 contiguous bytes of a row, and each board byte
// is read from device memory once per tile (plus the ring).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsY = 8;                        // blockDim.y
constexpr int kRowsPerThread = 4;
constexpr int kTileW = 4 * kWarp;                // 128 cells: one word per lane
constexpr int kTileH = kRowsY * kRowsPerThread;  // 32 rows
constexpr int kPad = 4;                          // the tile's first cell sits at a word boundary
constexpr int kStride = kTileW + 2 * kPad;       // bytes per staged row
constexpr int kRows = kTileH + 2;                // the tile plus its one-row ring

// i modulo n for i >= -n (the ring reaches one cell before the board).
__device__ __forceinline__ int wrap(int i, int n) {
    return i < 0 ? i + n : (i >= n ? i % n : i);
}

__global__ void __launch_bounds__(kWarp * kRowsY)
stencil_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int h, int w,
               uint32_t born, uint32_t surv) {
    __shared__ __align__(16) uint8_t tile[kRows * kStride];
    const int wq = w / 4;  // words per board row
    const int y0 = blockIdx.y * kTileH;
    const int x0 = blockIdx.x * kTileW;
    const int lane = threadIdx.x;
    const uint32_t* in32 = reinterpret_cast<const uint32_t*>(in);

    // Stage rows y0 - 1 .. y0 + kTileH and cells x0 - 1 .. x0 + kTileW,
    // modulo the board, as alive bits.  W % 4 == 0, so the word at cell
    // (x0 + 4 * lane) mod W holds cells x0 + 4 * lane .. + 3 mod W.
    const int word = wrap(x0 / 4 + lane, wq);
    const int west = wrap(x0 - 1, w);
    const int east = wrap(x0 + kTileW, w);
    for (int r = threadIdx.y; r < kRows; r += kRowsY) {
        const size_t row = static_cast<size_t>(wrap(y0 - 1 + r, h)) * w;
        uint8_t* dst = tile + r * kStride + kPad;
        reinterpret_cast<uint32_t*>(dst)[lane] = in32[row / 4 + word] & 0x01010101u;
        if (lane == 0) dst[-1] = in[row + west] & 1u;
        if (lane == 1) dst[kTileW] = in[row + east] & 1u;
    }
    __syncthreads();

    const int cx = kPad + 4 * lane;
    const int gx = x0 + 4 * lane;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
        const int r = 1 + threadIdx.y + k * kRowsY;  // staged row of this output row
        const int gy = y0 + r - 1;
        // Three-row sums of this word's cells (byte i = cell gx + i, little
        // endian) and of the cells just west and east of it.
        uint32_t v = 0, vw = 0, ve = 0;
#pragma unroll
        for (int d = -1; d <= 1; ++d) {
            const uint8_t* p = tile + (r + d) * kStride + cx;
            v += *reinterpret_cast<const uint32_t*>(p);
            vw += p[-1];
            ve += p[4];
        }
        // Three-column sums: byte i = v[i - 1] + v[i] + v[i + 1].
        const uint32_t total = v + ((v << 8) | vw) + ((v >> 8) | (ve << 24));
        const uint32_t centre = *reinterpret_cast<const uint32_t*>(tile + r * kStride + cx);
        uint32_t res = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const uint32_t t = (total >> (8 * i)) & 0xffu;
            const uint32_t rule = ((centre >> (8 * i)) & 1u) ? surv : born;
            res |= (((rule >> t) & 1u) * 0xffu) << (8 * i);
        }
        if (gy < h && gx < w) {
            reinterpret_cast<uint32_t*>(out)[static_cast<size_t>(gy) * wq + gx / 4] = res;
        }
    }
}

}  // namespace

extern "C" int gol_stencil_launch(const void* in, void* out, int h, int w, unsigned born,
                                  unsigned surv, void* stream) {
    if (h < 1 || w < 4 || w % 4 != 0 || in == out) return cudaErrorInvalidValue;
    const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
    if (grid.y > 65535u) return cudaErrorInvalidValue;
    stencil_kernel<<<grid, dim3(kWarp, kRowsY), 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), h, w, born, surv);
    return cudaGetLastError();
}

extern "C" const char* gol_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
