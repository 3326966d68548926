// K1: the resident kernel.  Replaces
// distributed_gol_tpu/ops/pallas_packed.py::_vmem_kernel (and its step
// _gen_vertical): every generation of a whole vertically packed board in
// one launch, the board held in one block's shared memory.
//
// Layout: (H/32, W) words, bit k of word (wy, x) = cell (32*wy + k, x) —
// the JAX package's pack_vertical layout.  Vertical neighbours are an
// in-word shift with a carry from the word row above or below, horizontal
// neighbours the column index +-1 mod W, so both wraps are exact and no
// halo is needed.
//
// What bounds it on an H100: operations, on ONE SM.  A 512^2 board is
// 32 KB; it moves 64 KB through device memory per launch, and the rest of
// the launch is ~60 integer ops per word per generation on the one SM that
// holds the board (the other 131 idle).  The design keeps one copy in
// shared memory: each thread computes its new words into registers, then
// __syncthreads, writes them back, and __syncthreads again.  Spreading the
// board over a cluster (distributed shared memory) is the redesign that
// would use more SMs.

#include <cuda_runtime.h>

#include "life_rule.cuh"

namespace {

constexpr int kThreads = 1024;

// The 2-bit vertical sum of column x: the cell plus its north and south
// neighbours, with carries across word rows.
__device__ __forceinline__ void vertical_sum(const uint32_t* b, int row, int up, int dn,
                                             int x, uint32_t& v0, uint32_t& v1) {
    const uint32_t a = b[row + x];
    const uint32_t north = (a << 1) | (b[up + x] >> 31);
    const uint32_t south = (a >> 1) | (b[dn + x] << 31);
    v0 = a ^ north ^ south;
    v1 = gol_maj(a, north, south);
}

// NW = words per thread (a power of two >= ceil(H/32 * W / kThreads)).
template <int NW>
__global__ void __launch_bounds__(kThreads)
resident_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int hw, int w,
                int turns, uint32_t born, uint32_t surv) {
    extern __shared__ uint32_t board[];
    const int n = hw * w;
    for (int i = threadIdx.x; i < n; i += kThreads) board[i] = in[i];
    __syncthreads();
    for (int t = 0; t < turns; ++t) {
        uint32_t next[NW];
#pragma unroll
        for (int j = 0; j < NW; ++j) {
            const int i = threadIdx.x + j * kThreads;
            if (i >= n) break;
            const int wy = i / w;
            const int x = i - wy * w;
            const int row = wy * w;
            const int up = (wy == 0 ? hw - 1 : wy - 1) * w;
            const int dn = (wy == hw - 1 ? 0 : wy + 1) * w;
            const int xm = x == 0 ? w - 1 : x - 1;
            const int xp = x == w - 1 ? 0 : x + 1;
            uint32_t v0, v1, v0w, v1w, v0e, v1e;
            vertical_sum(board, row, up, dn, x, v0, v1);
            vertical_sum(board, row, up, dn, xm, v0w, v1w);
            vertical_sum(board, row, up, dn, xp, v0e, v1e);
            const uint32_t s0 = v0 ^ v0w ^ v0e;
            const uint32_t c0 = gol_maj(v0, v0w, v0e);
            const uint32_t s1 = v1 ^ v1w ^ v1e;
            const uint32_t c1 = gol_maj(v1, v1w, v1e);
            const uint32_t k = c0 & s1;
            next[j] = gol_apply_rule(s0, c0 ^ s1, c1 ^ k, c1 & k, board[i], born, surv);
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < NW; ++j) {
            const int i = threadIdx.x + j * kThreads;
            if (i >= n) break;
            board[i] = next[j];
        }
        __syncthreads();
    }
    for (int i = threadIdx.x; i < n; i += kThreads) out[i] = board[i];
}

template <int NW>
cudaError_t launch(const uint32_t* in, uint32_t* out, int hw, int w, int turns, uint32_t born,
                   uint32_t surv, cudaStream_t stream) {
    const int smem = hw * w * static_cast<int>(sizeof(uint32_t));
    cudaError_t err = cudaFuncSetAttribute(resident_kernel<NW>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    resident_kernel<NW><<<1, kThreads, smem, stream>>>(in, out, hw, w, turns, born, surv);
    return cudaGetLastError();
}

}  // namespace

extern "C" int gol_resident_launch(const void* in, void* out, int hw, int w, int turns,
                                   unsigned born, unsigned surv, void* stream) {
    const auto* src = static_cast<const uint32_t*>(in);
    auto* dst = static_cast<uint32_t*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    if (hw < 1 || w < 1 || turns < 1) return cudaErrorInvalidValue;
    const int per_thread = (hw * w + kThreads - 1) / kThreads;
    if (per_thread <= 1) return launch<1>(src, dst, hw, w, turns, born, surv, s);
    if (per_thread <= 2) return launch<2>(src, dst, hw, w, turns, born, surv, s);
    if (per_thread <= 4) return launch<4>(src, dst, hw, w, turns, born, surv, s);
    if (per_thread <= 8) return launch<8>(src, dst, hw, w, turns, born, surv, s);
    if (per_thread <= 16) return launch<16>(src, dst, hw, w, turns, born, surv, s);
    if (per_thread <= 32) return launch<32>(src, dst, hw, w, turns, born, surv, s);
    if (per_thread <= 64) return launch<64>(src, dst, hw, w, turns, born, surv, s);
    return cudaErrorInvalidValue;
}

extern "C" const char* gol_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
