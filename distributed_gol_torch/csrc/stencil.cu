// K6: the byte stencil kernel.  Replaces
// distributed_gol_tpu/ops/pallas_stencil.py::_stencil_kernel (built by
// _build_step, driven by make_step_fn / make_superstep /
// make_steps_with_counts): one generation of a uint8 {0, 255} torus under
// any outer-totalistic rule, every output byte exactly 0 or 255, and, when
// the caller passes a counter, the new board's alive count added to it.
//
// What bounds it on an H100: bytes.  A generation must read the board once
// and write it once (2 * H * W bytes); a cell costs about three integer
// instructions, a fraction of what the memory rate allows.  So the design
// keeps every byte moving and nothing waiting:
// - No shared memory and no block barrier in the loop.  A thread owns a
//   column of kWords 4-cell words (kWords = 4: one 16-byte load, 16 cells;
//   a board whose rows are not 16-byte aligned, W % 16 != 0, takes the
//   kWords = 1 instantiation, one 4-byte word a thread) and walks down a
//   run of `run` rows, the rows above and at the current one in registers
//   and kAhead rows below it already requested (a register ring): with 32
//   warps an SM that is up to 64 KB in flight.
// - West and east neighbours by warp shuffle of the 3-row sums.  A warp is
//   32 such columns, lanes 1..30 its centre and lanes 0 and 31 halo
//   columns (as regwin.cuh's windows), which the neighbouring warps read
//   too, so L2 serves them; columns and rows wrap modulo the board, the
//   row index advanced by one with a compare (no modulo in the loop).
// - The rule on whole words (SWAR: no byte sum exceeds 9, so no carry
//   crosses a byte).  With n a cell's live neighbours and a its alive bit,
//   B3/S23 is alive next exactly where (n | a) == 3, and B36/S23 where
//   (n | a) is 3 or 6: one or two byte compares on the word.  Any other rule
//   takes the kernels' (born, surv) masks byte by byte (life_rule.cuh's
//   convention: bit k of born, a dead cell with total k is born; bit k of
//   surv, a live cell with total k survives), the instantiation chosen as
//   regwin.cuh::by_rule chooses it.  Output bytes are the 0/1 results
//   times 255.
// - The alive count in the epilogue: the 0/1 result bytes summed in
//   registers, then over the warp, the block, and one atomicAdd a block
//   into the caller's 64-bit counter (none when it passes null).
//
// The TPU kernel's 8-row halo (Mosaic's sublane alignment), its int32
// widening and its arithmetic rule terms (no i8 vector math or i1 selects
// in Mosaic) and its 12 MiB VMEM budget are TPU constraints and are not
// carried over.

#include <cstdint>

#include "regwin.cuh"

namespace {

using namespace gol;

constexpr int kWarps = 8;               // warps a block: blockDim = (32, kWarps)
constexpr int kCentre = 30;             // centre columns of a warp (lanes 1..30)
constexpr int kAhead = 4;               // rows requested ahead of the row being computed
constexpr uint32_t kLow = 0x01010101u;  // each byte's alive bit
constexpr uint32_t kHigh = 0x80808080u;
constexpr unsigned kFull = 0xffffffffu;

// 0x80 in each byte of x that is zero, 0 in the others (every byte < 0x80).
__device__ __forceinline__ uint32_t zero_bytes(uint32_t x) { return ~(x + 0x7f7f7f7fu) & kHigh; }

// The rule on a word: 0x80 in each byte whose cell is alive next, from
// its live neighbours n and its alive bit a (bytes 0/1).
template <class Rule>
struct ByteRule {
    uint32_t born, surv;
    __device__ __forceinline__ uint32_t operator()(uint32_t n, uint32_t a) const {
        uint32_t z = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const uint32_t ai = (a >> (8 * i)) & 1u;
            const uint32_t t = ((n >> (8 * i)) & 0xffu) + ai;  // the 9-cell total
            z |= (((ai ? surv : born) >> t) & 1u) << (8 * i + 7);
        }
        return z;
    }
};

template <>
struct ByteRule<reg::Conway> {
    uint32_t born, surv;
    __device__ __forceinline__ uint32_t operator()(uint32_t n, uint32_t a) const {
        return zero_bytes((n | a) ^ 0x03030303u);
    }
};

template <>
struct ByteRule<reg::Highlife> {
    uint32_t born, surv;
    __device__ __forceinline__ uint32_t operator()(uint32_t n, uint32_t a) const {
        const uint32_t x = n | a;
        return zero_bytes(x ^ 0x03030303u) | zero_bytes(x ^ 0x06060606u);
    }
};

// kWords consecutive 4-cell words of a row.
template <int kWords>
struct Cells {
    uint32_t w[kWords];
};

template <int kWords>
__device__ __forceinline__ Cells<kWords> load_cells(const uint8_t* p) {
    Cells<kWords> c;
    if constexpr (kWords == 4) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
        c.w[0] = v.x, c.w[1] = v.y, c.w[2] = v.z, c.w[3] = v.w;
    } else {
        c.w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
    }
    return c;
}

template <int kWords>
__device__ __forceinline__ void store_cells(uint8_t* p, const Cells<kWords>& c) {
    if constexpr (kWords == 4) {
        *reinterpret_cast<uint4*>(p) = make_uint4(c.w[0], c.w[1], c.w[2], c.w[3]);
    } else {
        *reinterpret_cast<uint32_t*>(p) = c.w[0];
    }
}

template <int kWords>
__device__ __forceinline__ Cells<kWords> alive(const Cells<kWords>& c) {
    Cells<kWords> a;
#pragma unroll
    for (int j = 0; j < kWords; ++j) a.w[j] = c.w[j] & kLow;
    return a;
}

// One warp a (run, column group) pair, warp-major over the groups of a
// run: warp g of run r holds thread columns 30g - 1 .. 30g + 30 (modulo
// the row's wc columns) and writes rows [r * run, (r + 1) * run) of
// columns 30g .. 30g + 29.
template <int kWords, class Rule>
__global__ void __launch_bounds__(reg::kLanes * kWarps, 4)
stencil_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
               unsigned long long* __restrict__ count, int h, int w, int run, Rule rule) {
    constexpr int kBytes = 4 * kWords;
    const int lane = threadIdx.x;
    const int wc = w / kBytes;  // thread columns a row
    const int groups = (wc + kCentre - 1) / kCentre;
    const int warp = blockIdx.x * kWarps + threadIdx.y;
    const int y0 = warp / groups * run;
    const int cu = warp % groups * kCentre - 1 + lane;  // this lane's column, unwrapped
    const bool active = y0 < h;
    // Lanes east of the east halo column feed no centre lane: no load.
    const bool loads = active && cu <= wc;
    const bool stores = active && lane >= 1 && lane <= kCentre && cu < wc;
    const int src_w = (lane + reg::kLanes - 1) % reg::kLanes;
    const int src_e = (lane + 1) % reg::kLanes;
    uint32_t cnt = 0u;
    if (active) {
        const int n = min(run, h - y0);
        const size_t col = static_cast<size_t>(wrap(cu, wc)) * kBytes;
        // The next row to request (y0 - 1 modulo h) and its address.
        int y = y0 == 0 ? h - 1 : y0 - 1;
        const uint8_t* p = in + static_cast<size_t>(y) * w + col;
        const auto request = [&]() {
            Cells<kWords> c{};
            if (loads) c = load_cells<kWords>(p);
            if (++y == h) {
                y = 0;
                p = in + col;
            } else {
                p += w;
            }
            return c;
        };
        Cells<kWords> up = alive(request());
        Cells<kWords> mid = alive(request());
        Cells<kWords> ring[kAhead];
#pragma unroll
        for (int k = 0; k < kAhead; ++k) ring[k] = request();
        uint8_t* q = out + static_cast<size_t>(y0) * w + col;
        for (int i0 = 0; i0 < n; i0 += kAhead) {
            uint32_t acc = 0u;  // 0/1 result bytes of this chunk, summed bytewise
#pragma unroll
            for (int k = 0; k < kAhead; ++k) {
                if (i0 + k >= n) continue;  // warp-uniform: the run's last chunk
                const Cells<kWords> dn = alive(ring[k]);
                if (i0 + k + kAhead < n) ring[k] = request();
                Cells<kWords> v, res;
#pragma unroll
                for (int j = 0; j < kWords; ++j) v.w[j] = up.w[j] + mid.w[j] + dn.w[j];
                const uint32_t vw = __shfl_sync(kFull, v.w[kWords - 1], src_w);
                const uint32_t ve = __shfl_sync(kFull, v.w[0], src_e);
#pragma unroll
                for (int j = 0; j < kWords; ++j) {
                    const uint32_t prev = j > 0 ? v.w[j - 1] : vw;
                    const uint32_t next = j + 1 < kWords ? v.w[j + 1] : ve;
                    const uint32_t west = __funnelshift_l(prev, v.w[j], 8);
                    const uint32_t east = __funnelshift_r(v.w[j], next, 8);
                    const uint32_t ones = rule(west + east + v.w[j] - mid.w[j], mid.w[j]) >> 7;
                    res.w[j] = ones * 0xffu;
                    acc += ones;
                }
                if (stores) store_cells<kWords>(q, res);
                q += w;
                up = mid;
                mid = dn;
            }
            cnt += (acc * kLow) >> 24;  // the chunk's bytes summed: at most 4 * kWords * kAhead
        }
    }
    if (count == nullptr) return;  // the same for every thread of the launch
    __shared__ uint32_t part[kWarps];
    const uint32_t s = __reduce_add_sync(kFull, stores ? cnt : 0u);
    if (lane == 0) part[threadIdx.y] = s;
    __syncthreads();
    if (threadIdx.y == 0) {
        const uint32_t b = __reduce_add_sync(kFull, lane < kWarps ? part[lane] : 0u);
        if (lane == 0 && b) atomicAdd(count, static_cast<unsigned long long>(b));
    }
}

}  // namespace

// One generation of the h x w board `in` into `out` (never `in` itself);
// `count`, when not null, gains the new board's alive count.  `words` is
// 4 (rows 16-byte aligned: w % 16 == 0 and both boards 16-byte aligned) or
// 1 (w % 4 == 0, 4-byte aligned); `run` rows a warp; `variant` picks the
// rule's instantiation (regwin.cuh::by_rule: 0 any rule, 1 B3/S23, 2
// B36/S23).
extern "C" int gol_stencil_launch(const void* in, void* out, void* count, int h, int w, int words,
                                  int run, int variant, unsigned born, unsigned surv,
                                  void* stream) {
    if (h < 1 || w < 4 || w % (4 * words) != 0 || (words != 4 && words != 1) || run < 1 ||
        in == out) {
        return cudaErrorInvalidValue;
    }
    const long long groups = (w / (4 * words) + kCentre - 1) / kCentre;
    const long long warps = groups * ((h + run - 1) / run);
    const long long blocks = (warps + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    const dim3 block(reg::kLanes, kWarps);
    const auto s = static_cast<cudaStream_t>(stream);
    return reg::by_rule(variant, born, surv, [&](auto rule) {
        using R = ByteRule<decltype(rule)>;
        const R r{born, surv};
        const auto* src = static_cast<const uint8_t*>(in);
        auto* dst = static_cast<uint8_t*>(out);
        auto* c = static_cast<unsigned long long*>(count);
        if (words == 4) {
            stencil_kernel<4, R><<<static_cast<unsigned>(blocks), block, 0, s>>>(src, dst, c, h, w,
                                                                                run, r);
        } else {
            stencil_kernel<1, R><<<static_cast<unsigned>(blocks), block, 0, s>>>(src, dst, c, h, w,
                                                                                run, r);
        }
        return static_cast<int>(cudaGetLastError());
    });
}
