// Shared device helpers of the packed Life kernels: the full-adder carry
// and the B/S rule applied on the four 9-cell total planes.
//
// The rule is a runtime argument, so one build serves every life-like
// rule.  It is evaluated exactly as ops/packed.py::apply_rule_planes does:
// a dead cell has total T == its neighbour count, a live cell T == count
// + 1, so births match T == b and survivals T == s + 1, and a total in both
// sets is independent of the centre.
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t gol_maj(uint32_t a, uint32_t b, uint32_t c) {
    return (a & b) | (c & (a ^ b));
}

// born: bit k set = a dead cell with total k turns alive (k = birth count).
// surv: bit k set = a live cell with total k stays alive (k = survive count + 1).
// Totals are in [0, 9], so the 4-bit compare below is exact for k <= 9.
__device__ __forceinline__ uint32_t gol_apply_rule(uint32_t t0, uint32_t t1, uint32_t t2,
                                                   uint32_t t3, uint32_t centre,
                                                   uint32_t born, uint32_t surv) {
    uint32_t out = 0u;
#pragma unroll
    for (int k = 0; k < 10; ++k) {
        const bool b = (born >> k) & 1u;
        const bool s = (surv >> k) & 1u;
        if (!(b || s)) continue;  // uniform across the block: no divergence
        const uint32_t m = ((k & 1) ? t0 : ~t0) & ((k & 2) ? t1 : ~t1) &
                           ((k & 4) ? t2 : ~t2) & ((k & 8) ? t3 : ~t3);
        out |= m & (b ? (s ? 0xffffffffu : ~centre) : centre);
    }
    return out;
}
