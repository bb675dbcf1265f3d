// K5's kernels (csrc/walk.cu, walk.cuh) on single grids in the other
// corner rows: float32 with the octant columns (SC_F32_OCT) and bfloat16
// (SC_BF16, its octant columns a run-time flag), under every sky kind;
// and the NEE of the float32 rows without octant columns (SC_F32) under
// the Bruneton sky kinds.  walk.cu launches them from the addresses
// walk_kernels_rows gives it.

#include "walk.cuh"

WalkKernels walk_kernels_rows(int sc, int sky, bool ext) {
    WalkKernels k{};
    switch (sc) {
        case SC_F32_OCT: return kernels_of_sky<SC_F32_OCT>(sky, ext);
        case SC_BF16: return kernels_of_sky<SC_BF16>(sky, ext);
        case SC_F32:
            if (sky == SKY_ATMOSPHERE)
                k.nee = (const void*)walk_nee_kernel<SC_F32, SKY_ATMOSPHERE>;
            else if (sky == SKY_CACHE)
                k.nee = (const void*)walk_nee_kernel<SC_F32, SKY_CACHE>;
            return k;
        default: return k;
    }
}
