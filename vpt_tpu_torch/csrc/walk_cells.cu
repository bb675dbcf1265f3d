// K5's kernels (csrc/walk.cu, walk.cuh) on instanced scenes: with cell
// lists (SC_CELLS) and the static loop over every instance (SC_LOOP),
// under every sky kind.  walk.cu launches them from the addresses
// walk_kernels_cells gives it.

#include "walk.cuh"

WalkKernels walk_kernels_cells(int sc, int sky, bool ext) {
    switch (sc) {
        case SC_CELLS: return kernels_of_sky<SC_CELLS>(sky, ext);
        case SC_LOOP: return kernels_of_sky<SC_LOOP>(sky, ext);
        default: return WalkKernels{};
    }
}
