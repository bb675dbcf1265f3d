// The launch of the probe kernels P2 (take_along.cu) and P3 (roll.cu),
// computed in Python (vpt_tpu_torch/ops/probe.py: take_along_design,
// roll_launch) and mirrored there by the ctypes struct _ProbeLaunch, and
// the per-launch divider both kernels take (n, c) from.
#pragma once

struct ProbeLaunch {
    int N, C, axis, iters, shift;
    int design, vec, threads, grid_x, grid_y, smem, per_block, chains;
    int strip;
    unsigned len_magic, len_shift, c_magic, c_shift;
};

// n / d for n < 2^31, with (magic, shift) from probe.py::divider(d):
// shift = ceil(log2 d), magic = 2^32 (2^shift - d) / d + 1.
__device__ __forceinline__ unsigned udiv(unsigned n, unsigned magic,
                                         unsigned shift) {
    return (__umulhi(n, magic) + n) >> shift;
}
