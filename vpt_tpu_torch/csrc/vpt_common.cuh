// Shared device code for the port's CUDA kernels: jax.random's
// threefry-2x32 stream and the float32 vector helpers.
//
// Every operation is written in the order the plain PyTorch versions
// use (vpt_tpu_torch/core/vecmath.py), and the library is built with
// -fmad=false, so a kernel and its plain version round alike.  min/max
// propagate NaN like torch.minimum/maximum (fminf/fmaxf do not).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace vpt {

constexpr float EPS = 1e-3f;
constexpr float TWO_PI_F = 6.28318530717958647692f;

// ---------------------------------------------------------------- RNG --

struct Key {
    uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

// jax/_src/prng.py::_threefry2x32: 20 rounds, key schedule every 4.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
    const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define VPT_ROUND(r) x0 += x1; x1 = rotl32(x1, r); x1 ^= x0;
    x0 += k0; x1 += k1;
    VPT_ROUND(13) VPT_ROUND(15) VPT_ROUND(26) VPT_ROUND(6)
    x0 += k1; x1 += k2 + 1u;
    VPT_ROUND(17) VPT_ROUND(29) VPT_ROUND(16) VPT_ROUND(24)
    x0 += k2; x1 += k0 + 2u;
    VPT_ROUND(13) VPT_ROUND(15) VPT_ROUND(26) VPT_ROUND(6)
    x0 += k0; x1 += k1 + 3u;
    VPT_ROUND(17) VPT_ROUND(29) VPT_ROUND(16) VPT_ROUND(24)
    x0 += k1; x1 += k2 + 4u;
    VPT_ROUND(13) VPT_ROUND(15) VPT_ROUND(26) VPT_ROUND(6)
    x0 += k2; x1 += k0 + 5u;
#undef VPT_ROUND
}

// jax.random.fold_in(key, data) and split(key)[i]: threefry over (0, n).
__device__ __forceinline__ Key fold_in(Key k, uint32_t n) {
    uint32_t x0 = 0u, x1 = n;
    threefry2x32(k.k0, k.k1, x0, x1);
    return Key{x0, x1};
}

__device__ __forceinline__ Key split_at(Key k, uint32_t i) {
    return fold_in(k, i);
}

// Element i of jax.random.uniform(key, shape) (partitionable threefry):
// bits = b1 ^ b2 of threefry over (hi32(i), lo32(i)), mantissa of [1,2).
__device__ __forceinline__ float uniform_at(Key k, unsigned long long i) {
    uint32_t x0 = static_cast<uint32_t>(i >> 32);
    uint32_t x1 = static_cast<uint32_t>(i & 0xFFFFFFFFull);
    threefry2x32(k.k0, k.k1, x0, x1);
    const uint32_t bits = x0 ^ x1;
    return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// uniform_at for an element index below 2^32, whose high counter word is
// 0: the same bits, without the 64-bit index arithmetic.
__device__ __forceinline__ float uniform_at32(Key k, uint32_t i) {
    uint32_t x0 = 0u, x1 = i;
    threefry2x32(k.k0, k.k1, x0, x1);
    const uint32_t bits = x0 ^ x1;
    return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// ------------------------------------------------------------ scalars --

// x / d1 and x / d2, each rounded once to float32, for divisors known in
// advance and y = RN(1/d) from the host: Markstein's division with an
// FMA (Muller et al., Handbook of Floating-Point Arithmetic): q0 =
// RN(x y), the remainder r = x - q0 d is exact, and RN(q0 + r y) = RN(x
// / d) wherever the quotient is normal.  fminf maps the NaN remainder of
// an infinite x to a finite one, so x = +-Inf gives +-Inf.  Below
// DIV_KNOWN_MIN (zero, and x whose quotient may be subnormal, where an
// exact tie between two subnormals can round the wrong way) and for NaN
// it is IEEE division, out of line.  The common path is one compare for
// both divisors, then three FMA-pipe operations and a min each, and no
// MUFU, against IEEE division's reciprocal, refinement and range check.
// vpt_div_known_sweep (environment.cu) holds it to __fdiv_rn over all
// 2^32 patterns of x; chip_smoke.py does so for the sky's two divisors.
constexpr float DIV_KNOWN_MIN = 7.8886090522101181e-31f;   // 2^-100

static __device__ __noinline__ float div_ieee(float x, float d) {
    return __fdiv_rn(x, d);
}

__device__ __forceinline__ float div_known_path(float x, float d, float y) {
    const float q0 = __fmul_rn(x, y);
    const float r = fminf(__fmaf_rn(-q0, d, x), 3.402823466e38f);
    return __fmaf_rn(r, y, q0);
}

__device__ __forceinline__ void div_known2(float x, float d1, float y1,
                                           float d2, float y2, float& q1,
                                           float& q2) {
    if (fabsf(x) >= DIV_KNOWN_MIN) {
        q1 = div_known_path(x, d1, y1);
        q2 = div_known_path(x, d2, y2);
    } else {
        q1 = div_ieee(x, d1);
        q2 = div_ieee(x, d2);
    }
}

__device__ __forceinline__ float jmax(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return a > b ? a : b;
}

__device__ __forceinline__ float jmin(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return a < b ? a : b;
}

__device__ __forceinline__ float jclamp(float x, float lo, float hi) {
    return jmin(jmax(x, lo), hi);
}

// -------------------------------------------------------------- vec3 --

struct V3 {
    float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
    return V3{x, y, z};
}
__device__ __forceinline__ V3 v3(const float* p) { return V3{p[0], p[1], p[2]}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
    return V3{a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
    return V3{a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator-(V3 a) { return V3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) {
    return V3{a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 operator*(V3 a, float s) {
    return V3{a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 operator/(V3 a, V3 b) {
    return V3{a.x / b.x, a.y / b.y, a.z / b.z};
}
__device__ __forceinline__ V3 operator/(V3 a, float s) {
    return V3{a.x / s, a.y / s, a.z / s};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
    return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float length(V3 a) {
    return sqrtf(jmax(dot(a, a), 0.0f));
}
__device__ __forceinline__ V3 normalize(V3 a) {
    return a * rsqrtf(jmax(dot(a, a), 1e-20f));
}
// helper_math.h reflect: i - 2 n (n . i)
__device__ __forceinline__ V3 reflect(V3 i, V3 n) {
    return i - (n * 2.0f) * dot(n, i);
}

}  // namespace vpt
