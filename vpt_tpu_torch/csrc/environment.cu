// K4 — the terminal environment: L[i] += env(dir[i]) * beta[i] for each
// ray K1 retired, in place on K1's L field.
//
// Replaces: vpt_tpu/render/integrator.py::environment_radiance, applied
// after the walk at vpt_tpu/render/fused.py:778-779 (and :755-767 for
// queued rays), for the two environments that depend on the direction:
// - HDRI: sky/envmap.py::sample_env_map (env_uv, then 4 bilinear taps,
//   x wrapping, y clamped) on the raw (H, W, 3) map, times sky_color and
//   isotropic();
// - ATMOSPHERE without an attached atmosphere: sky/procedural.py::
//   sample_sky, the 16 x 8 single-scattering march, times sky_color and
//   sky_mult;
// - ATMOSPHERE with a Bruneton atmosphere (vpt_tpu/sky/runtime.py:161
//   sample_atmosphere, through nee.py:41-44 and runtime.py:257): from
//   the ray's retired position, the ground hit, then the ground (the sun
//   and sky irradiance and the aerial perspective to the hit point) or
//   the sky (the transmittance and the 4-D scattering lookups), the sun
//   disc and the exposure curve, times sky_color and sky_mult;
// - the same with a baked sky cache (runtime.py:203 sample_sky_cache):
//   one bilinear fetch of the (H, W, 6) equirect texture, x wrapping and
//   y clamped, then the sun disc and the curve.
// Its plain PyTorch version is vpt_tpu_torch/render/integrator.py::
// environment_radiance (add_environment on a CPU tensor; for the
// atmosphere vpt_tpu_torch/sky/runtime.py), whose
// arithmetic this kernel repeats operation for operation: the same
// float32 constants (from the wrapper), the same order of every sum and
// product, true divisions (by HR and HM as div_known2, which is IEEE
// division), and, built with -fmad=false and without fast math, the
// accurate expf/sqrtf/powf/atan2f/acosf.  Every ray is evaluated, those
// with beta = 0 too, as the reference does (NaN * 0 is NaN for a bad
// texel).
//
// What bounds it on the H100: for the sky, instruction issue first and
// the MUFU (special-function) unit second.  The march is 16 view samples,
// each with a sphere test toward the sun and 8 light samples; every
// sample is a norm (an IEEE sqrtf), two divisions by the constants HR and
// HM and two accurate expf.  Counted from the SASS
// (tools/sass_count.py), a ray issues about 11,800 instructions (13,400
// with IEEE divisions) against 4,858 operations in the source (0.150 ms
// at 1080p at 67 TFLOP/s), and 500 MUFU operations (336 EX2, 162 RSQ, 2
// RCP; 793 with the divisions' reciprocals): at one instruction a clock
// on each of 4 schedulers of 132 SMs at 1.98 GHz the issue takes 0.73
// ms at 1080p, the MUFU at 16 a clock an SM 0.25 ms.  Its 48 bytes a ray
// take 0.030 ms.  For HDRI, bytes: 48 a ray plus four 12-byte taps that
// mostly hit the L2 (the map is read once: 1.5 MB at 512 x 256).
//
// What the design does about it: one thread a ray, the state in
// registers; a kernel for each environment (a template on the kind), so
// the sky carries no HDRI code.  The sky divides by HR and HM with
// div_known2 (vpt_common.cuh): a product with the host's RN(1/d) and one
// FMA correction, correctly rounded, under one compare for both
// divisors, where IEEE division costs a MUFU reciprocal, its refinement
// and a range check each.  The transcendentals and the norms stay the
// plain version's, which keeps every bit; their slow paths are out of
// line.  128 threads a block instead of 256 measured the same (0.8375
// against 0.836 ms) and was dropped.
//
// The atmosphere kinds: one thread a ray.  Unlike the plain version,
// which evaluates the ground and the sky for every ray and picks one, a
// ray evaluates only its branch: the sky one 2-D and one 4-D lookup of
// the scattering and the single Mie (36 texels), the ground two 2-D
// lookups, a transmittance quotient and two 4-D lookups (80 texels).
// Their float32 constants come from the wrapper (render/integrator.py::
// atmosphere_params), each the value of the plain version's own torch
// expression.
//
// What bounds ATMOSPHERE on the H100, measured (tools/time_env.py,
// tools/sass_count.py): issue and latency, not the loads.  With the
// (..., 3) LUTs a ray issued three 4-byte loads a texel (381 LDG in the
// kernel, 8% of its 4,656 SASS instructions; the float arithmetic that
// keeps every bit, with IEEE divisions and square roots, is 59%); at 64
// registers, 4 blocks of 256 an SM, it took 0.235 ms at 1080p on config
// 4's K1-retired rays, and 0.243 ms on the full LUT dims, whose LUTs are
// eight times larger: the bytes barely matter.  Fewer warps an SM cost
// more than anything else: this kernel at 219 registers, 1 block an SM,
// takes 0.44 ms.
//
// The Bruneton model's device code (AtmParams, the lookups,
// sample_atmosphere and sample_sky_cache) is in atmosphere.cuh, which K5
// includes for its sky next-event estimate under the atmosphere.
//
// What the design does about it: ATMOSPHERE has a kernel of its own
// (environment_atmosphere_kernel), on the LUTs in K4's layout
// (sky/runtime.py::pack_k4_luts, packed once per atmosphere): a texel is
// one 16-byte load, a 4-D tap of the scattering and the single Mie one
// 32-byte sector, 116 LDG.128 in all where there were 381 loads.  Each
// lookup runs in turn, a 4-D slice row by row, each result folded in as
// it arrives, and the registers are capped for 5 blocks of 256 threads
// an SM (48 registers, 72 bytes of local memory): 0.210 ms and 0.212 ms
// where the (..., 3) LUTs took 0.235 and 0.243.  Measured and dropped
// (PERF.md has their times): sorting each block's rays into ground and
// sky warps (86% of the warps of K1's pixel order hold one branch
// already: 1.5% slower), a pass that sorts them across the launch (38%
// slower), every tap of a branch computed before its first load (2.1x
// slower at 219 registers, 13% capped), and the other register caps and
// block sizes.

#include "vpt_common.cuh"

using namespace vpt;

// Mirror of vpt_tpu_torch/render/integrator.py::_EnvParams.
struct EnvParams {
    int n, kind, map_h, map_w;
    float sun[3], color[3];
    float mult, u_scale, pi, earth_r, earth_r2, atm_r2, observer_y, hr, hm,
        hr_inv, hm_inv, c_r, c_m, one_minus_g2, one_plus_g2, two_g,
        two_plus_g2;
    float beta_r[3], beta_m[3], beta_m11[3];
};

#include "atmosphere.cuh"

namespace {

constexpr int ENV_SKY = 0, ENV_HDRI = 1, ENV_ATMOSPHERE = 2,
              ENV_SKY_CACHE = 3;
constexpr int N_SAMPLES = 16, N_SAMPLES_LIGHT = 8;
constexpr int THREADS = 256;
// environment_atmosphere_kernel's resident blocks an SM, which caps its
// registers at 48
constexpr int ATM_MIN_BLOCKS = 5;

// sky/procedural.py::_ray_sphere: the nearer and farther roots of a
// unit-a quadratic (hit = disc >= 0)
__device__ __forceinline__ bool ray_sphere(V3 orig, V3 dir, float r2,
                                           float& lo, float& hi) {
    const float b = 2.0f * dot(dir, orig);
    const float c = dot(orig, orig) - r2;
    const float disc = b * b - 4.0f * c;
    const float sq = sqrtf(jmax(disc, 0.0f));
    const float t0 = (-b - sq) / 2.0f;
    const float t1 = (-b + sq) / 2.0f;
    lo = jmin(t0, t1);
    hi = jmax(t0, t1);
    return disc >= 0.0f;
}

// sky/procedural.py::sample_sky for one direction, times intensity
// (= sky_color); RED for a ray that misses the atmosphere
__device__ V3 sample_sky(const EnvParams& p, V3 d) {
    const V3 sun = v3(p.sun);
    const V3 pos = v3(0.0f, p.observer_y, 0.0f);
    float et0, et1, at0, at1;
    const bool ehit = ray_sphere(pos, d, p.earth_r2, et0, et1);
    float tmax = (ehit && et1 > 0.0f) ? jmax(et0, 0.0f) : 3.4e38f;
    const bool ahit = ray_sphere(pos, d, p.atm_r2, at0, at1);
    const bool miss = !ahit || at1 < 0.0f;
    const float tmin = at0 > 0.0f ? jmax(at0, 0.0f) : 0.0f;
    tmax = jmin(tmax, at1);

    const float seg = (tmax - tmin) / (float)N_SAMPLES;
    const float mu = dot(d, sun);
    const float phase_r = p.c_r * (1.0f + mu * mu);
    const float phase_m =
        (p.c_m * (p.one_minus_g2 * (1.0f + mu * mu))) /
        (p.two_plus_g2 * powf(p.one_plus_g2 - p.two_g * mu, 1.5f));

    float sum_r[3] = {0.0f, 0.0f, 0.0f}, sum_m[3] = {0.0f, 0.0f, 0.0f};
    float od_r = 0.0f, od_m = 0.0f;
    for (int i = 0; i < N_SAMPLES; ++i) {
        const float t_cur = tmin + seg * ((float)i + 0.5f);
        const V3 sp = pos + d * t_cur;
        const float height = norm3(sp) - p.earth_r;
        float er, em;
        div_known2(-height, p.hr, p.hr_inv, p.hm, p.hm_inv, er, em);
        const float hr = expf(er) * seg;
        const float hm = expf(em) * seg;
        od_r = od_r + hr;
        od_m = od_m + hm;
        // light march toward the sun
        float l0, t1l;
        ray_sphere(sp, sun, p.atm_r2, l0, t1l);
        const float segl = t1l / (float)N_SAMPLES_LIGHT;
        float odl_r = 0.0f, odl_m = 0.0f;
        bool below = false;
        for (int j = 0; j < N_SAMPLES_LIGHT; ++j) {
            const float tl = segl * ((float)j + 0.5f);
            const V3 spl = sp + sun * tl;
            const float hl = norm3(spl) - p.earth_r;
            below = below || hl < 0.0f;
            if (!below) {
                div_known2(-hl, p.hr, p.hr_inv, p.hm, p.hm_inv, er, em);
                odl_r = odl_r + expf(er) * segl;
                odl_m = odl_m + expf(em) * segl;
            }
        }
        if (below) continue;   // the plain version adds 0 here
        const float a_r = od_r + odl_r, a_m = od_m + odl_m;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float tau = p.beta_r[c] * a_r + p.beta_m11[c] * a_m;
            const float atten = expf(-tau);
            sum_r[c] = sum_r[c] + atten * hr;
            sum_m[c] = sum_m[c] + atten * hm;
        }
    }
    if (miss) return v3(1.0f, 0.0f, 0.0f);
    V3 out;
    float* o = &out.x;
#pragma unroll
    for (int c = 0; c < 3; ++c)
        o[c] = (sum_r[c] * p.beta_r[c] * phase_r +
                sum_m[c] * p.beta_m[c] * phase_m) * p.color[c];
    return out;
}

// sky/envmap.py::sample_env_map on the raw (H, W, 3) map
__device__ V3 sample_env_map(const EnvParams& p,
                             const float* __restrict__ map, V3 d) {
    const int H = p.map_h, W = p.map_w;
    const float u = atan2f(d.z, d.x) * p.u_scale + 0.5f;
    const float v = acosf(jclamp(d.y, -1.0f, 1.0f)) / p.pi;
    const float x = u * (float)W - 0.5f;
    const float y = v * (float)H - 0.5f;
    const float x0 = floorf(x);
    const float y0 = jclamp(floorf(y), 0.0f, (float)(H - 1));
    const float fx = x - x0, fy = y - y0;
    int x0i = (int)x0 % W;
    if (x0i < 0) x0i += W;
    const int y0i = (int)y0;
    const int x1i = x0i + 1 == W ? 0 : x0i + 1;
    const int y1i = min(y0i + 1, H - 1);
    const float* r0 = map + 3 * y0i * W;
    const float* r1 = map + 3 * y1i * W;
    const V3 v00 = v3(r0 + 3 * x0i), v01 = v3(r0 + 3 * x1i);
    const V3 v10 = v3(r1 + 3 * x0i), v11 = v3(r1 + 3 * x1i);
    const float gx = 1.0f - fx, gy = 1.0f - fy;
    return (v00 * gx + v01 * fx) * gy + (v10 * gx + v11 * fx) * fy;
}

// One thread a ray; KIND picks the environment at compile time, so the
// sky's kernel carries no HDRI code and HDRI's launch is not sized by the
// sky's registers.  `atm` is read by SKY_CACHE only (the live atmosphere
// has a kernel of its own, environment_atmosphere_kernel).
template <int KIND>
__global__ void __launch_bounds__(THREADS)
environment_kernel(const EnvParams p, float* __restrict__ L,
                   const float* __restrict__ beta,
                   const float* __restrict__ dir,
                   const float* __restrict__ map, const AtmParams atm,
                   const float* __restrict__ pos) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= p.n) return;
    const V3 d = v3(dir + 3 * i);
    const V3 li = KIND == ENV_HDRI ? sample_env_map(p, map, d)
                  : KIND == ENV_SKY_CACHE ? sample_sky_cache(atm, d)
                                          : sample_sky(p, d);
    const V3 env = (li * v3(p.color)) * p.mult;
    const V3 l = v3(L + 3 * i) + env * v3(beta + 3 * i);
    L[3 * i + 0] = l.x;
    L[3 * i + 1] = l.y;
    L[3 * i + 2] = l.z;
}

// The ATMOSPHERE kind: L[i] += (sample_atmosphere(pos[i], dir[i]) * color)
// * mult * beta[i], one thread a ray, the rays in K1's order; the
// registers capped for ATM_MIN_BLOCKS blocks an SM.
__global__ void __launch_bounds__(THREADS, ATM_MIN_BLOCKS)
environment_atmosphere_kernel(const EnvParams p, float* __restrict__ L,
                              const float* __restrict__ beta,
                              const float* __restrict__ dir,
                              const AtmParams a,
                              const float* __restrict__ pos) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= p.n) return;
    const V3 li = sample_atmosphere(a, v3(pos + 3 * i), v3(dir + 3 * i));
    const V3 env = (li * v3(p.color)) * p.mult;
    const V3 l = v3(L + 3 * i) + env * v3(beta + 3 * i);
    L[3 * i + 0] = l.x;
    L[3 * i + 1] = l.y;
    L[3 * i + 2] = l.z;
}

// div_known2 with d and y twice against __fdiv_rn(x, d) for every 32-bit
// pattern x in [lo, hi): out[0] += the patterns where one of the two
// results differs from it in a bit and the two are not both NaN, out[1]
// = min(out[1], the first such pattern).
__global__ void __launch_bounds__(256)
div_known_sweep_kernel(float d, float y, unsigned long long lo,
                       unsigned long long hi,
                       unsigned long long* __restrict__ out) {
    unsigned long long bad = 0ull, first = ~0ull;
    const unsigned long long stride =
        (unsigned long long)gridDim.x * blockDim.x;
    for (unsigned long long b = lo + (unsigned long long)blockIdx.x *
                                         blockDim.x + threadIdx.x;
         b < hi; b += stride) {
        const float x = __uint_as_float((uint32_t)b);
        const float want = __fdiv_rn(x, d);
        float got[2];
        div_known2(x, d, y, d, y, got[0], got[1]);
        bool differs = false;
        for (int k = 0; k < 2; ++k)
            differs |= __float_as_uint(got[k]) != __float_as_uint(want) &&
                        !(got[k] != got[k] && want != want);
        if (differs) {
            ++bad;
            first = first < b ? first : b;
        }
    }
    for (int o = 16; o > 0; o >>= 1) {
        bad += __shfl_down_sync(0xffffffffu, bad, o);
        const unsigned long long f = __shfl_down_sync(0xffffffffu, first, o);
        first = first < f ? first : f;
    }
    if ((threadIdx.x & 31) == 0 && bad > 0) {
        atomicAdd(out, bad);
        atomicMin(out + 1, first);
    }
}

}  // namespace

extern "C" int vpt_env_params_size() { return (int)sizeof(EnvParams); }
extern "C" int vpt_atm_params_size() { return (int)sizeof(AtmParams); }

// K4 on n rays: L (n, 3) updated in place from beta and dir (n, 3); map
// the raw (map_h, map_w, 3) float32 map for HDRI, else unused; atm the
// AtmParams of the atmosphere kinds (null otherwise) and pos (n, 3) the
// rays' positions for ATMOSPHERE (else unused).
extern "C" int vpt_environment(const void* params, float* L,
                               const float* beta, const float* dir,
                               const float* map, void* stream,
                               const void* atm, const float* pos) {
    const EnvParams& p = *static_cast<const EnvParams*>(params);
    if (p.n <= 0) return 0;
    const bool atm_kind = p.kind == ENV_ATMOSPHERE || p.kind == ENV_SKY_CACHE;
    if (p.kind < ENV_SKY || p.kind > ENV_SKY_CACHE ||
        (p.kind == ENV_HDRI && (map == nullptr || p.map_h <= 0 ||
                                p.map_w <= 0)) ||
        (atm_kind && atm == nullptr) ||
        (p.kind == ENV_ATMOSPHERE && pos == nullptr))
        return (int)cudaErrorInvalidValue;
    AtmParams a{};
    if (atm_kind) {
        a = *static_cast<const AtmParams*>(atm);
        if ((p.kind == ENV_ATMOSPHERE &&
             (a.trans == nullptr || a.irr == nullptr ||
              a.scat_mie == nullptr ||
              reinterpret_cast<uintptr_t>(a.trans) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(a.irr) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(a.scat_mie) % 32 != 0))
            || (p.kind == ENV_SKY_CACHE &&
                (a.cache == nullptr || a.cache_h <= 0 || a.cache_w <= 0)))
            return (int)cudaErrorInvalidValue;
    }
    const int blocks = (p.n + THREADS - 1) / THREADS;
    const cudaStream_t st = (cudaStream_t)stream;
    switch (p.kind) {
    case ENV_SKY:
        environment_kernel<ENV_SKY><<<blocks, THREADS, 0, st>>>(
            p, L, beta, dir, map, a, pos);
        break;
    case ENV_HDRI:
        environment_kernel<ENV_HDRI><<<blocks, THREADS, 0, st>>>(
            p, L, beta, dir, map, a, pos);
        break;
    case ENV_ATMOSPHERE:
        environment_atmosphere_kernel<<<blocks, THREADS, 0, st>>>(
            p, L, beta, dir, a, pos);
        break;
    default:
        environment_kernel<ENV_SKY_CACHE><<<blocks, THREADS, 0, st>>>(
            p, L, beta, dir, map, a, pos);
    }
    return (int)cudaGetLastError();
}

// The ATMOSPHERE kind's schedule on the current card: SMs, resident
// blocks per SM, threads per block, registers per thread, local (spill
// and stack) bytes per thread.
extern "C" int vpt_atmosphere_launch_info(int* info) {
    cudaFuncAttributes f{};
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaFuncGetAttributes(&f, environment_atmosphere_kernel);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, environment_atmosphere_kernel, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    info[0] = sms;
    info[1] = per_sm;
    info[2] = THREADS;
    info[3] = f.numRegs;
    info[4] = (int)f.localSizeBytes;
    return 0;
}

// The check of div_known2 (a test entry point, not on the render path):
// out[0] gets the count of mismatching patterns in [lo, hi) (hi <=
// 2^32), out[1] the first of them; the caller sets out to {0, ~0}.
extern "C" int vpt_div_known_sweep(float d, float y, unsigned long long lo,
                                   unsigned long long hi,
                                   unsigned long long* out, void* stream) {
    if (hi > (1ull << 32) || lo > hi) return (int)cudaErrorInvalidValue;
    if (lo == hi) return 0;
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const unsigned long long need = (hi - lo + 255) / 256;
    const unsigned long long most = (unsigned long long)sms * 16;
    const int blocks = (int)(need < most ? need : most);
    div_known_sweep_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
        d, y, lo, hi, out);
    return (int)cudaGetLastError();
}
