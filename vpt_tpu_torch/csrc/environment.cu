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

// Mirror of vpt_tpu_torch/render/integrator.py::_AtmParams: the
// ATMOSPHERE kind's LUTs in K4's layout (sky/runtime.py::K4Luts:
// transmittance (th, tw, 4) and irradiance (ih, iw, 4), rgb and a zero,
// 16-byte aligned; scattering and single Mie interleaved, (r, mu, nu *
// mu_s, 8), 32-byte aligned), the baked cache (cache_h, cache_w, 6) of
// SKY_CACHE, and the model's float32 constants.
struct AtmParams {
    const float *trans, *irr, *scat_mie, *cache;
    int tw, th, r, mu, mu_s, nu, iw, ih, cache_h, cache_w;
    float bottom, top, bottom2, top2, H, HH, d_s_min, H_m_dsmin, A, t_m_b,
        sar_c, cos_sar, ray_c, mie_k, one_plus_g2, two_g, exposure, nu_m1,
        nu_f;
    float uv0[7], uv1[7];  // _uv_from_unit's 0.5 / size and 1 - 1 / size
    float center[3], sun[3], solar_irr[3], solar_rad[3], albedo_pi[3],
        sky_k[3], sun_k[3], wp[3];
};

namespace {

constexpr float PI_F = 3.14159265358979323846f;
constexpr int ENV_SKY = 0, ENV_HDRI = 1, ENV_ATMOSPHERE = 2,
              ENV_SKY_CACHE = 3;
// AtmParams::uv0 / uv1 slots: one per texture axis
constexpr int UV_TW = 0, UV_TH = 1, UV_R = 2, UV_MU = 3, UV_MUS = 4,
              UV_IW = 5, UV_IH = 6;
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

__device__ __forceinline__ float norm3(V3 a) { return sqrtf(dot(a, a)); }

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

// ------------------------------------------------ the Bruneton model --
// vpt_tpu_torch/sky/bruneton.py and runtime.py, operation for operation,
// on the LUTs in K4's layout (sky/runtime.py::pack_k4_luts): a texel of
// the transmittance and the irradiance is one float4 (rgb, 0), a texel of
// the 4-D LUT two (scattering rgb, 0, single Mie rgb, 0), one 32-byte
// sector.  Each lookup is split into its taps (coordinates and weights,
// from the ray alone), their loads and the blend, and runs in turn, a
// 4-D slice row by row.

__device__ __forceinline__ V3 rgb(float4 c) { return v3(c.x, c.y, c.z); }

__device__ __forceinline__ float uv_from_unit(const AtmParams& a, float x,
                                              int slot) {
    return a.uv0[slot] + x * a.uv1[slot];
}

__device__ __forceinline__ float safe_sqrt(float x) {
    return sqrtf(jmax(x, 0.0f));
}

// bruneton.dist_to_top
__device__ __forceinline__ float dist_to_top(const AtmParams& a, float r,
                                             float mu) {
    const float disc = r * r * (mu * mu - 1.0f) + a.top2;
    return jmax(-r * mu + safe_sqrt(disc), 0.0f);
}

__device__ __forceinline__ bool ray_hits_ground(const AtmParams& a, float r,
                                                float mu) {
    return (mu < 0.0f) && (r * r * (mu * mu - 1.0f) + a.bottom2 >= 0.0f);
}

__device__ __forceinline__ float clamp_radius(const AtmParams& a, float r) {
    return jmin(jmax(r, a.bottom), a.top);
}

// bruneton.tex2d's four taps on an (H, W) texture and their weights
struct Taps2 {
    int i00, i01, i10, i11;
    float fx, gx, fy, gy;
};

__device__ __forceinline__ Taps2 taps2(int H, int W, float u, float v) {
    const float x = jclamp(u * (float)W - 0.5f, 0.0f, (float)W - 1.0f);
    const float y = jclamp(v * (float)H - 0.5f, 0.0f, (float)H - 1.0f);
    const float x0f = floorf(x), y0f = floorf(y);
    const int x0 = (int)x0f, y0 = (int)y0f;
    const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
    Taps2 t;
    t.i00 = y0 * W + x0;
    t.i01 = y0 * W + x1;
    t.i10 = y1 * W + x0;
    t.i11 = y1 * W + x1;
    t.fx = x - x0f;
    t.fy = y - y0f;
    t.gx = 1.0f - t.fx;
    t.gy = 1.0f - t.fy;
    return t;
}

__device__ __forceinline__ V3 lookup2(const float4* __restrict__ tex,
                                      const Taps2& t) {
    const float4 c00 = __ldg(tex + t.i00), c01 = __ldg(tex + t.i01);
    const float4 c10 = __ldg(tex + t.i10), c11 = __ldg(tex + t.i11);
    return (rgb(c00) * t.gx + rgb(c01) * t.fx) * t.gy +
           (rgb(c10) * t.gx + rgb(c11) * t.fx) * t.fy;
}

// bruneton.tex3d's eight taps on a (D, H, W) texture: four rows (z, y),
// two columns
struct Taps3 {
    int r00, r01, r10, r11, x0, x1;
    float fx, gx, fy, gy, fz, gz;
};

__device__ __forceinline__ Taps3 taps3(int D, int H, int W, float u,
                                       float v, float w) {
    const float x = jclamp(u * (float)W - 0.5f, 0.0f, (float)W - 1.0f);
    const float y = jclamp(v * (float)H - 0.5f, 0.0f, (float)H - 1.0f);
    const float z = jclamp(w * (float)D - 0.5f, 0.0f, (float)D - 1.0f);
    const float x0f = floorf(x), y0f = floorf(y), z0f = floorf(z);
    const int x0 = (int)x0f, y0 = (int)y0f, z0 = (int)z0f;
    const int y1 = min(y0 + 1, H - 1), z1 = min(z0 + 1, D - 1);
    Taps3 t;
    t.x0 = x0;
    t.x1 = min(x0 + 1, W - 1);
    t.r00 = (z0 * H + y0) * W;
    t.r01 = (z0 * H + y1) * W;
    t.r10 = (z1 * H + y0) * W;
    t.r11 = (z1 * H + y1) * W;
    t.fx = x - x0f;
    t.fy = y - y0f;
    t.fz = z - z0f;
    t.gx = 1.0f - t.fx;
    t.gy = 1.0f - t.fy;
    t.gz = 1.0f - t.fz;
    return t;
}

// bruneton.transmittance_to_top's taps
__device__ __forceinline__ Taps2 trans_taps(const AtmParams& a, float r,
                                            float mu) {
    const float rho = safe_sqrt(r * r - a.bottom2);
    const float d = dist_to_top(a, r, mu);
    const float d_min = a.top - r;
    const float d_max = rho + a.H;
    const float x_mu = d_max == d_min ? 0.0f : (d - d_min) / (d_max - d_min);
    const float x_r = rho / a.H;
    return taps2(a.th, a.tw, uv_from_unit(a, x_mu, UV_TW),
                 uv_from_unit(a, x_r, UV_TH));
}

// bruneton._combined_scattering's taps: sample_scattering's two
// trilinear lookups (the nu slices) at the same (mu, r), and their lerp
struct Taps4 {
    Taps3 s0, s1;
    float lerp;
};

__device__ Taps4 scattering_taps(const AtmParams& a, float r, float mu,
                                 float mu_s, float nu, bool hits_ground) {
    // _scattering_uvwz_from_rmumusnu
    const float rho = safe_sqrt(jmax(r * r - a.bottom2, 0.0f));
    const float u_r = uv_from_unit(a, rho / a.H, UV_R);
    const float r_mu = r * mu;
    const float disc = r_mu * r_mu - r * r + a.bottom2;
    float u_mu;
    if (hits_ground) {
        const float d_g = -r_mu - safe_sqrt(disc);
        const float d_g_min = r - a.bottom;
        const float d_g_max = rho;
        const float x = d_g_max == d_g_min
                            ? 0.0f
                            : (d_g - d_g_min) / jmax(d_g_max - d_g_min,
                                                     1e-20f);
        u_mu = 0.5f - 0.5f * uv_from_unit(a, x, UV_MU);
    } else {
        const float d_t = -r_mu + safe_sqrt(disc + a.HH);
        const float d_t_min = a.top - r;
        const float d_t_max = rho + a.H;
        u_mu = 0.5f + 0.5f * uv_from_unit(
                                 a, (d_t - d_t_min) / jmax(d_t_max - d_t_min,
                                                           1e-20f),
                                 UV_MU);
    }
    const float d_s = dist_to_top(a, a.bottom, mu_s);
    const float aa = (d_s - a.d_s_min) / a.H_m_dsmin;
    const float u_mu_s =
        uv_from_unit(a, jmax(1.0f - aa / a.A, 0.0f) / (1.0f + aa), UV_MUS);
    const float u_nu = (nu + 1.0f) / 2.0f;
    const float tex_x = u_nu * a.nu_m1;
    const float tex_x0 = floorf(tex_x);
    const float u0 = (tex_x0 + u_mu_s) / a.nu_f;
    const float u1 = (tex_x0 + 1.0f + u_mu_s) / a.nu_f;
    const int W = a.nu * a.mu_s;
    Taps4 t;
    t.s0 = taps3(a.r, a.mu, W, u0, u_mu, u_r);
    t.s1 = taps3(a.r, a.mu, W, u1, u_mu, u_r);
    t.lerp = tex_x - tex_x0;
    return t;
}

// bruneton.tex3d of the scattering (s) and the single Mie (m) row by
// row: each row's four texels loaded, then lerped over x
__device__ __forceinline__ void slice_lookup(const float4* __restrict__ sm,
                                             const Taps3& t, V3& s, V3& m) {
    const int rows[4] = {t.r00, t.r01, t.r10, t.r11};
    V3 rs[2], rm[2], zs[2], zm[2];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const float4* p0 = sm + 2 * (rows[k] + t.x0);
        const float4* p1 = sm + 2 * (rows[k] + t.x1);
        const float4 s0 = __ldg(p0), m0 = __ldg(p0 + 1);
        const float4 s1 = __ldg(p1), m1 = __ldg(p1 + 1);
        rs[k & 1] = rgb(s0) * t.gx + rgb(s1) * t.fx;
        rm[k & 1] = rgb(m0) * t.gx + rgb(m1) * t.fx;
        if (k & 1) {   // the rows (z, y0), (z, y1) lerped over y
            zs[k >> 1] = rs[0] * t.gy + rs[1] * t.fy;
            zm[k >> 1] = rm[0] * t.gy + rm[1] * t.fy;
        }
    }
    s = zs[0] * t.gz + zs[1] * t.fz;
    m = zm[0] * t.gz + zm[1] * t.fz;
}

// sample_scattering of the scattering and the single Mie, a slice at a
// time
__device__ __forceinline__ void scattering_lookup(
    const float4* __restrict__ sm, const Taps4& t, V3& scat, V3& mie) {
    const float g = 1.0f - t.lerp;
    V3 s0, m0, s1, m1;
    slice_lookup(sm, t.s0, s0, m0);
    slice_lookup(sm, t.s1, s1, m1);
    scat = s0 * g + s1 * t.lerp;
    mie = m0 * g + m1 * t.lerp;
}

__device__ __forceinline__ float rayleigh_phase(const AtmParams& a,
                                                float nu) {
    return a.ray_c * (1.0f + nu * nu);
}

__device__ __forceinline__ float mie_phase(const AtmParams& a, float nu) {
    return a.mie_k * (1.0f + nu * nu) /
           powf(jmax(a.one_plus_g2 - a.two_g * nu, 1e-12f), 1.5f);
}

// bruneton._enter_atmosphere
__device__ __forceinline__ void enter_atmosphere(const AtmParams& a,
                                                 V3& camera, V3 view,
                                                 float& r, float& rmu,
                                                 float& d_top,
                                                 bool& in_space) {
    r = norm3(camera);
    rmu = dot(camera, view);
    d_top = -rmu - safe_sqrt(rmu * rmu - r * r + a.top2);
    in_space = (r > a.top) && (d_top > 0.0f);
    if (in_space) {
        camera = camera + view * d_top;
        r = a.top;
        rmu = rmu + d_top;
    }
}

// bruneton.get_sky_radiance (times sky_k): radiance and trans
__device__ void sky_radiance(const AtmParams& a, V3 camera, V3 view,
                             V3 sun, V3& radiance, V3& trans) {
    float r, rmu, d_top;
    bool in_space;
    enter_atmosphere(a, camera, view, r, rmu, d_top, in_space);
    const bool outside = r > a.top;
    const float mu = rmu / jmax(r, 1e-6f);
    const float mu_s = dot(camera, sun) / jmax(r, 1e-6f);
    const float nu = dot(view, sun);
    const bool hits_ground = ray_hits_ground(a, r, mu);
    const V3 zero = v3(0.0f, 0.0f, 0.0f);
    if (outside) {
        trans = hits_ground ? zero : v3(1.0f, 1.0f, 1.0f);
        radiance = zero * v3(a.sky_k);
        return;
    }
    const float4* trans_lut = reinterpret_cast<const float4*>(a.trans);
    const float4* sm = reinterpret_cast<const float4*>(a.scat_mie);
    const V3 to_top = lookup2(trans_lut, trans_taps(a, r, mu));
    V3 scat, mie;
    scattering_lookup(sm, scattering_taps(a, r, mu, mu_s, nu, hits_ground),
                      scat, mie);
    trans = hits_ground ? zero : to_top;
    radiance = (scat * rayleigh_phase(a, nu) + mie * mie_phase(a, nu)) *
               v3(a.sky_k);
}

// get_sky_radiance_to_point's ray from the camera to the ground point gp,
// entered into the atmosphere: (r, mu, mu_s, nu) at the camera, d, the
// ground branch of the 4-D lookups (hg), and at gp (r_p, which is
// transmittance_between's r_d, mu_d, mu_p, mu_s_p)
struct ToPoint {
    float r, mu, mu_s, nu, d, r_p, mu_d, mu_p, mu_s_p;
    bool hg;
};

__device__ __forceinline__ ToPoint to_point(const AtmParams& a, V3 camera,
                                            V3 gp, V3 sun) {
    ToPoint q;
    V3 view = gp - camera;
    q.d = norm3(view);
    view = view / jmax(q.d, 1e-9f);
    float rmu, d_top;
    bool in_space;
    enter_atmosphere(a, camera, view, q.r, rmu, d_top, in_space);
    if (in_space) q.d = q.d - d_top;
    const float r = q.r, d = q.d;
    q.mu = rmu / jmax(r, 1e-6f);
    q.mu_s = dot(camera, sun) / jmax(r, 1e-6f);
    q.nu = dot(view, sun);
    q.hg = ray_hits_ground(a, r, q.mu);
    q.r_p = clamp_radius(a, safe_sqrt(d * d + 2.0f * r * q.mu * d + r * r));
    q.mu_d = jclamp((r * q.mu + d) / q.r_p, -1.0f, 1.0f);
    q.mu_p = (r * q.mu + d) / q.r_p;
    q.mu_s_p = (r * q.mu_s + d * q.nu) / q.r_p;
    return q;
}

// transmittance_between's two taps on hg's branch
__device__ __forceinline__ Taps2 num_taps(const AtmParams& a,
                                          const ToPoint& q) {
    return trans_taps(a, q.hg ? q.r_p : q.r, q.hg ? -q.mu_d : q.mu);
}

__device__ __forceinline__ Taps2 den_taps(const AtmParams& a,
                                          const ToPoint& q) {
    return trans_taps(a, q.hg ? q.r : q.r_p, q.hg ? -q.mu : q.mu_d);
}

// get_sun_and_sky_irradiance at gp (the irradiance lookup irr, the sun's
// transmittance to_sun) and the ground's radiance there
__device__ __forceinline__ V3 ground_at(const AtmParams& a, V3 gp,
                                        V3 normal, float rg, float mu_sg,
                                        V3 irr, V3 to_sun, V3 sun) {
    const V3 sky_irr = irr * (1.0f + dot(gp, normal) / jmax(rg, 1e-6f)) *
                       0.5f;
    // transmittance_to_sun
    const float sin_h = a.bottom / rg;
    const float cos_h = -safe_sqrt(jmax(1.0f - sin_h * sin_h, 0.0f));
    float vis = jclamp((mu_sg - cos_h) / a.sar_c * 0.5f + 0.5f, 0.0f, 1.0f);
    vis = vis * vis * (3.0f - 2.0f * vis);
    const V3 sun_irr = v3(a.solar_irr) * (to_sun * vis) *
                       jmax(dot(normal, sun), 0.0f);
    return v3(a.albedo_pi) * (sun_irr * v3(a.sun_k) + sky_irr * v3(a.sky_k));
}

// transmittance_between's quotient
__device__ __forceinline__ V3 quotient(V3 num, V3 den) {
    return v3(jmin(num.x / jmax(den.x, 1e-20f), 1.0f),
              jmin(num.y / jmax(den.y, 1e-20f), 1.0f),
              jmin(num.z / jmax(den.z, 1e-20f), 1.0f));
}

// the ground seen through the aerial perspective
__device__ __forceinline__ V3 aerial(const AtmParams& a, V3 ground,
                                     V3 trans, V3 scat, V3 mie, V3 scat_p,
                                     V3 mie_p, float nu) {
    scat = scat - trans * scat_p;
    mie = mie - trans * mie_p;
    const V3 in_scatter =
        v3(jmax(scat.x, 0.0f), jmax(scat.y, 0.0f), jmax(scat.z, 0.0f)) *
            rayleigh_phase(a, nu) +
        v3(jmax(mie.x, 0.0f), jmax(mie.y, 0.0f), jmax(mie.z, 0.0f)) *
            mie_phase(a, nu);
    return ground * trans + in_scatter * v3(a.sky_k);
}

// the ground branch of runtime._sample_atmosphere_pre: the ground's
// radiance at its hit point gp, seen through the aerial perspective.  The
// lookups run in the plain version's order, each result folded in as
// soon as it is loaded.
__device__ V3 ground_radiance(const AtmParams& a, V3 camera, V3 gp,
                              V3 sun) {
    const float4* trans_lut = reinterpret_cast<const float4*>(a.trans);
    const float4* irr_lut = reinterpret_cast<const float4*>(a.irr);
    const float4* sm = reinterpret_cast<const float4*>(a.scat_mie);
    const V3 normal = normalize(gp);
    const float rg = norm3(gp);
    const float mu_sg = dot(gp, sun) / jmax(rg, 1e-6f);
    const float x_r = (rg - a.bottom) / a.t_m_b;
    const float x_mu_s = mu_sg * 0.5f + 0.5f;
    const Taps2 t_irr = taps2(a.ih, a.iw, uv_from_unit(a, x_mu_s, UV_IW),
                              uv_from_unit(a, x_r, UV_IH));
    const Taps2 t_sun = trans_taps(a, rg, mu_sg);
    const V3 ground = ground_at(a, gp, normal, rg, mu_sg,
                                lookup2(irr_lut, t_irr),
                                lookup2(trans_lut, t_sun), sun);
    const ToPoint q = to_point(a, camera, gp, sun);
    const V3 trans = quotient(lookup2(trans_lut, num_taps(a, q)),
                              lookup2(trans_lut, den_taps(a, q)));
    V3 scat, mie, scat_p, mie_p;
    scattering_lookup(sm, scattering_taps(a, q.r, q.mu, q.mu_s, q.nu, q.hg),
                      scat, mie);
    scattering_lookup(
        sm, scattering_taps(a, q.r_p, q.mu_p, q.mu_s_p, q.nu, q.hg), scat_p,
        mie_p);
    return aerial(a, ground, trans, scat, mie, scat_p, mie_p, q.nu);
}

// runtime._compose_sun_disc: the sun disc and the exposure curve
__device__ V3 compose_sun_disc(const AtmParams& a, V3 pre, V3 trans,
                               V3 view) {
    const V3 sun = v3(a.sun);
    const bool disc = dot(view, sun) > a.cos_sar;
    const V3 sd = (trans * v3(a.solar_rad)) * v3(a.sun_k);
    const V3 out = pre + (disc ? sd : v3(0.0f, 0.0f, 0.0f));
    V3 res;
    const float* o = &out.x;
    float* q = &res.x;
#pragma unroll
    for (int c = 0; c < 3; ++c)
        q[c] = powf(jmax(1.0f - expf(-o[c] / a.wp[c] * a.exposure), 0.0f),
                    (float)(1.0 / 2.2));
    return res;
}

// runtime.sample_atmosphere's ground hit (render_kernel.cu:847-860)
struct RayHead {
    V3 camera, view;
    float dist;
    bool ground;
};

__device__ __forceinline__ RayHead ray_head(const AtmParams& a, V3 pos,
                                            V3 dir) {
    RayHead h;
    h.camera = pos - v3(a.center);
    h.view = normalize(dir);
    const float p_dot_v = dot(h.camera, h.view);
    const float p_dot_p = dot(h.camera, h.camera);
    const float disc = a.bottom2 - (p_dot_p - p_dot_v * p_dot_v);
    h.dist = -p_dot_v - sqrtf(jmax(disc, 0.0f));
    h.ground = (h.dist > 0.0f) && (disc >= 0.0f);
    return h;
}

// runtime.sample_atmosphere: the branch the ray takes only
__device__ V3 sample_atmosphere(const AtmParams& a, V3 pos, V3 dir) {
    const V3 sun = v3(a.sun);
    const RayHead h = ray_head(a, pos, dir);
    V3 pre, trans;
    if (h.ground) {
        pre = ground_radiance(a, h.camera, h.camera + h.view * h.dist, sun);
        trans = v3(0.0f, 0.0f, 0.0f);
    } else {
        sky_radiance(a, h.camera, h.view, sun, pre, trans);
    }
    return compose_sun_disc(a, pre, trans, h.view);
}

// runtime.sample_sky_cache: four taps of the (H, W, 6) cache
__device__ V3 sample_sky_cache(const AtmParams& a, V3 dir) {
    const V3 view = normalize(dir);
    const int h = a.cache_h, w = a.cache_w;
    const float theta = acosf(jclamp(view.y, -1.0f, 1.0f));
    float phi = fmodf(atan2f(view.z, view.x), TWO_PI_F);
    if (phi != 0.0f && phi < 0.0f) phi = phi + TWO_PI_F;
    const float y = jclamp(theta / PI_F * (float)h - 0.5f, 0.0f,
                           (float)h - 1.0f);
    const float x = phi / TWO_PI_F * (float)w - 0.5f;
    const float y0f = floorf(y), x0f = floorf(x);
    const int y0 = (int)y0f;
    int x0 = (int)x0f % w;
    if (x0 < 0) x0 += w;
    const int x1 = x0 + 1 == w ? 0 : x0 + 1;
    const int y1 = min(y0 + 1, h - 1);
    const float fx = x - x0f, fy = y - y0f;
    const float gx = 1.0f - fx, gy = 1.0f - fy;
    const float* r0 = a.cache + 6 * (y0 * w);
    const float* r1 = a.cache + 6 * (y1 * w);
    float v[6];
#pragma unroll
    for (int c = 0; c < 6; ++c)
        v[c] = (__ldg(r0 + 6 * x0 + c) * gx + __ldg(r0 + 6 * x1 + c) * fx) *
                   gy +
               (__ldg(r1 + 6 * x0 + c) * gx + __ldg(r1 + 6 * x1 + c) * fx) *
                   fy;
    return compose_sun_disc(a, v3(v[0], v[1], v[2]), v3(v[3], v[4], v[5]),
                            view);
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
