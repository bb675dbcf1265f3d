// The Bruneton atmosphere's device code, shared by K4 (csrc/environment.cu:
// its ATMOSPHERE and SKY_CACHE kinds) and K5 (csrc/walk.cuh: the
// volumetric integrator's sky next-event estimate under the atmosphere):
// vpt_tpu_torch/sky/bruneton.py and runtime.py, operation for operation
// (environment.cu's header says how and why).

#pragma once

#include "vpt_common.cuh"

using namespace vpt;

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
// AtmParams::uv0 / uv1 slots: one per texture axis
constexpr int UV_TW = 0, UV_TH = 1, UV_R = 2, UV_MU = 3, UV_MUS = 4,
              UV_IW = 5, UV_IH = 6;

__device__ __forceinline__ float norm3(V3 a) { return sqrtf(dot(a, a)); }

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

}  // namespace
