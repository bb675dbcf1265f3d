// K5 — the reference engine's walks on the card: the direct integrator
// (walk_direct) and the volumetric integrator (walk_volumetric), one
// thread a ray, the whole walk in registers.
//
// Replaces: vpt_tpu/render/integrator.py::direct_integrator (:102) and
// vpt_tpu/render/vol_integrator.py::vol_integrator (:46), with the walks
// of vpt_tpu/render/tracking.py (delta_track :575, transmittance :640,
// estimate_emission :696), the next-event estimates of
// vpt_tpu/render/nee.py (estimate_sun :50, estimate_point_lights :65,
// estimate_sky :124 with its two strategies) and the environment CDF's
// samplers of vpt_tpu/sky/cdf.py (sample_env_cdf :114, pdf_env_cdf :151)
// inlined.  Its plain PyTorch versions are
// vpt_tpu_torch/render/integrator.py::direct_integrator_plain and
// vpt_tpu_torch/render/vol_integrator.py::vol_integrator_plain, whose
// arithmetic a thread repeats for its ray, operation for operation, in
// the same order, built with -fmad=false and without fast math.
//
// The draws: the reference traces its rays in tiles of `tile` rays, tile
// t under fold_in(key, 1000 + t), and every draw of a walk is element
// (r % tile) * width + c of a uniform over the tile, so a thread computes
// each of its ray's draws from its counter (vpt_common.cuh's threefry).
// tile 0: the launch is one tile under `key` itself.  The loops of the
// plain version stop when every lane is done, which changes no live
// ray's draws, so a ray here stops when it is done.
//
// The terminal environment: BLACK and CONSTANT are added here; for the
// simple sky, HDRI with a map and the Bruneton atmosphere each ray's beta
// and direction (and for the live atmosphere its env_pos) go beside its
// outputs to K4 (csrc/environment.cu), launched after this kernel, as
// after K1.  The volumetric integrator's sky next-event estimate reads
// the environment toward any direction here: BLACK, CONSTANT, HDRI (the
// map's bilinear taps; uniform sphere, or the CDF's two binary searches
// with hdri_importance) and the simple sky (its 16 x 8 march; with or
// without the sky CDF), the sky and the map copied from environment.cu's
// device code, which is left as it is.
//
// Scope: single-grid scenes in float32 corner rows without the octant
// columns; EXT (a template argument) for an emission or a color channel
// or volume_depth > 1.  The wrapper (render/walk.py) refuses the rest
// before any launch.
//
// What bounds it: as K1, each walk step is one dependent load of a corner
// row at a data-dependent address; the threefry draws (a step key and one
// or two draws a step) are issued in the thread; the rays of a warp take
// different numbers of steps and bounces.  A simple kernel that is right:
// no persistent warps, no sorting by phase.  Measured on the H100
// (PERF.md): walk_direct 20x its bound at 1080p, walk_volumetric 251x,
// where with albedo 1 a ray scatters up to ray_depth times and one thread
// a ray holds its warp for the warp's longest ray (warp efficiency 0.30).

#include "vpt_common.cuh"

using namespace vpt;

namespace {

constexpr int THREADS = 128;
constexpr uint32_t TILE_FOLD = 1000u;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_SQ_F = 19.739208802178716f;   // 2 pi^2
constexpr float INV_4_PI_F = 0.0795774715459476678f;  // isotropic()
constexpr int N_SAMPLES = 16, N_SAMPLES_LIGHT = 8;
// the sky next-event estimate's environment (WalkParams::nee_env)
constexpr int NEE_BLACK = 0, NEE_CONSTANT = 1, NEE_HDRI = 2, NEE_SKY = 3;

}  // namespace

// Mirror of vpt_tpu_torch/render/walk.py::_WalkParams (all 4-byte fields,
// same order).
struct WalkParams {
    int B, tile, ray_depth, volume_depth, max_steps, n_lights, n_pt_walks,
        reference_falloff, use_double_hg, defer_env, env_constant, nee_env,
        use_cdf, cdf_h, cdf_w, row_w, em_off, col_off, grid_off,
        sph_enabled;
    int dim[3];
    unsigned key[2];
    float max_ext, inv_rate, sigma_c, sigma_r, rate_inv_tr, rate_inv_emit,
        emission_pivot, emission_scale, energy_inject, g1, g2, phase_f,
        sph_radius, sph_rough, sun_mult, sky_mult, marginal_int;
    float albedo[3], ext[3], sun_dir[3], sun_color[3], sky_color[3], sky[3],
        root_min[3], root_max[3], gbmin[3], gdim[3], sph_center[3],
        sph_color[3];
    float inv_xf[12];
};

// Mirror of vpt_tpu_torch/render/integrator.py::_EnvParams (the sky's
// constants and the map's size; environment.cu has the same struct).
struct WalkEnv {
    int n, kind, map_h, map_w;
    float sun[3], color[3];
    float mult, u_scale, pi, earth_r, earth_r2, atm_r2, observer_y, hr, hm,
        hr_inv, hm_inv, c_r, c_m, one_minus_g2, one_plus_g2, two_g,
        two_plus_g2;
    float beta_r[3], beta_m[3], beta_m11[3];
};

// The tables a launch reads.  Mirror of render/walk.py::_WalkTables.
struct WalkTables {
    const float *corners;   // (V, row_w) float32 corner rows
    const float *lights;    // (L, 7): pos, color, power
    const float *lut;       // (512, 3): the density color LUT, then emission
    const float *map;       // (map_h, map_w, 3) HDRI map, or null
    const float *cdf_func;  // (cdf_h, cdf_w) |value|
    const float *cdf;       // (cdf_h, cdf_w) row-wise conditional CDF
    const float *m_func;    // (cdf_h,)
    const float *m_cdf;     // (cdf_h,)
};

namespace {

struct Ctx {
    const WalkParams& p;
    const WalkEnv& e;
    const WalkTables& t;
    Key kt;                  // the ray's tile key
    unsigned long long idx;  // the ray's index in its tile
    // the ray's walk steps (every walk) and sky evaluations, summed into
    // the launch's stats where it asks for them
    mutable unsigned n_steps, n_sky;
};

// ---------------------------------------------------------- geometry --

__device__ __forceinline__ void aabb_intersect(const float* bmin,
                                               const float* bmax, V3 o, V3 d,
                                               bool& hit, float& tmin_adj,
                                               float& tmax) {
    const V3 inv = v3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
    const V3 t1 = (v3(bmin) - o) * inv;
    const V3 t2 = (v3(bmax) - o) * inv;
    const float tmin = jmax(jmax(jmin(t1.x, t2.x), jmin(t1.y, t2.y)),
                            jmin(t1.z, t2.z));
    tmax = jmin(jmin(jmax(t1.x, t2.x), jmax(t1.y, t2.y)), jmax(t1.z, t2.z));
    hit = (tmax > 0.0f) && (tmin <= tmax);
    tmin_adj = tmin < 0.0f ? tmax : tmin;
    hit = hit && (tmin_adj >= 0.0f);
}

__device__ __forceinline__ bool aabb_contains(const float* bmin,
                                              const float* bmax, V3 q) {
    return q.x >= bmin[0] && q.x <= bmax[0] && q.y >= bmin[1] &&
           q.y <= bmax[1] && q.z >= bmin[2] && q.z <= bmax[2];
}

// scene/geometry.py::_sphere_roots + tracking._sphere_block
__device__ __forceinline__ bool sphere_block(const WalkParams& p, V3 pos,
                                             V3 dir, float& t) {
    const V3 orig = pos - v3(p.sph_center);
    const float a = dir.x * dir.x + dir.y * dir.y + dir.z * dir.z;
    const float b = 2.0f * (dir.x * orig.x + dir.y * orig.y + dir.z * orig.z);
    const float c = (orig.x * orig.x + orig.y * orig.y + orig.z * orig.z) -
                    p.sph_radius * p.sph_radius;
    const float disc = b * b - 4.0f * a * c;
    const float sq = sqrtf(jmax(disc, 0.0f));
    const float t0 = (-b - sq) / (2.0f * a);
    const float t1 = (-b + sq) / (2.0f * a);
    float tmin = jmin(t0, t1);
    const float tmax = jmax(t0, t1);
    tmin = tmin < 0.0f ? tmax : tmin;
    const bool hit = (disc >= 0.0f) && (tmin >= 0.0f) && p.sph_enabled;
    t = hit ? tmin : 3.4e38f;
    return hit;
}

// integrator._closest_object: 0 none, 1 the root box, 2 the sphere
__device__ __forceinline__ int closest_object(const WalkParams& p, V3 pos,
                                              V3 dir, float& t_min) {
    bool hit1;
    float t1, tmax1;
    aabb_intersect(p.root_min, p.root_max, pos, dir, hit1, t1, tmax1);
    float t2;
    const bool hit2 = sphere_block(p, pos, dir, t2);
    const int obj = (hit1 && (!hit2 || t1 < t2)) ? 1 : (hit2 ? 2 : 0);
    t_min = obj == 1 ? t1 : (obj == 2 ? t2 : 0.0f);
    return obj;
}

// ------------------------------------------------------------- phase --

__device__ __forceinline__ float hg(float c, float g) {
    const float denom = 1.0f + g * g - 2.0f * g * c;
    return 0.785398185253143310546875f * (1.0f - g * g) /
           (denom * sqrtf(jmax(denom, 1e-20f)));
}

__device__ __forceinline__ float phase_eval(const WalkParams& p, float c) {
    if (p.use_double_hg)
        return p.phase_f * hg(c, p.g1) + (1.0f - p.phase_f) * hg(c, p.g2);
    return hg(c, p.g1);
}

// core/phase.py::sample_hg on key k (u1 from split(k)[0], phi from
// split(k)[1], element idx): the direction and the phase value.
__device__ V3 sample_hg(V3 wo, Key k, float g, unsigned long long idx,
                        float& value) {
    const float u1 = uniform_at(split_at(k, 0), idx);
    const float sqr_term = (1.0f - g * g) / (1.0f - g + 2.0f * g * u1);
    const float cos_aniso = (1.0f + g * g - sqr_term * sqr_term) /
                            (2.0f * (fabsf(g) < 1e-6f ? 1.0f : g));
    const float ct = fabsf(g) < EPS ? 1.0f - 2.0f * u1 : cos_aniso;
    const float st = sqrtf(jmax(1.0f - ct * ct, 0.0f));
    const float phi = TWO_PI_F * uniform_at(split_at(k, 1), idx);
    const V3 v1 = -wo;
    const bool cond = fabsf(v1.x) > fabsf(v1.y);
    V3 v2 = cond ? v3(-v1.z, 0.0f, v1.x) : v3(0.0f, v1.z, -v1.y);
    v2 = normalize(v2);
    const V3 v3_ = normalize(cross(v1, v2));
    value = hg(-ct, g);
    return v2 * st * cosf(phi) + v3_ * st * sinf(phi) + wo * ct;
}

// core/phase.py::phase_sample on key k: one lobe, or both lobes from
// split(k) with the directions lerped (QUIRKS #16).
__device__ V3 phase_sample(const WalkParams& p, V3 dir, Key k,
                           unsigned long long idx, float& value) {
    if (!p.use_double_hg) return sample_hg(dir, k, p.g1, idx, value);
    float p1, p2;
    const V3 d1 = sample_hg(dir, split_at(k, 0), p.g1, idx, p1);
    const V3 d2 = sample_hg(dir, split_at(k, 1), p.g2, idx, p2);
    if (p.phase_f > 0.9999f) {
        value = p1;
        return d1;
    }
    if (p.phase_f < EPS) {
        value = p2;
        return d2;
    }
    value = p.phase_f * p1 + (1.0f - p.phase_f) * p2;
    return normalize(d1 + (d2 - d1) * (1.0f - p.phase_f));
}

// ------------------------------------------------------------ fetches --

// The grid point of world pos (tracking._row_norm_coords on the single
// grid): its corner row, the fractions, the unclipped index coordinate,
// and whether the point lies in the grid.
struct Cell {
    const float* row;
    V3 fr, x_u, i0f, ipos;
    bool inb;
};

__device__ __forceinline__ Cell locate(const Ctx& c, V3 pos) {
    const WalkParams& p = c.p;
    const float* m = p.inv_xf;
    Cell k;
    k.ipos = v3(pos.x * m[0] + pos.y * m[3] + pos.z * m[6] + m[9],
                pos.x * m[1] + pos.y * m[4] + pos.z * m[7] + m[10],
                pos.x * m[2] + pos.y * m[5] + pos.z * m[8] + m[11]);
    const V3 bmin = v3(p.gbmin), dimf = v3(p.gdim);
    const V3 npos = (k.ipos - bmin) / dimf;
    k.inb = npos.x >= 0.0f && npos.x <= 1.0f && npos.y >= 0.0f &&
            npos.y <= 1.0f && npos.z >= 0.0f && npos.z <= 1.0f;
    k.x_u = npos * dimf - v3(0.5f, 0.5f, 0.5f);
    const V3 x = v3(jmin(jmax(k.x_u.x, 0.0f), dimf.x - 1.0f),
                    jmin(jmax(k.x_u.y, 0.0f), dimf.y - 1.0f),
                    jmin(jmax(k.x_u.z, 0.0f), dimf.z - 1.0f));
    k.i0f = v3(floorf(x.x), floorf(x.y), floorf(x.z));
    k.fr = x - k.i0f;
    const long long flat =
        p.grid_off +
        ((long long)(int)k.i0f.z * p.dim[1] + (int)k.i0f.y) * p.dim[0] +
        (int)k.i0f.x;
    k.row = c.t.corners + flat * p.row_w;
    return k;
}

__device__ __forceinline__ float corner_weight(const Cell& k, int j) {
    const float wx = (j & 1) ? k.fr.x : 1.0f - k.fr.x;
    const float wy = (j & 2) ? k.fr.y : 1.0f - k.fr.y;
    const float wz = (j & 4) ? k.fr.z : 1.0f - k.fr.z;
    return wx * wy * wz;
}

// the trilinear sum of the 8 taps at k.row + off, `stride` apart
__device__ __forceinline__ float taps(const Cell& k, int off,
                                      int stride = 1) {
    const float* r = k.row + off;
    float s = __ldg(r) * corner_weight(k, 0);
#pragma unroll
    for (int j = 1; j < 8; ++j) s = s + __ldg(r + j * stride) * corner_weight(k, j);
    return s;
}

// tracking.scene_density on the single grid
__device__ __forceinline__ float density_at(const Ctx& c, V3 pos) {
    const Cell k = locate(c, pos);
    return k.inb ? taps(k, 0) : 0.0f;
}

// tracking.unified_fetch (not banded): the density and the distance the
// walk may jump through a guaranteed-empty box (0 where it may not)
__device__ __forceinline__ float fetch(const Ctx& c, V3 pos, V3 dir,
                                       float& skip) {
    const WalkParams& p = c.p;
    const Cell k = locate(c, pos);
    const float* m = p.inv_xf;
    const V3 idir = v3(dir.x * m[0] + dir.y * m[3] + dir.z * m[6],
                       dir.x * m[1] + dir.y * m[4] + dir.z * m[7],
                       dir.x * m[2] + dir.y * m[5] + dir.z * m[8]);
    const float* row = k.row;
    const float density = k.inb ? taps(k, 0) : 0.0f;
    const float t_box = __ldg(row + 8);
    const V3 cube_min =
        k.i0f - v3(jmax(__ldg(row + 9), 0.0f), jmax(__ldg(row + 10), 0.0f),
                   jmax(__ldg(row + 11), 0.0f));
    const V3 cube_max =
        k.i0f + v3(1.0f, 1.0f, 1.0f) +
        v3(jmax(__ldg(row + 12), 0.0f), jmax(__ldg(row + 13), 0.0f),
           jmax(__ldg(row + 14), 0.0f));
    const V3 sd = v3(fabsf(idir.x) < 1e-12f ? 1e-12f : idir.x,
                     fabsf(idir.y) < 1e-12f ? 1e-12f : idir.y,
                     fabsf(idir.z) < 1e-12f ? 1e-12f : idir.z);
    const V3 t1 = (cube_min - k.x_u) / sd;
    const V3 t2 = (cube_max - k.x_u) / sd;
    const float t_exit = jmin(jmin(jmax(t1.x, t2.x), jmax(t1.y, t2.y)),
                              jmax(t1.z, t2.z));
    const V3 bmin = v3(p.gbmin);
    const V3 t1b = (bmin - k.ipos) / sd;
    const V3 t2b = (bmin + v3(p.gdim) - k.ipos) / sd;
    float t_entry = jmax(jmax(jmin(t1b.x, t2b.x), jmin(t1b.y, t2b.y)),
                         jmin(t1b.z, t2b.z));
    const float t_leave = jmin(jmin(jmax(t1b.x, t2b.x), jmax(t1b.y, t2b.y)),
                               jmax(t1b.z, t2b.z));
    const bool misses = (t_leave < jmax(t_entry, 0.0f)) || (t_leave <= 0.0f);
    t_entry = misses ? 1e30f : jmax(t_entry, 0.0f);
    const float skip_in = t_exit > 0.0f ? t_exit + 1e-3f : 0.0f;
    const float skip_out = t_entry > 0.0f ? t_entry + 1e-3f : 0.0f;
    skip = (k.inb && t_box <= 0.0f) ? skip_in : (k.inb ? 0.0f : skip_out);
    return density;
}

// tracking.scene_emission on the single grid: the emission LUT's row at
// the truncated index x emission_scale, 0 outside the grid (QUIRKS #15)
template <bool EXT>
__device__ __forceinline__ V3 emission_at(const Ctx& c, V3 pos) {
    const Cell k = locate(c, pos);
    if (!EXT || c.p.em_off < 0 || !k.inb) return v3(0.0f, 0.0f, 0.0f);
    const float li = jclamp(taps(k, c.p.em_off) * 255.0f / c.p.emission_pivot,
                            0.0f, 255.0f);
    const float* e = c.t.lut + 768 + 3 * (int)li;
    const float s = c.p.emission_scale;
    return v3(e[0] * s, e[1] * s, e[2] * s);
}

// tracking.scene_color on the single grid: max(0, the trilinear color),
// 0 outside the grid; white without a color channel
template <bool EXT>
__device__ __forceinline__ V3 color_at(const Ctx& c, V3 pos) {
    if (!EXT || c.p.col_off < 0) return v3(1.0f, 1.0f, 1.0f);
    const Cell k = locate(c, pos);
    if (!k.inb) return v3(0.0f, 0.0f, 0.0f);
    return v3(jmax(0.0f, taps(k, c.p.col_off, 3)),
              jmax(0.0f, taps(k, c.p.col_off + 1, 3)),
              jmax(0.0f, taps(k, c.p.col_off + 2, 3)));
}

// -------------------------------------------------------------- walks --

struct Track {
    V3 pos, value;
    float alpha_add;
    int steps;
    bool interaction;
};

// tracking.delta_track for one active ray, steps on fold_in(key, s),
// draws (idx * 2, idx * 2 + 1)
template <bool EXT>
__device__ Track delta_track(const Ctx& c, Key key, V3 pos, V3 dir) {
    const WalkParams& p = c.p;
    bool hb;
    float tb0, t_box;
    aabb_intersect(p.root_min, p.root_max, pos, dir, hb, tb0, t_box);
    float t_sph;
    const bool sph_hit = sphere_block(p, pos, dir, t_sph);
    const float distance = (sph_hit && t_sph < t_box) ? t_sph : t_box;
    float skip;
    fetch(c, pos, dir, skip);
    Track r;
    r.interaction = false;
    r.alpha_add = 0.0f;
    r.steps = 0;
    float t = 0.0f;
    for (int s = 0; s < p.max_steps; ++s) {
        ++c.n_steps;
        const Key ks = fold_in(key, (uint32_t)s);
        const float u0 = uniform_at(ks, c.idx * 2);
        const bool do_skip = skip > 0.0f;
        const float dt = do_skip ? skip : -log1pf(-u0) * p.inv_rate;
        const float t_new = t + dt;
        const bool exited = t_new >= distance;
        float skip_new;
        const float d = fetch(c, pos + dir * t_new, dir, skip_new);
        t = t_new;
        skip = skip_new;
        const bool sampled = !do_skip && !exited;
        if (sampled) r.alpha_add = r.alpha_add + d;
        const bool accept =
            sampled && (d / p.max_ext > uniform_at(ks, c.idx * 2 + 1));
        if (exited || accept) {
            r.interaction = accept;
            break;
        }
        r.steps += 1;
    }
    r.pos = pos + dir * t;
    r.value = v3(1.0f, 1.0f, 1.0f);
    if (r.interaction) {
        const float li = jclamp(
            density_at(c, r.pos) / p.max_ext * 255.0f / p.emission_pivot,
            0.0f, 255.0f);
        const float* lrow = c.t.lut + 3 * (int)li;
        const V3 cd = color_at<EXT>(c, r.pos);
        r.value = v3(p.albedo[0] * cd.x * lrow[0] / p.ext[0] * p.energy_inject,
                     p.albedo[1] * cd.y * lrow[1] / p.ext[1] * p.energy_inject,
                     p.albedo[2] * cd.z * lrow[2] / p.ext[2] * p.energy_inject);
    }
    return r;
}

// tracking.transmittance: residual ratio tracking on fold_in(key, s),
// draw idx; 1 for a ray that misses the box, 0 for one that meets the
// sphere (QUIRKS #7)
__device__ float transmittance(const Ctx& c, Key key, V3 pos, V3 dir) {
    const WalkParams& p = c.p;
    bool hit;
    float t_entry, tmax;
    aabb_intersect(p.root_min, p.root_max, pos, dir, hit, t_entry, tmax);
    const bool inside = aabb_contains(p.root_min, p.root_max, pos);
    const V3 start = (!inside && hit) ? pos + dir * (t_entry + EPS) : pos;
    float ts;
    if (sphere_block(p, start, dir, ts)) return 0.0f;
    if (!inside && !hit) return 1.0f;
    bool h2;
    float t2, distance;
    aabb_intersect(p.root_min, p.root_max, start, dir, h2, t2, distance);
    distance = jmax(distance, 0.0f);
    const float t_c = expf(-p.sigma_c * distance);
    float skip;
    fetch(c, start, dir, skip);
    float tr = 1.0f, t = 0.0f;
    for (int s = 0; s < p.max_steps; ++s) {
        ++c.n_steps;
        const bool do_skip = skip > 0.0f;
        const float dt =
            do_skip ? skip
                    : -log1pf(-uniform_at(fold_in(key, (uint32_t)s), c.idx)) *
                          p.rate_inv_tr;
        const float t_new = t + dt;
        const bool exited = t_new >= distance;
        float skip_new;
        const float d = fetch(c, start + dir * t_new, dir, skip_new);
        t = t_new;
        skip = skip_new;
        if (!do_skip && !exited)
            tr = tr * (1.0f - (d - p.sigma_c) / p.sigma_r);
        if (exited || !(fabsf(tr) >= EPS)) break;
    }
    return jclamp(tr * t_c, 0.0f, 1.0f);
}

// tracking.estimate_emission: the emission summed at each sample of a
// walk at the ratio-tracking rate, no jumps, on fold_in(key, s), draw idx
template <bool EXT>
__device__ V3 estimate_emission(const Ctx& c, Key key, V3 pos, V3 dir) {
    const WalkParams& p = c.p;
    V3 e = v3(0.0f, 0.0f, 0.0f);
    if (!EXT || p.em_off < 0) return e;
    bool hit;
    float t0, distance;
    aabb_intersect(p.root_min, p.root_max, pos, dir, hit, t0, distance);
    distance = jmax(distance, 0.0f);
    float t = 0.0f;
    for (int s = 0; s < p.max_steps; ++s) {
        ++c.n_steps;
        const float u = uniform_at(fold_in(key, (uint32_t)s), c.idx);
        t = t + -log1pf(-u) * p.rate_inv_emit;
        if (t >= distance) break;
        e = e + emission_at<EXT>(c, pos + dir * t);
    }
    return e;
}

// ---------------------------------------------------------- the lights --

// nee.estimate_sun: Tr * phase(cos) * sun_color * sun_mult
__device__ V3 estimate_sun(const Ctx& c, Key key, V3 pos, V3 dir) {
    const WalkParams& p = c.p;
    const V3 wi = v3(p.sun_dir);
    const float ph = phase_eval(p, dot(dir, wi));
    const float tp = transmittance(c, fold_in(key, 0), pos, wi) * ph;
    return v3(tp * p.sun_color[0] * p.sun_mult, tp * p.sun_color[1] * p.sun_mult,
              tp * p.sun_color[2] * p.sun_mult);
}

// nee.estimate_point_lights: min(L, 11) picks summed unnormalised
// (QUIRKS #3), the falloff after reference_falloff (QUIRKS #2)
__device__ V3 estimate_point_lights(const Ctx& c, Key key, V3 pos, V3 dir) {
    const WalkParams& p = c.p;
    V3 total = v3(0.0f, 0.0f, 0.0f);
    for (int w = 0; w < p.n_pt_walks; ++w) {
        const Key kw = fold_in(key, (uint32_t)w);
        const float u = uniform_at(fold_in(kw, 0), c.idx);
        const int li = min((int)(u * (float)p.n_lights), p.n_lights - 1);
        const float* light = c.t.lights + 7 * li;
        const V3 lp = v3(light);
        const V3 wi = normalize(lp - pos);
        const float tr = transmittance(c, fold_in(kw, 1), pos, wi);
        const float ph = phase_eval(p, dot(dir, wi));
        float sqr;
        if (p.reference_falloff)
            sqr = length(lp * lp - pos * pos);
        else
            sqr = dot(lp - pos, lp - pos);
        const float falloff = 1.0f / jmax(sqr, 1e-12f);
        const float k = light[6] * ph * falloff * tr;
        total = total + v3(light + 3) * k;
    }
    return total;
}

// sky/procedural.py::sample_sky times intensity (= sky_color); RED for a
// ray that misses the atmosphere (environment.cu's, copied)
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

__device__ V3 sample_sky(const WalkEnv& p, V3 d) {
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
        if (below) continue;
        const float a_r = od_r + odl_r, a_m = od_m + odl_m;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const float tau = p.beta_r[k] * a_r + p.beta_m11[k] * a_m;
            const float atten = expf(-tau);
            sum_r[k] = sum_r[k] + atten * hr;
            sum_m[k] = sum_m[k] + atten * hm;
        }
    }
    if (miss) return v3(1.0f, 0.0f, 0.0f);
    V3 out;
    float* o = &out.x;
#pragma unroll
    for (int k = 0; k < 3; ++k)
        o[k] = (sum_r[k] * p.beta_r[k] * phase_r +
                sum_m[k] * p.beta_m[k] * phase_m) * p.color[k];
    return out;
}

// sky/envmap.py::sample_env_map on the raw (H, W, 3) map (environment.cu's)
__device__ V3 sample_env_map(const WalkEnv& p, const float* __restrict__ map,
                             V3 d) {
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

// nee.environment_light_radiance toward wi (sky_mult is the caller's)
__device__ __forceinline__ V3 env_light(const Ctx& c, V3 wi) {
    const WalkParams& p = c.p;
    if (p.nee_env == NEE_CONSTANT) return v3(p.sky_color);
    if (p.nee_env == NEE_HDRI) return sample_env_map(c.e, c.t.map, wi);
    ++c.n_sky;
    return sample_sky(c.e, wi);
}

// the first row (or column) index i in [0, n - 2] with a[i] <= u <
// a[i + 1]: searchsorted(a, u, right) - 1, clamped
__device__ __forceinline__ int search(const float* a, int n, float u) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(a + mid) <= u)
            lo = mid + 1;
        else
            hi = mid;
    }
    return min(max(lo - 1, 0), n - 2);
}

__device__ __forceinline__ float interp(const float* a, int n, float x) {
    x = jclamp(x, 0.0f, (float)n - 1.0f);
    const int i0 = (int)floorf(x);
    const int i1 = min(i0 + 1, n - 1);
    const float f = x - (float)i0;
    return __ldg(a + i0) * (1.0f - f) + __ldg(a + i1) * f;
}

// sky/cdf.py::sample_env_cdf for uniforms (u1, u2): the direction, pdf
__device__ V3 sample_env_cdf(const Ctx& c, float u1, float u2, float& pdf) {
    const WalkParams& p = c.p;
    const int n_v = p.cdf_h, n_u = p.cdf_w;
    const int v = search(c.t.m_cdf, n_v, u1);
    const float m0 = __ldg(c.t.m_cdf + v);
    const float d_m = __ldg(c.t.m_cdf + v + 1) - m0;
    const float dv = d_m > 0.0f ? (u1 - m0) / jmax(d_m, 1e-20f) : 0.0f;
    const float vf = (float)v + dv;
    const float marginal_pdf =
        interp(c.t.m_func, n_v, vf) / jmax(p.marginal_int, 1e-12f);
    const float theta = vf / (float)n_v * PI_F;
    const float* row = c.t.cdf + (long long)v * n_u;
    const int u = search(row, n_u, u2);
    const float c0 = __ldg(row + u);
    const float d_c = __ldg(row + u + 1) - c0;
    const float du = d_c > 0.0f ? (u2 - c0) / jmax(d_c, 1e-20f) : 0.0f;
    const float uf = (float)u + du;
    const float cond_pdf = interp(c.t.cdf_func + (long long)v * n_u, n_u, uf) /
                           jmax(__ldg(c.t.m_func + v), 1e-12f);
    const float phi = uf / (float)n_u * 2.0f * PI_F;
    const float sin_t = sinf(theta);
    pdf = (marginal_pdf * cond_pdf) / (TWO_PI_SQ_F * jmax(sin_t, 1e-6f));
    return v3(sin_t * cosf(phi), cosf(theta), sin_t * sinf(phi));
}

// sky/cdf.py::pdf_env_cdf: 0 where sin(theta) <= 0
__device__ float pdf_env_cdf(const Ctx& c, V3 wi) {
    const WalkParams& p = c.p;
    const int n_v = p.cdf_h, n_u = p.cdf_w;
    const float theta = acosf(jclamp(wi.y, -1.0f, 1.0f));
    float phi = atan2f(wi.z, wi.x);
    phi = phi < 0.0f ? phi + TWO_PI_F : phi;
    const float sin_theta = sinf(theta);
    if (sin_theta <= 0.0f) return 0.0f;
    const int iu = min(max((int)(phi / TWO_PI_F * (float)n_u), 0), n_u - 1);
    const int iv = min(max((int)(theta / PI_F * (float)n_v), 0), n_v - 1);
    const float mf = __ldg(c.t.m_func + iv);
    const float cond =
        __ldg(c.t.cdf_func + (long long)iv * n_u + iu) / jmax(mf, 1e-12f);
    const float marg = mf / jmax(p.marginal_int, 1e-12f);
    return (marg * cond) / (TWO_PI_SQ_F * jmax(sin_theta, 1e-6f));
}

__device__ __forceinline__ float power_heuristic(float f, float g) {
    return (f * f) / jmax(f * f + g * g, 1e-30f);
}

// nee.estimate_sky: (a) a light sample (the CDF, or the uniform sphere)
// weighted against the phase pdf, (b) a phase sample weighted against the
// light pdf, each with its shadow walk; keys split(key, 4)
__device__ V3 estimate_sky(const Ctx& c, Key key, V3 pos, V3 dir) {
    const WalkParams& p = c.p;
    const Key k_light = split_at(key, 0), k_phase = split_at(key, 1);
    V3 wi;
    float light_pdf;
    if (p.use_cdf) {
        wi = sample_env_cdf(c, uniform_at(split_at(k_light, 0), c.idx),
                            uniform_at(split_at(k_light, 1), c.idx),
                            light_pdf);
    } else {
        const float phi = TWO_PI_F * uniform_at(split_at(k_light, 0), c.idx);
        const float ct =
            1.0f - 2.0f * uniform_at(split_at(k_light, 1), c.idx);
        const float st = sqrtf(jmax(0.0f, 1.0f - ct * ct));
        wi = v3(cosf(phi) * st, sinf(phi) * st, ct);
        light_pdf = INV_4_PI_F;
    }
    V3 ld = v3(0.0f, 0.0f, 0.0f);
    const float phase_pdf = phase_eval(p, dot(dir, wi));
    if (light_pdf > 0.0f && phase_pdf > 0.0f) {
        const V3 li = env_light(c, wi);
        const float tr = transmittance(c, split_at(key, 2), pos, wi);
        const float w = power_heuristic(light_pdf, phase_pdf);
        ld = li * (tr * phase_pdf * w / jmax(light_pdf, 1e-20f));
    }
    float phase_pdf_b;
    const V3 wi_b = phase_sample(p, dir, k_phase, c.idx, phase_pdf_b);
    const float light_pdf_b = p.use_cdf ? pdf_env_cdf(c, wi_b) : INV_4_PI_F;
    if (phase_pdf_b > 0.0f && light_pdf_b > 0.0f) {
        const float w_b = power_heuristic(phase_pdf_b, light_pdf_b);
        const float tr_b = transmittance(c, split_at(key, 3), pos, wi_b);
        ld = ld + env_light(c, wi_b) * (tr_b * w_b);
    }
    return ld;
}

// ------------------------------------------------------------ outputs --

// K5's outputs, one float buffer of 7 S floats, S = B rounded up to a
// multiple of 4, as K1 lays out its own: L (B, 3) at 0, alpha at 3 S, cost
// at 4 S, trunc (0) at 5 S, depth at 6 S; with defer_env 13 S, beta at
// 7 S and the direction at 10 S; with defer_env 2 16 S, env_pos at 13 S.
__device__ __forceinline__ void write_out(const WalkParams& p, float* out,
                                          long long S, long long i, V3 L,
                                          float alpha, int cost, float depth,
                                          V3 beta, V3 dir, V3 env_pos) {
    if (!p.defer_env)   // BLACK: 0 * beta, as the reference
        L = L + (p.env_constant ? v3(p.sky) : v3(0.0f, 0.0f, 0.0f)) * beta;
    out[3 * i + 0] = L.x;
    out[3 * i + 1] = L.y;
    out[3 * i + 2] = L.z;
    out[3 * S + i] = jmin(alpha, 1.0f);
    out[4 * S + i] = (float)cost;
    out[5 * S + i] = 0.0f;
    out[6 * S + i] = depth;
    if (p.defer_env) {
        float* b = out + 7 * S + 3 * i;
        float* w = out + 10 * S + 3 * i;
        b[0] = beta.x;
        b[1] = beta.y;
        b[2] = beta.z;
        w[0] = dir.x;
        w[1] = dir.y;
        w[2] = dir.z;
    }
    if (p.defer_env == 2) {
        float* e = out + 13 * S + 3 * i;
        e[0] = env_pos.x;
        e[1] = env_pos.y;
        e[2] = env_pos.z;
    }
}

// The ray's tile key and its index in the tile.
__device__ __forceinline__ Ctx ray_ctx(const WalkParams& p, const WalkEnv& e,
                                       const WalkTables& t, long long r) {
    const Key key{p.key[0], p.key[1]};
    if (p.tile <= 0) return Ctx{p, e, t, key, (unsigned long long)r, 0u, 0u};
    return Ctx{p, e, t, fold_in(key, TILE_FOLD + (uint32_t)(r / p.tile)),
               (unsigned long long)(r % p.tile), 0u, 0u};
}

// stats[0] += the ray's bounces, [1] its walk steps, [2] its sky
// evaluations (a run that asks for them; null on the render path)
__device__ __forceinline__ void add_stats(unsigned long long* stats,
                                          const Ctx& c, int bounces) {
    if (!stats) return;
    atomicAdd(stats, (unsigned long long)bounces);
    atomicAdd(stats + 1, (unsigned long long)c.n_steps);
    atomicAdd(stats + 2, (unsigned long long)c.n_sky);
}

// integrator.direct_integrator for ray r
template <bool EXT>
__global__ void __launch_bounds__(THREADS)
walk_direct_kernel(const WalkParams p, const WalkEnv e, const WalkTables t,
                   const float* __restrict__ origin,
                   const float* __restrict__ direction,
                   float* __restrict__ out, unsigned long long* stats) {
    const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (r >= p.B) return;
    const Ctx c = ray_ctx(p, e, t, r);
    const V3 org = v3(origin + 3 * r);
    V3 pos = org, dir = v3(direction + 3 * r), env_pos = org;
    V3 beta = v3(1.0f, 1.0f, 1.0f), L = v3(0.0f, 0.0f, 0.0f);
    float alpha = 0.0f, depth_aov = 0.0f;
    int cost = 0, depth = 0;
    while (depth < p.ray_depth) {
        const Key kd = fold_in(c.kt, (uint32_t)depth);
        float t_min;
        const int obj = closest_object(p, pos, dir, t_min);
        bool mi = false;
        if (obj == 1) {
            V3 pos_v = pos + dir * (t_min + EPS);
            for (int vd = 0; vd < (EXT ? p.volume_depth : 1); ++vd) {
                const Key kv = fold_in(kd, 100u + (uint32_t)vd);
                const Track tr = delta_track<EXT>(c, kv, pos_v, dir);
                beta = beta * tr.value;
                alpha = alpha + tr.alpha_add;
                cost += tr.steps;
                pos_v = tr.pos;
                mi = tr.interaction;
                if (!mi) break;
                float ph;
                dir = phase_sample(p, dir, fold_in(kv, 1), c.idx, ph);
            }
            pos = pos_v;
        }
        if (mi) {
            if (depth == 0) depth_aov = length(org - pos);
            L = L + estimate_sun(c, fold_in(kd, 2), pos, dir) * beta;
            if (p.n_lights > 0)
                L = L + estimate_point_lights(c, fold_in(kd, 3), pos, dir) *
                            beta;
            if (EXT && p.em_off >= 0)
                L = L + estimate_emission<EXT>(c, fold_in(kd, 4), pos, dir);
        }
        float t2;
        const int obj2 = closest_object(p, pos, dir, t2);
        if (obj2 == 2) {
            if (depth == 0 && !mi) depth_aov = t2;
            // integrator._shade_sphere on fold_in(kd, 5)
            const Key ks = fold_in(kd, 5);
            const V3 hp = pos + dir * t2;
            const V3 normal = normalize((hp - v3(p.sph_center)) / p.sph_radius);
            const V3 nl = dot(normal, dir) < 0.0f ? normal : -normal;
            const float phi = TWO_PI_F * uniform_at(ks, c.idx * 2);
            const float r2 = uniform_at(ks, c.idx * 2 + 1);
            const float r2s = sqrtf(r2);
            const V3 w = normalize(nl);
            const V3 ref_axis = fabsf(w.x) > 0.1f ? v3(0.0f, 1.0f, 0.0f)
                                                  : v3(1.0f, 0.0f, 0.0f);
            const V3 uax = normalize(cross(ref_axis, w));
            const V3 vax = cross(w, uax);
            const V3 hemi = normalize(uax * (cosf(phi) * r2s) +
                                      vax * (sinf(phi) * r2s) +
                                      w * sqrtf(jmax(1.0f - r2, 0.0f)));
            const V3 mirror = reflect(dir, nl);
            const V3 new_pos = hp + normal * EPS;
            beta = beta * v3(p.sph_color);
            const V3 sun = v3(p.sun_dir);
            const float v_tr = transmittance(c, fold_in(ks, 3), new_pos, sun);
            const float k = v_tr * jmax(dot(sun, normal), 0.0f);
            L = L + v3(p.sun_color[0] * p.sun_mult * k,
                       p.sun_color[1] * p.sun_mult * k,
                       p.sun_color[2] * p.sun_mult * k) * beta;
            pos = new_pos;
            dir = mirror + (hemi - mirror) * p.sph_rough;
            env_pos = pos;
        }
        ++depth;
        if (obj == 0 && obj2 != 2) break;
    }
    write_out(p, out, ((long long)p.B + 3) & ~3LL, r, L, alpha, cost,
              depth_aov, beta, dir, env_pos);
    add_stats(stats, c, depth);
}

// vol_integrator.vol_integrator for ray r
template <bool EXT>
__global__ void __launch_bounds__(THREADS)
walk_volumetric_kernel(const WalkParams p, const WalkEnv e,
                       const WalkTables t, const float* __restrict__ origin,
                       const float* __restrict__ direction,
                       float* __restrict__ out, unsigned long long* stats) {
    const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (r >= p.B) return;
    const Ctx c = ray_ctx(p, e, t, r);
    const V3 org = v3(origin + 3 * r);
    V3 dir = v3(direction + 3 * r);
    bool hit;
    float t_entry, tmax;
    aabb_intersect(p.root_min, p.root_max, org, dir, hit, t_entry, tmax);
    V3 pos = hit ? org + dir * (t_entry + EPS) : org;
    V3 beta = v3(1.0f, 1.0f, 1.0f), L = v3(0.0f, 0.0f, 0.0f);
    float alpha = 0.0f, depth_aov = 0.0f;
    int cost = 0, depth = 0;
    for (; hit && depth < p.ray_depth; ++depth) {
        const Key kd = fold_in(c.kt, (uint32_t)depth);
        const Track tr = delta_track<EXT>(c, fold_in(kd, 0), pos, dir);
        beta = beta * tr.value;
        alpha = alpha + tr.alpha_add;
        cost += tr.steps;
        pos = tr.pos;
        if (beta.x == 0.0f && beta.y == 0.0f && beta.z == 0.0f) break;
        if (!tr.interaction) break;
        if (depth == 0) depth_aov = length(org - pos);
        // vol_integrator.uniform_sample_one_light on fold_in(kd, 1)
        const Key kl = fold_in(kd, 1);
        const int pick =
            (int)(uniform_at(fold_in(kl, 0), c.idx) * 3.0f);
        V3 ld = v3(0.0f, 0.0f, 0.0f);
        if (pick == 0) {
            ld = estimate_sun(c, fold_in(kl, 1), pos, dir);
        } else if (pick == 1) {
            if (p.n_lights > 0)
                ld = estimate_point_lights(c, fold_in(kl, 2), pos, dir);
        } else if (p.nee_env != NEE_BLACK) {
            ld = estimate_sky(c, fold_in(kl, 3), pos, dir) * p.sky_mult;
        }
        L = L + beta * (ld * 3.0f);
        if (EXT && p.em_off >= 0)
            L = L + estimate_emission<EXT>(c, fold_in(kd, 2), pos, dir);
        float ph;
        dir = phase_sample(p, dir, fold_in(kd, 3), c.idx, ph);
    }
    const V3 env_from = length(beta) > 0.9999f ? org : pos;
    write_out(p, out, ((long long)p.B + 3) & ~3LL, r, L, alpha, cost,
              depth_aov, beta, dir, env_from);
    add_stats(stats, c, depth);
}

template <bool EXT>
int launch(bool volumetric, const WalkParams& p, const WalkEnv& e,
           const WalkTables& t, const float* origin, const float* direction,
           float* out, unsigned long long* stats, cudaStream_t st) {
    const int blocks = (int)(((long long)p.B + THREADS - 1) / THREADS);
    if (volumetric)
        walk_volumetric_kernel<EXT><<<blocks, THREADS, 0, st>>>(
            p, e, t, origin, direction, out, stats);
    else
        walk_direct_kernel<EXT><<<blocks, THREADS, 0, st>>>(
            p, e, t, origin, direction, out, stats);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vpt_walk_params_size() { return (int)sizeof(WalkParams); }
extern "C" int vpt_walk_env_size() { return (int)sizeof(WalkEnv); }
extern "C" int vpt_walk_tables_size() { return (int)sizeof(WalkTables); }

// K5 on the B rays in (B, 3) origin and direction buffers: `volumetric`
// picks walk_volumetric over walk_direct, `ext` the EXT instances; `out`
// holds 7, 13 or 16 S floats (write_out); `stats`, 3 unsigned 64-bit
// counters the launch adds to (bounces, walk steps, sky evaluations), or
// null.
extern "C" int vpt_walk(int volumetric, int ext, const void* params,
                        const void* env, const void* tables,
                        const float* origin, const float* direction,
                        float* out, void* stats, void* stream) {
    const WalkParams& p = *static_cast<const WalkParams*>(params);
    const WalkTables& t = *static_cast<const WalkTables*>(tables);
    if (p.B <= 0) return 0;
    if (p.B > 0x7fffffff / 3 || p.tile < 0 || p.row_w < 15 ||
        t.corners == nullptr || t.lut == nullptr || t.lights == nullptr ||
        (p.nee_env == NEE_HDRI && t.map == nullptr) ||
        (p.use_cdf && (t.cdf == nullptr || p.cdf_h < 2 || p.cdf_w < 2)))
        return (int)cudaErrorInvalidValue;
    const WalkEnv& e = *static_cast<const WalkEnv*>(env);
    const cudaStream_t st = (cudaStream_t)stream;
    unsigned long long* n = static_cast<unsigned long long*>(stats);
    return ext ? launch<true>(volumetric, p, e, t, origin, direction, out, n,
                              st)
               : launch<false>(volumetric, p, e, t, origin, direction, out,
                               n, st);
}

// info[0..3] of one instance (volumetric, ext): registers per thread,
// local (spill and stack) bytes per thread, threads per block, resident
// blocks per SM.
extern "C" int vpt_walk_launch_info(int volumetric, int ext, int* info) {
    cudaFuncAttributes a{};
    const void* fn =
        volumetric ? (ext ? (const void*)walk_volumetric_kernel<true>
                          : (const void*)walk_volumetric_kernel<false>)
                   : (ext ? (const void*)walk_direct_kernel<true>
                          : (const void*)walk_direct_kernel<false>);
    cudaError_t err = cudaFuncGetAttributes(&a, fn);
    int per_sm = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                            THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    info[0] = a.numRegs;
    info[1] = (int)a.localSizeBytes;
    info[2] = THREADS;
    info[3] = per_sm;
    return 0;
}
