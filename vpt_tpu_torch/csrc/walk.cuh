// K5's device code (csrc/walk.cu says what it computes, how and why):
// its structs, the fetches of every kind of scene, the walks, the
// estimates and its kernels as templates.  walk.cu instantiates the
// kernels of single grids in float32 rows without octant columns
// (SC_F32) under the run-time sky kinds and launches every kernel;
// walk_rows.cu those of the other corner rows (SC_F32_OCT, SC_BF16) and
// the Bruneton sky kinds' NEE on any single grid; walk_cells.cu those of
// instanced scenes (SC_CELLS, SC_LOOP).  Each source hands walk.cu its
// kernels' addresses (WalkKernels), so the sources build in parallel.

#pragma once

#include <cuda_bf16.h>

#include <vector>

#include "atmosphere.cuh"
#include "vpt_common.cuh"

using namespace vpt;

namespace {

constexpr int THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t TILE_FOLD = 1000u;
constexpr float TWO_PI_SQ_F = 19.739208802178716f;   // 2 pi^2
constexpr float INV_4_PI_F = 0.0795774715459476678f;  // isotropic()
constexpr int N_SAMPLES = 16, N_SAMPLES_LIGHT = 8;
// the sky next-event estimate's environment (WalkParams::nee_env)
constexpr int NEE_BLACK = 0, NEE_CONSTANT = 1, NEE_HDRI = 2, NEE_SKY = 3;

// The slab of one tile at one bounce (render/walk.py::key_layout mirrors
// it): key_scalars keys, then key_walks blocks of key_steps step keys, the
// j-th block fold_in(the key of walk_slot(j), s) for s < key_steps.
// walk_volumetric, kd = fold_in(tile key, depth), kl = fold_in(kd, 1),
// ks = fold_in(kl, 3):
//   V_WALK        fold_in(kd, 0): delta_track
//   V_PICK        fold_in(kl, 0): uniform_sample_one_light's pick
//   V_SUN         fold_in(fold_in(kl, 1), 0): the sun's shadow walk
//   V_SKY_TR + i  split(ks, 2 + i): the sky's two shadow walks
//   V_EMIT        fold_in(kd, 2): the emission walk
//   V_SKY_U + i   split(split(ks, 0), i): the sky's light-sample draws
//   V_SKY_HG + i  hg_key(split(ks, 1), i): the sky's phase sample
//   V_SCATTER_HG + i  hg_key(fold_in(kd, 3), i): the scattering
//   V_POINT + 2w + i  fold_in(kw, i), kw = fold_in(fold_in(kl, 2), w):
//                 point-light walk w's pick (i 0) and shadow walk (i 1)
//   walks: V_WALK, V_SUN, V_SKY_TR, V_SKY_TR + 1, each point light's,
//   then V_EMIT where the scene has emission.
// walk_direct, nv = volume_depth, kv = fold_in(kd, 100 + v):
//   v < nv        kv: volume walk v
//   nv + 4 v + i  hg_key(fold_in(kv, 1), i): its scattering
//   5 nv + D_SUN  fold_in(fold_in(kd, 2), 0): the sun's shadow walk
//   5 nv + D_EMIT fold_in(kd, 4): the emission walk
//   5 nv + D_SPH  fold_in(kd, 5): the sphere's draws
//   5 nv + D_SPH_TR  fold_in(fold_in(kd, 5), 3): the sphere's shadow walk
//   5 nv + D_POINT + 2w + i  fold_in(kw, i), kw = fold_in(fold_in(kd, 3), w)
//   walks: the nv volume walks, the sun's, each point light's, then the
//   emission walk where the scene has emission, then the sphere's
//   shadow walk where a sphere is on.
constexpr int V_WALK = 0, V_PICK = 1, V_SUN = 2, V_SKY_TR = 3, V_EMIT = 5,
              V_SKY_U = 6, V_SKY_HG = 8, V_SCATTER_HG = 12, V_POINT = 16;
constexpr int D_SUN = 0, D_EMIT = 1, D_SPH = 2, D_SPH_TR = 3, D_POINT = 4;
// the volumetric walks' blocks
constexpr int VJ_WALK = 0, VJ_SUN = 1, VJ_SKY_TR = 2, VJ_POINT = 4;

// walk_volumetric's path queues (WalkWork::queue, B ints each) and
// counters (WalkWork::counts, N_COUNTS per bounce): C_* a queue's length,
// W_* a stage's next unclaimed entry; each bounce's own, zeroed once per
// launch.  walk_direct's ray counter is counts[0].
constexpr int Q_LIVE = 0, Q_SUN = 2, Q_POINT = 3, Q_SKY = 4, Q_SCATTER = 5,
              N_QUEUES = 6;
constexpr int C_LIVE = 0, C_SUN = 1, C_POINT = 2, C_SKY = 3, C_SCATTER = 4,
              W_EXTEND = 5, W_SUN = 6, W_POINT = 7, W_SKY = 8, W_SKY_B = 9,
              W_SCATTER = 10, N_COUNTS = 11;
// the kernels a launch counts (vpt_walk's `launches`)
constexpr int L_KEYS = 0, L_DIRECT = 1, L_EXTEND = 2, L_NEE = 3,
              L_SCATTER = 4, N_LAUNCH_KINDS = 5;
// stats: [0] bounces, [1] walk steps, [2] sky evaluations; with 8, [3 +
// k] the walk steps of walk_volumetric's stage k (EXTEND, sun, point
// lights, sky, SCATTER)
constexpr int N_STATS = 3, N_STATS_STAGES = 8;
// Resident blocks of THREADS asked of the compiler: the stage kernels 8
// (64 registers; 6, 10 and 12 measured slower), walk_direct 16 (32
// registers, the rest in local memory: 4, 5, 6, 8, 10 and 12 measured
// slower); walk_direct's lanes refill once REFILL_MIN of a warp are idle
// (1, 8 and 24 measured slower, 32 the same), so new rays come in runs of
// neighbours.  PERF.md (§6) has the measurements.
constexpr int STAGE_BLOCKS = 8, DIRECT_BLOCKS = 16, REFILL_MIN = 16;
// The scene a launch walks (WalkScene::kind, a template argument of the
// kernels that read it): a single grid in float32 corner rows without
// octant columns, with them, or in bfloat16 rows (whose octant columns
// WalkScene::octant turns on at run time); an instanced scene with cell
// lists, or without (the static loop over every instance).
constexpr int SC_F32 = 0, SC_F32_OCT = 1, SC_BF16 = 2, SC_CELLS = 3,
              SC_LOOP = 4, N_SC = 5;
// The sky the volumetric integrator's NEE reads (WalkScene::sky, a
// template argument of walk_nee_kernel): the run-time kinds of
// WalkParams::nee_env, the live Bruneton atmosphere from the event's
// position, or its baked sky cache.
constexpr int SKY_RUNTIME = 0, SKY_ATMOSPHERE = 1, SKY_CACHE = 2, N_SKY = 3;

}  // namespace

// Mirror of vpt_tpu_torch/render/walk.py::_WalkParams (all 4-byte fields,
// same order).
struct WalkParams {
    int B, tile, ray_depth, volume_depth, max_steps, n_lights, n_pt_walks,
        reference_falloff, use_double_hg, defer_env, env_constant, nee_env,
        use_cdf, cdf_h, cdf_w, row_w, em_off, col_off, grid_off,
        sph_enabled, n_tiles, key_scalars, key_walks, key_steps,
        key_depths;
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

// The device buffers a launch works in, allocated by the wrapper once per
// launch size.  Mirror of render/walk.py::_WalkWork.
struct WalkWork {
    float *state;       // (B, 16) PathState (walk_volumetric)
    int *queue;         // (N_QUEUES, B) path queues (walk_volumetric)
    unsigned *counts;   // (ray_depth + 1, N_COUNTS) counters
    unsigned *keys;     // (n_tiles, key_depths, slab, 2): the key table
};

// What the kernels of scenes other than SC_F32 read, a kernel argument of
// its own after the others (so the SC_F32 instances take theirs where
// they did before).  Mirror of render/walk.py::_WalkScene.  SC_CELLS:
// the majorant grid's cell rows (R^3, cell_w: T_box, the box extents,
// the octant columns where `octant`, the ids at ids_off, K of them);
// SC_LOOP: its packed rows (R^3, cell_w: T_box, the extents, the octant
// columns where `octant`), k the instance count; both: the instance rows
// (N, 24) and the cell size per axis.  SC_BF16: `octant`, whether the
// rows carry the octant columns.  The Bruneton sky kinds: the
// atmosphere's LUTs and constants, or its cache (environment.cu's
// AtmParams, as K4 takes them).
struct WalkScene {
    const float *cells;
    const float *inst;
    int kind, sky, octant, R, cell_w, ids_off, k;
    float cs[3];
    AtmParams atm;
};

namespace {

// The state of a path between walk_volumetric's stages, one per ray (96
// B, six 16-byte words): a stage reads and writes it at the path's ray
// index.  EXTEND writes the first four words (kind: its NEE kind), NEE
// the estimate (ld; for the sky the light sample's part and, where the
// phase sample contributes, that part in ld_b with has_b 1), SCATTER adds
// the estimate to L.
struct __align__(16) PathState {
    float pos[3], dir[3], beta[3], L[3];
    float alpha, depth_aov;
    int cost, kind;
    float ld[3], ld_b[3], has_b, pad;
};

__host__ __device__ __forceinline__ Key* table(const WalkWork& w) {
    return reinterpret_cast<Key*>(w.keys);
}

struct Ctx {
    const WalkParams& p;
    const WalkEnv& e;
    const WalkTables& t;
    const Key* slab;   // the ray's tile's keys at this bounce, or null
    Key kd;            // fold_in(tile key, depth), read where slab is null
    uint32_t idx;      // the ray's index in its tile
    // the ray's walk steps (every walk) and sky evaluations, summed into
    // the launch's stats where it asks for them
    mutable unsigned n_steps, n_sky;
    const WalkScene* s;   // read by the kinds other than SC_F32
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

// --------------------------------------------------------------- keys --

__device__ __forceinline__ Key ldg_key(const Key* k) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(k));
    return Key{v.x, v.y};
}

// The i-th draw key of core/phase.py::phase_sample on key k: one lobe
// draws u1 from split(k)[0] and phi from split(k)[1] (i 2, 3 unused, 0);
// two lobes the same from split(k)[0] and split(k)[1] in turn.
__device__ __forceinline__ Key hg_key(const WalkParams& p, Key k, int i) {
    if (p.use_double_hg)
        return split_at(split_at(k, (uint32_t)(i >> 1)), (uint32_t)(i & 1));
    return i < 2 ? split_at(k, (uint32_t)i) : Key{0u, 0u};
}

__host__ __device__ __forceinline__ bool has_emit(const WalkParams& p) {
    return p.em_off >= 0;
}

__host__ __device__ __forceinline__ int n_scalars(bool vol,
                                                  const WalkParams& p) {
    return vol ? V_POINT + 2 * p.n_pt_walks
               : 5 * p.volume_depth + D_POINT + 2 * p.n_pt_walks;
}

__host__ __device__ __forceinline__ int n_walks(bool vol,
                                                const WalkParams& p) {
    return vol ? VJ_POINT + p.n_pt_walks + has_emit(p)
               : p.volume_depth + 1 + p.n_pt_walks + has_emit(p) +
                     (p.sph_enabled != 0);
}

// the walk blocks of walk_direct
__device__ __forceinline__ int dj_sun(const WalkParams& p) {
    return p.volume_depth;
}
__device__ __forceinline__ int dj_emit(const WalkParams& p) {
    return p.volume_depth + 1 + p.n_pt_walks;
}
__device__ __forceinline__ int dj_sph(const WalkParams& p) {
    return dj_emit(p) + has_emit(p);
}
__device__ __forceinline__ int vj_emit(const WalkParams& p) {
    return VJ_POINT + p.n_pt_walks;
}

// the slot of walk block j's walk key
template <bool VOL>
__device__ __forceinline__ int walk_slot(const WalkParams& p, int j) {
    if (VOL) {
        if (j == VJ_WALK) return V_WALK;
        if (j == VJ_SUN) return V_SUN;
        if (j < VJ_POINT) return V_SKY_TR + j - VJ_SKY_TR;
        if (j < vj_emit(p)) return V_POINT + 2 * (j - VJ_POINT) + 1;
        return V_EMIT;
    }
    const int nv = p.volume_depth, d = 5 * nv;
    if (j < nv) return j;
    if (j == nv) return d + D_SUN;
    if (j < dj_emit(p)) return d + D_POINT + 2 * (j - nv - 1) + 1;
    if (has_emit(p) && j == dj_emit(p)) return d + D_EMIT;
    return d + D_SPH_TR;
}

// The key in `slot` of the slab of bounce key kd (the layout above), from
// the fold_in / split chains of the reference's integrators.
template <bool VOL>
__device__ Key slot_key(const WalkParams& p, Key kd, int slot) {
    if (VOL) {
        if (slot == V_WALK) return fold_in(kd, 0u);
        if (slot == V_EMIT) return fold_in(kd, 2u);
        if (slot >= V_SCATTER_HG && slot < V_POINT)
            return hg_key(p, fold_in(kd, 3u), slot - V_SCATTER_HG);
        const Key kl = fold_in(kd, 1u);
        if (slot == V_PICK) return fold_in(kl, 0u);
        if (slot == V_SUN) return fold_in(fold_in(kl, 1u), 0u);
        if (slot >= V_POINT) {
            const Key kw = fold_in(fold_in(kl, 2u),
                                   (uint32_t)((slot - V_POINT) >> 1));
            return fold_in(kw, (uint32_t)((slot - V_POINT) & 1));
        }
        const Key ks = fold_in(kl, 3u);
        if (slot < V_EMIT) return split_at(ks, (uint32_t)(2 + slot - V_SKY_TR));
        if (slot < V_SKY_HG)
            return split_at(split_at(ks, 0u), (uint32_t)(slot - V_SKY_U));
        return hg_key(p, split_at(ks, 1u), slot - V_SKY_HG);
    }
    const int nv = p.volume_depth;
    if (slot < nv) return fold_in(kd, 100u + (uint32_t)slot);
    if (slot < 5 * nv) {
        const int v = (slot - nv) >> 2;
        return hg_key(p, fold_in(fold_in(kd, 100u + (uint32_t)v), 1u),
                      (slot - nv) & 3);
    }
    slot -= 5 * nv;
    if (slot == D_SUN) return fold_in(fold_in(kd, 2u), 0u);
    if (slot == D_EMIT) return fold_in(kd, 4u);
    if (slot == D_SPH) return fold_in(kd, 5u);
    if (slot == D_SPH_TR) return fold_in(fold_in(kd, 5u), 3u);
    slot -= D_POINT;
    const Key kw = fold_in(fold_in(kd, 3u), (uint32_t)(slot >> 1));
    return fold_in(kw, (uint32_t)(slot & 1));
}

__device__ __forceinline__ Key tile_key(const WalkParams& p, int t) {
    const Key key{p.key[0], p.key[1]};
    return p.tile > 0 ? fold_in(key, TILE_FOLD + (uint32_t)t) : key;
}

__host__ __device__ __forceinline__ int slab_size(const WalkParams& p) {
    return p.key_scalars + p.key_walks * p.key_steps;
}

// The key table of bounces [d0, d0 + key_depths): entry ((t * key_depths
// + d - d0) * slab + slot), one thread an entry.
template <bool VOL>
__global__ void __launch_bounds__(THREADS)
walk_keys_kernel(const __grid_constant__ WalkParams p, Key* __restrict__ keys,
                 int d0) {
    const int slab = slab_size(p);
    const long long n = (long long)p.n_tiles * p.key_depths * slab;
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
         i += (long long)gridDim.x * THREADS) {
        const int slot = (int)(i % slab);
        const long long td = i / slab;
        const int d = d0 + (int)(td % p.key_depths);
        const Key kd = fold_in(tile_key(p, (int)(td / p.key_depths)),
                               (uint32_t)d);
        if (slot < p.key_scalars) {
            keys[i] = slot_key<VOL>(p, kd, slot);
        } else {
            const int j = (slot - p.key_scalars) / p.key_steps;
            const int s = (slot - p.key_scalars) % p.key_steps;
            keys[i] = fold_in(slot_key<VOL>(p, kd, walk_slot<VOL>(p, j)),
                              (uint32_t)s);
        }
    }
}

// The slab of tile t at bounce d in a table of bounces [0, key_depths),
// or null.
__device__ __forceinline__ const Key* slab_at(const WalkParams& p,
                                              const Key* keys, int t, int d) {
    if (d >= p.key_depths) return nullptr;
    return keys + ((long long)t * p.key_depths + d) * slab_size(p);
}

template <bool VOL>
__device__ __forceinline__ Key key_at(const Ctx& c, int slot) {
    return c.slab ? ldg_key(c.slab + slot) : slot_key<VOL>(c.p, c.kd, slot);
}

// A walk's step keys: the slab's for s < n, else folded in the thread.
struct Steps {
    const Key* cached;
    int n;
    Key base;
    __device__ __forceinline__ Key at(int s) const {
        return s < n ? ldg_key(cached + s) : fold_in(base, (uint32_t)s);
    }
};

template <bool VOL>
__device__ __forceinline__ Steps steps_of(const Ctx& c, int j) {
    const Key base = key_at<VOL>(c, walk_slot<VOL>(c.p, j));
    if (!c.slab) return Steps{nullptr, 0, base};
    return Steps{c.slab + c.p.key_scalars + (long long)j * c.p.key_steps,
                 c.p.key_steps, base};
}

struct HG {
    Key k[4];
};

template <bool VOL>
__device__ __forceinline__ HG hg_at(const Ctx& c, int slot0) {
    HG h;
    h.k[0] = key_at<VOL>(c, slot0);
    h.k[1] = key_at<VOL>(c, slot0 + 1);
    h.k[2] = h.k[3] = Key{0u, 0u};
    if (c.p.use_double_hg) {
        h.k[2] = key_at<VOL>(c, slot0 + 2);
        h.k[3] = key_at<VOL>(c, slot0 + 3);
    }
    return h;
}

// core/phase.py::sample_hg: u1 from ka, phi from kb, element idx; the
// direction and the phase value.
__device__ V3 sample_hg(V3 wo, Key ka, Key kb, float g, uint32_t idx,
                        float& value) {
    const float u1 = uniform_at32(ka, idx);
    const float sqr_term = (1.0f - g * g) / (1.0f - g + 2.0f * g * u1);
    const float cos_aniso = (1.0f + g * g - sqr_term * sqr_term) /
                            (2.0f * (fabsf(g) < 1e-6f ? 1.0f : g));
    const float ct = fabsf(g) < EPS ? 1.0f - 2.0f * u1 : cos_aniso;
    const float st = sqrtf(jmax(1.0f - ct * ct, 0.0f));
    const float phi = TWO_PI_F * uniform_at32(kb, idx);
    const V3 v1 = -wo;
    const bool cond = fabsf(v1.x) > fabsf(v1.y);
    V3 v2 = cond ? v3(-v1.z, 0.0f, v1.x) : v3(0.0f, v1.z, -v1.y);
    v2 = normalize(v2);
    const V3 v3_ = normalize(cross(v1, v2));
    value = hg(-ct, g);
    return v2 * st * cosf(phi) + v3_ * st * sinf(phi) + wo * ct;
}

// core/phase.py::phase_sample on its draw keys (hg_key): one lobe, or
// both lobes with the directions lerped (QUIRKS #16).
__device__ V3 phase_sample(const WalkParams& p, V3 dir, const HG& h,
                           uint32_t idx, float& value) {
    if (!p.use_double_hg) return sample_hg(dir, h.k[0], h.k[1], p.g1, idx,
                                           value);
    float p1, p2;
    const V3 d1 = sample_hg(dir, h.k[0], h.k[1], p.g1, idx, p1);
    const V3 d2 = sample_hg(dir, h.k[2], h.k[3], p.g2, idx, p2);
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
// Every kind of scene the plain walks take (walk.cuh's SC_*).  A single
// grid (tracking._unified_fetch_single, scene_density / _emission /
// _color on it): its corner rows of element type Row, read by one typed
// load (bfloat16 widened exactly, as the reference's astype(float32)
// after its gather, tracking.py:445); with OCT, an empty box's exit
// widened by the anchored box of the ray's octant and major axis where
// the launch's rows carry the octant columns (cols 15:87; WalkScene::
// octant).  SC_F32 is Row float without OCT, the code it ran before the
// other kinds.  An instanced scene (tracking.scene_density / _emission /
// _color, the multi-instance branch of unified_fetch): the density summed
// over the slots of the cell that the reference's lookups pick, (pos -
// root) / extent * R, each slot an instance row and one corner row; the
// empty box from the majorant grid's packed columns at the walk's cell,
// (pos - root) / cs, which may be the next cell at a boundary
// (accel/majorant.py::empty_skip_t).  The slots' code is K1's fetch_cells
// and slots_* with the walk's own box.

template <int SC>
struct RowOf {
    using T = float;
};
template <>
struct RowOf<SC_BF16> {
    using T = __nv_bfloat16;
};

// a corner row's element as a float: the one typed load of the rows
__device__ __forceinline__ float ldr(const float* q) { return __ldg(q); }
__device__ __forceinline__ float ldr(const __nv_bfloat16* q) {
    return __bfloat162float(__ldg(q));
}

// The grid point of world pos (tracking._row_norm_coords on the single
// grid): its corner row, the fractions, the unclipped index coordinate,
// and whether the point lies in the grid.
template <typename Row>
struct Cell {
    const Row* row;
    V3 fr, x_u, i0f, ipos;
    bool inb;
};

template <typename Row>
__device__ __forceinline__ Cell<Row> locate(const Ctx& c, V3 pos) {
    const WalkParams& p = c.p;
    const float* m = p.inv_xf;
    Cell<Row> k;
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
    k.row = reinterpret_cast<const Row*>(c.t.corners) + flat * p.row_w;
    return k;
}

__device__ __forceinline__ float corner_weight(V3 fr, int j) {
    const float wx = (j & 1) ? fr.x : 1.0f - fr.x;
    const float wy = (j & 2) ? fr.y : 1.0f - fr.y;
    const float wz = (j & 4) ? fr.z : 1.0f - fr.z;
    return wx * wy * wz;
}

// the trilinear sum of the 8 taps at k.row + off, `stride` apart
template <typename Row>
__device__ __forceinline__ float taps(const Cell<Row>& k, int off,
                                      int stride = 1) {
    const Row* r = k.row + off;
    float s = ldr(r) * corner_weight(k.fr, 0);
#pragma unroll
    for (int j = 1; j < 8; ++j)
        s = s + ldr(r + j * stride) * corner_weight(k.fr, j);
    return s;
}

// tracking.scene_density on the single grid
template <typename Row>
__device__ __forceinline__ float density_at(const Ctx& c, V3 pos) {
    const Cell<Row> k = locate<Row>(c, pos);
    return k.inb ? taps(k, 0) : 0.0f;
}

// accel/majorant.py::octant_exit: the exit of the anchored box of the
// ray's octant (dv > 0 per axis) and major axis (the largest |dv|, a tie
// to the lower axis), 3 of the 72 columns at e72; i0f the cell, pu the
// position and dv the direction, all in cell units
template <typename Row>
__device__ __forceinline__ float octant_exit(const Row* e72, V3 i0f, V3 pu,
                                             V3 dv) {
    const float ax = fabsf(dv.x), ay = fabsf(dv.y), az = fabsf(dv.z);
    const int oct = (dv.x > 0.0f) + 2 * (dv.y > 0.0f) + 4 * (dv.z > 0.0f);
    const int major = az > jmax(ax, ay) ? 2 : (ay > ax ? 1 : 0);
    const Row* e = e72 + 9 * oct + 3 * major;
    const float d3[3] = {dv.x, dv.y, dv.z};
    const float r3[3] = {pu.x, pu.y, pu.z};
    const float c3[3] = {i0f.x, i0f.y, i0f.z};
    float t_oct = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float ea = jmax(ldr(e + a), 0.0f);
        const float face = d3[a] > 0.0f ? c3[a] + 1.0f + ea : c3[a] - ea;
        const float ta =
            fabsf(d3[a]) < 1e-12f ? 3.4e38f : (face - r3[a]) / d3[a];
        t_oct = a == 0 ? ta : jmin(t_oct, ta);
    }
    return t_oct;
}

// tracking.unified_fetch (not banded) on the single grid: the density and
// the distance the walk may jump through a guaranteed-empty box (0 where
// it may not).  Each exit is computed only where it is the answer: the
// empty box's exit for a point in the grid whose box is empty (T_box <=
// 0), the grid's entry for a point outside it; a point in a box that is
// not empty jumps 0.
template <typename Row, bool OCT>
__device__ __forceinline__ float fetch(const Ctx& c, V3 pos, V3 dir,
                                       float& skip) {
    const WalkParams& p = c.p;
    const Cell<Row> k = locate<Row>(c, pos);
    const Row* row = k.row;
    const float density = k.inb ? taps(k, 0) : 0.0f;
    skip = 0.0f;
    const bool empty = k.inb && ldr(row + 8) <= 0.0f;
    if (empty || !k.inb) {
        const float* m = p.inv_xf;
        const V3 idir = v3(dir.x * m[0] + dir.y * m[3] + dir.z * m[6],
                           dir.x * m[1] + dir.y * m[4] + dir.z * m[7],
                           dir.x * m[2] + dir.y * m[5] + dir.z * m[8]);
        const V3 sd = v3(fabsf(idir.x) < 1e-12f ? 1e-12f : idir.x,
                         fabsf(idir.y) < 1e-12f ? 1e-12f : idir.y,
                         fabsf(idir.z) < 1e-12f ? 1e-12f : idir.z);
        if (empty) {
            const V3 cube_min =
                k.i0f - v3(jmax(ldr(row + 9), 0.0f),
                           jmax(ldr(row + 10), 0.0f),
                           jmax(ldr(row + 11), 0.0f));
            const V3 cube_max =
                k.i0f + v3(1.0f, 1.0f, 1.0f) +
                v3(jmax(ldr(row + 12), 0.0f), jmax(ldr(row + 13), 0.0f),
                   jmax(ldr(row + 14), 0.0f));
            const V3 t1 = (cube_min - k.x_u) / sd;
            const V3 t2 = (cube_max - k.x_u) / sd;
            float t_exit = jmin(jmin(jmax(t1.x, t2.x), jmax(t1.y, t2.y)),
                                jmax(t1.z, t2.z));
            if constexpr (OCT) {
                if (c.s->octant)
                    t_exit = jmax(t_exit, octant_exit(row + 15, k.i0f, k.x_u,
                                                      idir));
            }
            skip = t_exit > 0.0f ? t_exit + 1e-3f : 0.0f;
        } else {
            const V3 bmin = v3(p.gbmin);
            const V3 t1b = (bmin - k.ipos) / sd;
            const V3 t2b = (bmin + v3(p.gdim) - k.ipos) / sd;
            float t_entry = jmax(jmax(jmin(t1b.x, t2b.x), jmin(t1b.y, t2b.y)),
                                 jmin(t1b.z, t2b.z));
            const float t_leave =
                jmin(jmin(jmax(t1b.x, t2b.x), jmax(t1b.y, t2b.y)),
                     jmax(t1b.z, t2b.z));
            const bool misses =
                (t_leave < jmax(t_entry, 0.0f)) || (t_leave <= 0.0f);
            t_entry = misses ? 1e30f : jmax(t_entry, 0.0f);
            skip = t_entry > 0.0f ? t_entry + 1e-3f : 0.0f;
        }
    }
    return density;
}

// tracking.scene_emission on the single grid: the emission LUT's row at
// the truncated index x emission_scale, 0 outside the grid (QUIRKS #15)
template <bool EXT, typename Row>
__device__ __forceinline__ V3 emission_at(const Ctx& c, V3 pos) {
    const Cell<Row> k = locate<Row>(c, pos);
    if (!EXT || c.p.em_off < 0 || !k.inb) return v3(0.0f, 0.0f, 0.0f);
    const float li = jclamp(taps(k, c.p.em_off) * 255.0f / c.p.emission_pivot,
                            0.0f, 255.0f);
    const float* e = c.t.lut + 768 + 3 * (int)li;
    const float s = c.p.emission_scale;
    return v3(e[0] * s, e[1] * s, e[2] * s);
}

// tracking.scene_color on the single grid: max(0, the trilinear color),
// 0 outside the grid; white without a color channel
template <bool EXT, typename Row>
__device__ __forceinline__ V3 color_at(const Ctx& c, V3 pos) {
    if (!EXT || c.p.col_off < 0) return v3(1.0f, 1.0f, 1.0f);
    const Cell<Row> k = locate<Row>(c, pos);
    if (!k.inb) return v3(0.0f, 0.0f, 0.0f);
    return v3(jmax(0.0f, taps(k, c.p.col_off, 3)),
              jmax(0.0f, taps(k, c.p.col_off + 1, 3)),
              jmax(0.0f, taps(k, c.p.col_off + 2, 3)));
}

// One instance's corner row at world pos (tracking._row_norm_coords, K1's
// instance_row): false outside its grid; else g's row and fractions.
__device__ __forceinline__ bool instance_cell(const Ctx& c, int id, V3 pos,
                                              Cell<float>& g) {
    const float* ir = c.s->inst + 24LL * id;
    float m[19];
#pragma unroll
    for (int q = 0; q < 19; ++q) m[q] = __ldg(ir + q);
    const V3 ipos = v3(pos.x * m[0] + pos.y * m[3] + pos.z * m[6] + m[9],
                       pos.x * m[1] + pos.y * m[4] + pos.z * m[7] + m[10],
                       pos.x * m[2] + pos.y * m[5] + pos.z * m[8] + m[11]);
    const V3 bmin = v3(m[12], m[13], m[14]), dimf = v3(m[15], m[16], m[17]);
    const V3 npos = (ipos - bmin) / dimf;
    if (!(npos.x >= 0.0f && npos.x <= 1.0f && npos.y >= 0.0f &&
          npos.y <= 1.0f && npos.z >= 0.0f && npos.z <= 1.0f))
        return false;
    const V3 xu = npos * dimf - v3(0.5f, 0.5f, 0.5f);
    const V3 x = v3(jmin(jmax(xu.x, 0.0f), dimf.x - 1.0f),
                    jmin(jmax(xu.y, 0.0f), dimf.y - 1.0f),
                    jmin(jmax(xu.z, 0.0f), dimf.z - 1.0f));
    const V3 i0 = v3(floorf(x.x), floorf(x.y), floorf(x.z));
    const long long flat =
        (long long)m[18] +
        ((long long)(int)i0.z * (int)dimf.y + (int)i0.y) * (int)dimf.x +
        (int)i0.x;
    g.fr = x - i0;
    g.row = c.t.corners + flat * c.p.row_w;
    return true;
}

// The ids of the slots the reference's lookups read at pos
// (tracking._cell_flat_index: (pos - root) / extent * R): the cell row's
// ids columns; null for the static loop, whose slots are 0 ... k-1.
template <int SC>
__device__ __forceinline__ const float* list_ids(const Ctx& c, V3 pos) {
    if (SC == SC_LOOP) return nullptr;
    const WalkScene& s = *c.s;
    const V3 root = v3(c.p.root_min);
    const V3 rel = (pos - root) / (v3(c.p.root_max) - root) * (float)s.R;
    const int R1 = s.R - 1;
    const int cx = min(max((int)floorf(rel.x), 0), R1);
    const int cy = min(max((int)floorf(rel.y), 0), R1);
    const int cz = min(max((int)floorf(rel.z), 0), R1);
    return s.cells + (((long long)cz * s.R + cy) * s.R + cx) * s.cell_w +
           s.ids_off;
}

// slot j's instance, or -1 past the listed ones (they fill the first
// slots)
__device__ __forceinline__ int slot_id(const float* ids, int j) {
    return ids ? (int)__ldg(ids + j) : j;
}

// tracking.scene_density: the densities of the slots summed in slot order
template <int SC>
__device__ __forceinline__ float slots_density(const Ctx& c, V3 pos) {
    const float* ids = list_ids<SC>(c, pos);
    float d = 0.0f;
    for (int j = 0; j < c.s->k; ++j) {
        const int id = slot_id(ids, j);
        if (id < 0) break;
        Cell<float> g;
        if (!instance_cell(c, id, pos, g)) continue;   // 0 outside its grid
        d = d + taps(g, 0);
    }
    return d;
}

// unified_fetch on an instanced scene: the summed density, and where the
// walk's cell of the packed rows is empty (T_box <= 0) and the density 0,
// the exit of its box (widened by the octant box's where the rows carry
// the columns) plus 1e-3 (accel/majorant.py::_packed_box)
template <int SC>
__device__ __forceinline__ float fetch_slots(const Ctx& c, V3 pos, V3 dir,
                                             float& skip) {
    const float density = slots_density<SC>(c, pos);
    skip = 0.0f;
    const WalkScene& s = *c.s;
    const V3 root = v3(c.p.root_min), cs = v3(s.cs);
    const V3 rel = (pos - root) / cs;
    const int R1 = s.R - 1;
    const int cx = min(max((int)floorf(rel.x), 0), R1);
    const int cy = min(max((int)floorf(rel.y), 0), R1);
    const int cz = min(max((int)floorf(rel.z), 0), R1);
    const float* row =
        s.cells + (((long long)cz * s.R + cy) * s.R + cx) * s.cell_w;
    if (!(__ldg(row) <= 0.0f && density <= 0.0f)) return density;
    const V3 cif = v3((float)cx, (float)cy, (float)cz);
    const V3 cube_min =
        root + (cif - v3(jmax(__ldg(row + 1), 0.0f), jmax(__ldg(row + 2), 0.0f),
                         jmax(__ldg(row + 3), 0.0f))) * cs;
    const V3 cube_max =
        root + (cif + v3(1.0f, 1.0f, 1.0f) +
                v3(jmax(__ldg(row + 4), 0.0f), jmax(__ldg(row + 5), 0.0f),
                   jmax(__ldg(row + 6), 0.0f))) * cs;
    const V3 inv = v3(1.0f / (fabsf(dir.x) < 1e-12f ? 1e-12f : dir.x),
                      1.0f / (fabsf(dir.y) < 1e-12f ? 1e-12f : dir.y),
                      1.0f / (fabsf(dir.z) < 1e-12f ? 1e-12f : dir.z));
    const V3 t1 = (cube_min - pos) * inv;
    const V3 t2 = (cube_max - pos) * inv;
    float t_exit = jmin(jmin(jmax(t1.x, t2.x), jmax(t1.y, t2.y)),
                        jmax(t1.z, t2.z));
    if (s.octant)
        t_exit = jmax(t_exit, octant_exit(row + 7, cif, rel, dir / cs));
    skip = t_exit > 0.0f ? t_exit + 1e-3f : 0.0f;
    return density;
}

// tracking.scene_emission: the emission LUT's row x emission_scale of
// each slot's trilinear emission, summed in slot order over the slots
// whose grid has the channel and holds pos
template <int SC>
__device__ V3 slots_emission(const Ctx& c, V3 pos) {
    const float* ids = list_ids<SC>(c, pos);
    V3 e = v3(0.0f, 0.0f, 0.0f);
    for (int j = 0; j < c.s->k; ++j) {
        const int id = slot_id(ids, j);
        if (id < 0) break;
        Cell<float> g;
        if (__ldg(c.s->inst + 24LL * id + 19) < 0.0f ||
            !instance_cell(c, id, pos, g))
            continue;
        const float li = jclamp(
            taps(g, c.p.em_off) * 255.0f / c.p.emission_pivot, 0.0f,
            255.0f);
        const float* r = c.t.lut + 768 + 3 * (int)li;
        const float k = c.p.emission_scale;
        e = e + v3(r[0] * k, r[1] * k, r[2] * k);
    }
    return e;
}

// tracking.scene_color: the component-wise max from 0 of each slot's Cd:
// its trilinear color, 0 outside its grid, white where its grid has no
// color channel
template <int SC>
__device__ V3 slots_color(const Ctx& c, V3 pos) {
    const float* ids = list_ids<SC>(c, pos);
    V3 cd = v3(0.0f, 0.0f, 0.0f);
    for (int j = 0; j < c.s->k; ++j) {
        const int id = slot_id(ids, j);
        if (id < 0) break;
        V3 v = v3(1.0f, 1.0f, 1.0f);
        if (__ldg(c.s->inst + 24LL * id + 20) >= 0.0f) {
            Cell<float> g;
            v = instance_cell(c, id, pos, g)
                    ? v3(taps(g, c.p.col_off, 3),
                         taps(g, c.p.col_off + 1, 3),
                         taps(g, c.p.col_off + 2, 3))
                    : v3(0.0f, 0.0f, 0.0f);
        }
        cd = v3(jmax(cd.x, v.x), jmax(cd.y, v.y), jmax(cd.z, v.z));
    }
    return cd;
}

// the scene kinds' fetches: tracking.scene_density
template <int SC>
__device__ __forceinline__ float density_sc(const Ctx& c, V3 pos) {
    if constexpr (SC < SC_CELLS)
        return density_at<typename RowOf<SC>::T>(c, pos);
    else
        return slots_density<SC>(c, pos);
}

// tracking.unified_fetch (not banded)
template <int SC>
__device__ __forceinline__ float fetch_sc(const Ctx& c, V3 pos, V3 dir,
                                          float& skip) {
    if constexpr (SC < SC_CELLS)
        return fetch<typename RowOf<SC>::T, SC != SC_F32>(c, pos, dir, skip);
    else
        return fetch_slots<SC>(c, pos, dir, skip);
}

// tracking.scene_emission (0 without EXT or the channel)
template <bool EXT, int SC>
__device__ __forceinline__ V3 emission_sc(const Ctx& c, V3 pos) {
    if constexpr (SC < SC_CELLS) {
        return emission_at<EXT, typename RowOf<SC>::T>(c, pos);
    } else {
        if (!EXT || c.p.em_off < 0) return v3(0.0f, 0.0f, 0.0f);
        return slots_emission<SC>(c, pos);
    }
}

// tracking.scene_color (white without EXT or the channel)
template <bool EXT, int SC>
__device__ __forceinline__ V3 color_sc(const Ctx& c, V3 pos) {
    if constexpr (SC < SC_CELLS) {
        return color_at<EXT, typename RowOf<SC>::T>(c, pos);
    } else {
        if (!EXT || c.p.col_off < 0) return v3(1.0f, 1.0f, 1.0f);
        return slots_color<SC>(c, pos);
    }
}

// -------------------------------------------------------------- walks --

struct Track {
    V3 pos, value;
    float alpha_add;
    int steps;
    bool interaction;
};

// tracking.delta_track for one active ray, step s on ks.at(s), draws
// (idx * 2, idx * 2 + 1)
template <bool EXT, int SC>
__device__ Track delta_track(const Ctx& c, const Steps& ks, V3 pos, V3 dir) {
    const WalkParams& p = c.p;
    bool hb;
    float tb0, t_box;
    aabb_intersect(p.root_min, p.root_max, pos, dir, hb, tb0, t_box);
    float t_sph;
    const bool sph_hit = sphere_block(p, pos, dir, t_sph);
    const float distance = (sph_hit && t_sph < t_box) ? t_sph : t_box;
    float skip;
    fetch_sc<SC>(c, pos, dir, skip);
    Track r;
    r.interaction = false;
    r.alpha_add = 0.0f;
    r.steps = 0;
    float t = 0.0f;
    Key k = ks.at(0);
    for (int s = 0; s < p.max_steps; ++s) {
        ++c.n_steps;
        // the next step's key, loaded while this step's row is fetched
        const Key k_next = ks.at(s + 1);
        const bool do_skip = skip > 0.0f;
        // a jump draws nothing: the flight's uniform only where it is used
        const float dt =
            do_skip ? skip
                    : -log1pf(-uniform_at32(k, c.idx * 2u)) * p.inv_rate;
        const float t_new = t + dt;
        const bool exited = t_new >= distance;
        float skip_new;
        const float d = fetch_sc<SC>(c, pos + dir * t_new, dir, skip_new);
        t = t_new;
        skip = skip_new;
        const bool sampled = !do_skip && !exited;
        if (sampled) r.alpha_add = r.alpha_add + d;
        const bool accept =
            sampled && (d / p.max_ext > uniform_at32(k, c.idx * 2u + 1u));
        if (exited || accept) {
            r.interaction = accept;
            break;
        }
        r.steps += 1;
        k = k_next;
    }
    r.pos = pos + dir * t;
    r.value = v3(1.0f, 1.0f, 1.0f);
    if (r.interaction) {
        const float li = jclamp(
            density_sc<SC>(c, r.pos) / p.max_ext * 255.0f / p.emission_pivot,
            0.0f, 255.0f);
        const float* lrow = c.t.lut + 3 * (int)li;
        const V3 cd = color_sc<EXT, SC>(c, r.pos);
        r.value = v3(p.albedo[0] * cd.x * lrow[0] / p.ext[0] * p.energy_inject,
                     p.albedo[1] * cd.y * lrow[1] / p.ext[1] * p.energy_inject,
                     p.albedo[2] * cd.z * lrow[2] / p.ext[2] * p.energy_inject);
    }
    return r;
}

// tracking.transmittance: residual ratio tracking, step s on ks.at(s),
// draw idx; 1 for a ray that misses the box, 0 for one that meets the
// sphere (QUIRKS #7)
template <int SC>
__device__ float transmittance(const Ctx& c, const Steps& ks, V3 pos,
                               V3 dir) {
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
    fetch_sc<SC>(c, start, dir, skip);
    float tr = 1.0f, t = 0.0f;
    Key k = ks.at(0);
    for (int s = 0; s < p.max_steps; ++s) {
        ++c.n_steps;
        const Key k_next = ks.at(s + 1);
        const bool do_skip = skip > 0.0f;
        const float dt =
            do_skip ? skip : -log1pf(-uniform_at32(k, c.idx)) * p.rate_inv_tr;
        const float t_new = t + dt;
        const bool exited = t_new >= distance;
        float skip_new;
        const float d = fetch_sc<SC>(c, start + dir * t_new, dir, skip_new);
        t = t_new;
        skip = skip_new;
        if (!do_skip && !exited)
            tr = tr * (1.0f - (d - p.sigma_c) / p.sigma_r);
        if (exited || !(fabsf(tr) >= EPS)) break;
        k = k_next;
    }
    return jclamp(tr * t_c, 0.0f, 1.0f);
}

// tracking.estimate_emission: the emission summed at each sample of a
// walk at the ratio-tracking rate, no jumps, step s on ks.at(s), draw idx
template <bool EXT, int SC>
__device__ V3 estimate_emission(const Ctx& c, const Steps& ks, V3 pos,
                                V3 dir) {
    const WalkParams& p = c.p;
    V3 e = v3(0.0f, 0.0f, 0.0f);
    if (!EXT || p.em_off < 0) return e;
    bool hit;
    float t0, distance;
    aabb_intersect(p.root_min, p.root_max, pos, dir, hit, t0, distance);
    distance = jmax(distance, 0.0f);
    float t = 0.0f;
    Key k = ks.at(0);
    for (int s = 0; s < p.max_steps; ++s) {
        ++c.n_steps;
        const Key k_next = ks.at(s + 1);
        const float u = uniform_at32(k, c.idx);
        t = t + -log1pf(-u) * p.rate_inv_emit;
        if (t >= distance) break;
        e = e + emission_sc<EXT, SC>(c, pos + dir * t);
        k = k_next;
    }
    return e;
}

// ---------------------------------------------------------- the lights --

// nee.estimate_sun: Tr * phase(cos) * sun_color * sun_mult, the shadow
// walk on ks
template <int SC>
__device__ V3 estimate_sun(const Ctx& c, const Steps& ks, V3 pos, V3 dir) {
    const WalkParams& p = c.p;
    const V3 wi = v3(p.sun_dir);
    const float ph = phase_eval(p, dot(dir, wi));
    const float tp = transmittance<SC>(c, ks, pos, wi) * ph;
    return v3(tp * p.sun_color[0] * p.sun_mult, tp * p.sun_color[1] * p.sun_mult,
              tp * p.sun_color[2] * p.sun_mult);
}

// nee.estimate_point_lights: min(L, 11) picks summed unnormalised
// (QUIRKS #3), the falloff after reference_falloff (QUIRKS #2); walk w's
// pick key in slot slot0 + 2 w, its shadow walk in block j0 + w
template <bool VOL, int SC>
__device__ V3 estimate_point_lights(const Ctx& c, int slot0, int j0, V3 pos,
                                    V3 dir) {
    const WalkParams& p = c.p;
    V3 total = v3(0.0f, 0.0f, 0.0f);
    for (int w = 0; w < p.n_pt_walks; ++w) {
        const float u = uniform_at32(key_at<VOL>(c, slot0 + 2 * w), c.idx);
        const int li = min((int)(u * (float)p.n_lights), p.n_lights - 1);
        const float* light = c.t.lights + 7 * li;
        const V3 lp = v3(light);
        const V3 wi = normalize(lp - pos);
        const float tr =
            transmittance<SC>(c, steps_of<VOL>(c, j0 + w), pos, wi);
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

// the same for each sky kind: under the Bruneton atmosphere
// (sky/runtime.py::sample_atmosphere_scene) the live model seen from the
// event's position pos, or the baked cache, each with the sun disc and
// the curve, as K4's kinds compute them (atmosphere.cuh)
template <int SKY>
__device__ __forceinline__ V3 env_light_at(const Ctx& c, V3 pos, V3 wi) {
    if constexpr (SKY == SKY_RUNTIME) {
        return env_light(c, wi);
    } else {
        ++c.n_sky;
        if constexpr (SKY == SKY_ATMOSPHERE)
            return sample_atmosphere(c.s->atm, pos, wi);
        else
            return sample_sky_cache(c.s->atm, wi);
    }
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

// nee.estimate_sky's strategy (a): a light sample (the CDF, or the
// uniform sphere) weighted against the phase pdf, with its shadow walk on
// split(key, 2); the draws on split(key, 0) (the slab's V_SKY_* slots)
template <int SC, int SKY>
__device__ V3 sky_light(const Ctx& c, V3 pos, V3 dir) {
    const WalkParams& p = c.p;
    const float u_a = uniform_at32(key_at<true>(c, V_SKY_U), c.idx);
    const float u_b = uniform_at32(key_at<true>(c, V_SKY_U + 1), c.idx);
    V3 wi;
    float light_pdf;
    if (p.use_cdf) {
        wi = sample_env_cdf(c, u_a, u_b, light_pdf);
    } else {
        const float phi = TWO_PI_F * u_a;
        const float ct = 1.0f - 2.0f * u_b;
        const float st = sqrtf(jmax(0.0f, 1.0f - ct * ct));
        wi = v3(cosf(phi) * st, sinf(phi) * st, ct);
        light_pdf = INV_4_PI_F;
    }
    V3 ld = v3(0.0f, 0.0f, 0.0f);
    const float phase_pdf = phase_eval(p, dot(dir, wi));
    if (light_pdf > 0.0f && phase_pdf > 0.0f) {
        const V3 li = env_light_at<SKY>(c, pos, wi);
        const float tr =
            transmittance<SC>(c, steps_of<true>(c, VJ_SKY_TR), pos, wi);
        const float w = power_heuristic(light_pdf, phase_pdf);
        ld = li * (tr * phase_pdf * w / jmax(light_pdf, 1e-20f));
    }
    return ld;
}

// nee.estimate_sky's strategy (b): a phase sample on split(key, 1)
// weighted against the light pdf, with its shadow walk on split(key, 3):
// whether it contributes, and what (xb)
template <int SC, int SKY>
__device__ bool sky_phase(const Ctx& c, V3 pos, V3 dir, V3& xb) {
    const WalkParams& p = c.p;
    float phase_pdf_b;
    const V3 wi_b =
        phase_sample(p, dir, hg_at<true>(c, V_SKY_HG), c.idx, phase_pdf_b);
    const float light_pdf_b = p.use_cdf ? pdf_env_cdf(c, wi_b) : INV_4_PI_F;
    xb = v3(0.0f, 0.0f, 0.0f);
    if (!(phase_pdf_b > 0.0f && light_pdf_b > 0.0f)) return false;
    const float w_b = power_heuristic(phase_pdf_b, light_pdf_b);
    const float tr_b =
        transmittance<SC>(c, steps_of<true>(c, VJ_SKY_TR + 1), pos, wi_b);
    xb = env_light_at<SKY>(c, pos, wi_b) * (tr_b * w_b);
    return true;
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

// stats[0..2] += a warp's bounces, walk steps and sky evaluations, and
// with N_STATS_STAGES counters stats[3 + stage] += its walk steps (every
// lane of the warp calls it)
__device__ __forceinline__ void add_stage_stats(unsigned long long* stats,
                                                int n_stats, int stage,
                                                unsigned bounces,
                                                unsigned steps,
                                                unsigned sky) {
    if (!stats) return;
    const unsigned b = __reduce_add_sync(FULL, bounces);
    const unsigned s = __reduce_add_sync(FULL, steps);
    const unsigned k = __reduce_add_sync(FULL, sky);
    if ((threadIdx.x & 31) == 0) {
        atomicAdd(stats, (unsigned long long)b);
        atomicAdd(stats + 1, (unsigned long long)s);
        atomicAdd(stats + 2, (unsigned long long)k);
        if (n_stats >= N_STATS_STAGES)
            atomicAdd(stats + N_STATS + stage, (unsigned long long)s);
    }
}

// ------------------------------------------------------ walk_direct --

// One bounce of integrator.direct_integrator's loop for a live ray: the
// closest object, the volume walks, the estimates at an event, the
// sphere.  False when the ray is done (it met nothing, or reached
// ray_depth).
template <bool EXT, int SC>
__device__ __forceinline__ bool direct_bounce(const Ctx& c, V3 org, V3& pos,
                                              V3& dir, V3& env_pos, V3& beta,
                                              V3& L, float& alpha,
                                              float& depth_aov, int& cost,
                                              int& depth) {
    const WalkParams& p = c.p;
    const int nv = p.volume_depth;
    float t_min;
    const int obj = closest_object(p, pos, dir, t_min);
    bool mi = false;
    if (obj == 1) {
        V3 pos_v = pos + dir * (t_min + EPS);
        for (int vd = 0; vd < (EXT ? nv : 1); ++vd) {
            const Track tr =
                delta_track<EXT, SC>(c, steps_of<false>(c, vd), pos_v, dir);
            beta = beta * tr.value;
            alpha = alpha + tr.alpha_add;
            cost += tr.steps;
            pos_v = tr.pos;
            mi = tr.interaction;
            if (!mi) break;
            float ph;
            dir = phase_sample(p, dir, hg_at<false>(c, nv + 4 * vd), c.idx,
                               ph);
        }
        pos = pos_v;
    }
    if (mi) {
        if (depth == 0) depth_aov = length(org - pos);
        L = L + estimate_sun<SC>(c, steps_of<false>(c, dj_sun(p)), pos,
                                 dir) *
                    beta;
        if (p.n_lights > 0)
            L = L + estimate_point_lights<false, SC>(c, 5 * nv + D_POINT,
                                                     nv + 1, pos, dir) *
                        beta;
        if (EXT && p.em_off >= 0)
            L = L + estimate_emission<EXT, SC>(
                        c, steps_of<false>(c, dj_emit(p)), pos, dir);
    }
    float t2;
    const int obj2 = closest_object(p, pos, dir, t2);
    if (obj2 == 2) {
        if (depth == 0 && !mi) depth_aov = t2;
        // integrator._shade_sphere on fold_in(kd, 5)
        const Key ks = key_at<false>(c, 5 * nv + D_SPH);
        const V3 hp = pos + dir * t2;
        const V3 normal = normalize((hp - v3(p.sph_center)) / p.sph_radius);
        const V3 nl = dot(normal, dir) < 0.0f ? normal : -normal;
        const float phi = TWO_PI_F * uniform_at32(ks, c.idx * 2u);
        const float r2 = uniform_at32(ks, c.idx * 2u + 1u);
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
        const float v_tr = transmittance<SC>(
            c, steps_of<false>(c, dj_sph(p)), new_pos, sun);
        const float k = v_tr * jmax(dot(sun, normal), 0.0f);
        L = L + v3(p.sun_color[0] * p.sun_mult * k,
                   p.sun_color[1] * p.sun_mult * k,
                   p.sun_color[2] * p.sun_mult * k) * beta;
        pos = new_pos;
        dir = mirror + (hemi - mirror) * p.sph_rough;
        env_pos = pos;
    }
    ++depth;
    return !(obj == 0 && obj2 != 2) && depth < p.ray_depth;
}

// integrator.direct_integrator on persistent warps: a lane runs one bounce
// of its ray per turn; once REFILL_MIN lanes are idle, one lane takes as
// many rays as lanes are idle from the counter (one atomicAdd, the base
// shuffled to the idle lanes, each taking the ray of its rank among them).
template <bool EXT, int SC>
__global__ void __launch_bounds__(THREADS, DIRECT_BLOCKS)
walk_direct_kernel(const __grid_constant__ WalkParams p,
                   const __grid_constant__ WalkEnv e,
                   const __grid_constant__ WalkTables t,
                   const float* __restrict__ origin,
                   const float* __restrict__ direction,
                   float* __restrict__ out, const Key* __restrict__ keys,
                   unsigned* __restrict__ next_ray,
                   unsigned long long* stats,
                   const __grid_constant__ WalkScene sc) {
    const int lane = threadIdx.x & 31;
    const long long S = ((long long)p.B + 3) & ~3LL;
    Ctx c{p, e, t, nullptr, Key{0u, 0u}, 0u, 0u, 0u, &sc};
    V3 org = v3(0.0f, 0.0f, 0.0f), pos = org, dir = org, env_pos = org,
       beta = org, L = org;
    float alpha = 0.0f, depth_aov = 0.0f;
    int cost = 0, depth = 0, r = 0, tile_i = 0;
    unsigned bounces = 0;
    bool live = false, dry = false;
    for (;;) {
        while (!dry) {
            const unsigned idle = __ballot_sync(FULL, !live);
            const int n = __popc(idle);
            if (n < REFILL_MIN) break;
            const int leader = __ffs(idle) - 1;
            unsigned base = 0u;
            if (lane == leader) base = atomicAdd(next_ray, (unsigned)n);
            base = __shfl_sync(FULL, base, leader);
            dry = (unsigned long long)base + n >= (unsigned long long)p.B;
            const unsigned slot = base + __popc(idle & ((1u << lane) - 1u));
            if (!live && slot < (unsigned)p.B) {
                r = (int)slot;
                tile_i = p.tile > 0 ? r / p.tile : 0;
                c.idx = (uint32_t)(p.tile > 0 ? r % p.tile : r);
                org = v3(origin + 3 * (long long)r);
                pos = org;
                env_pos = org;
                dir = v3(direction + 3 * (long long)r);
                beta = v3(1.0f, 1.0f, 1.0f);
                L = v3(0.0f, 0.0f, 0.0f);
                alpha = depth_aov = 0.0f;
                cost = depth = 0;
                live = p.ray_depth > 0;
                if (!live)
                    write_out(p, out, S, r, L, alpha, cost, depth_aov, beta,
                              dir, env_pos);
            }
        }
        if (!__any_sync(FULL, live)) break;
        if (live) {
            c.slab = slab_at(p, keys, tile_i, depth);
            if (!c.slab) c.kd = fold_in(tile_key(p, tile_i), (uint32_t)depth);
            live = direct_bounce<EXT, SC>(c, org, pos, dir, env_pos, beta,
                                          L, alpha, depth_aov, cost, depth);
            if (!live) {
                write_out(p, out, S, r, L, alpha, cost, depth_aov, beta, dir,
                          env_pos);
                bounces += (unsigned)depth;
            }
        }
    }
    add_stage_stats(stats, N_STATS, 0, bounces, c.n_steps, c.n_sky);
}

// --------------------------------------------------- walk_volumetric --

constexpr int PATH_WORDS = 6;   // PathState's 16-byte words

__device__ __forceinline__ const float4* path_words(const float* state,
                                                    int r) {
    return reinterpret_cast<const float4*>(state) + (long long)PATH_WORDS * r;
}

__device__ __forceinline__ void load_state(const float* state, int r, V3& pos,
                                           V3& dir, V3& beta, V3& L,
                                           float& alpha, float& depth_aov,
                                           int& cost, int& kind) {
    const float4* s = path_words(state, r);
    const float4 a = s[0], b = s[1], c = s[2], d = s[3];
    pos = v3(a.x, a.y, a.z);
    dir = v3(a.w, b.x, b.y);
    beta = v3(b.z, b.w, c.x);
    L = v3(c.y, c.z, c.w);
    alpha = d.x;
    depth_aov = d.y;
    cost = __float_as_int(d.z);
    kind = __float_as_int(d.w);
}

__device__ __forceinline__ void store_state(float* state, int r, V3 pos,
                                            V3 dir, V3 beta, V3 L,
                                            float alpha, float depth_aov,
                                            int cost, int kind) {
    float4* s = reinterpret_cast<float4*>(state) + (long long)PATH_WORDS * r;
    s[0] = make_float4(pos.x, pos.y, pos.z, dir.x);
    s[1] = make_float4(dir.y, dir.z, beta.x, beta.y);
    s[2] = make_float4(beta.z, L.x, L.y, L.z);
    s[3] = make_float4(alpha, depth_aov, __int_as_float(cost),
                       __int_as_float(kind));
}

// A path's end: its outputs, the environment looked up from the origin
// while |beta| > 0.9999, from the last position otherwise.
__device__ __forceinline__ void finish_path(const WalkParams& p, float* out,
                                            const float* origin, int r,
                                            V3 pos, V3 dir, V3 beta, V3 L,
                                            float alpha, float depth_aov,
                                            int cost) {
    const V3 org = v3(origin + 3 * (long long)r);
    const V3 env_from = length(beta) > 0.9999f ? org : pos;
    write_out(p, out, ((long long)p.B + 3) & ~3LL, r, L, alpha, cost,
              depth_aov, beta, dir, env_from);
}

// the next 32 entries of a stage's queue for a warp (warp-uniform)
__device__ __forceinline__ unsigned take32(unsigned* counter, int lane) {
    unsigned base = 0u;
    if (lane == 0) base = atomicAdd(counter, 32u);
    return __shfl_sync(FULL, base, 0);
}

// the length of a queue an earlier kernel filled
__device__ __forceinline__ unsigned queue_length(const unsigned* count) {
    return *const_cast<const volatile unsigned*>(count);
}

// ray r onto queue q where `want` (every lane of the warp calls it): one
// atomicAdd a warp, the lanes in lane order
__device__ __forceinline__ void push(int* q, unsigned* count, int r,
                                     bool want, int lane) {
    const unsigned m = __ballot_sync(FULL, want);
    if (!m) return;
    const int leader = __ffs(m) - 1;
    unsigned base = 0u;
    if (lane == leader) base = atomicAdd(count, (unsigned)__popc(m));
    base = __shfl_sync(FULL, base, leader);
    if (want) q[base + __popc(m & ((1u << lane) - 1u))] = r;
}

__device__ __forceinline__ Ctx path_ctx(const WalkParams& p, const WalkEnv& e,
                                        const WalkTables& t,
                                        const Key* keys, int r,
                                        const WalkScene& sc) {
    const int ti = p.tile > 0 ? r / p.tile : 0;
    return Ctx{p, e, t, keys + (long long)ti * slab_size(p), Key{0u, 0u},
               (uint32_t)(p.tile > 0 ? r % p.tile : r), 0u, 0u, &sc};
}

// the kinds of a path after EXTEND (what it is pushed onto)
constexpr int K_DONE = 0, K_SUN = 1, K_POINT = 2, K_SKY = 3, K_NONE = 4;

// EXTEND at bounce d: delta_track on fold_in(kd, 0) for each live path
// (at d 0 every ray from the root box's entry), beta, alpha and cost
// updated; a path whose beta is 0 or whose walk left the medium ends;
// otherwise the depth AOV at d 0 and uniform_sample_one_light's pick
// (fold_in(kl, 0)): the path goes onto the sun's, the point lights' or
// the sky's queue, or nowhere where its kind has nothing to estimate (no
// point light, a BLACK sky); and onto SCATTER's.
template <bool EXT, int SC>
__global__ void __launch_bounds__(THREADS, STAGE_BLOCKS)
walk_extend_kernel(const __grid_constant__ WalkParams p,
                   const __grid_constant__ WalkEnv e,
                   const __grid_constant__ WalkTables t,
                   const float* __restrict__ origin,
                   const float* __restrict__ direction,
                   float* __restrict__ out,
                   const __grid_constant__ WalkWork w, int d,
                   unsigned long long* stats, int n_stats,
                   const __grid_constant__ WalkScene sc) {
    const int lane = threadIdx.x & 31;
    unsigned* cnt = w.counts + (long long)d * N_COUNTS;
    const unsigned n = d == 0 ? (unsigned)p.B : queue_length(cnt + C_LIVE);
    const int* live_q = w.queue + (long long)(Q_LIVE + (d & 1)) * p.B;
    unsigned bounces = 0, steps = 0;
    for (;;) {
        const unsigned base = take32(cnt + W_EXTEND, lane);
        if (base >= n) break;
        const unsigned i = base + lane;
        int r = -1, kind = K_DONE;
        if (i < n) {
            r = d == 0 ? (int)i : live_q[i];
            Ctx c = path_ctx(p, e, t, table(w), r, sc);
            V3 pos, dir, beta, L;
            float alpha, depth_aov;
            int cost;
            bool go = true;
            if (d == 0) {
                const V3 org = v3(origin + 3 * (long long)r);
                dir = v3(direction + 3 * (long long)r);
                bool hit;
                float t_entry, tmax;
                aabb_intersect(p.root_min, p.root_max, org, dir, hit,
                               t_entry, tmax);
                pos = hit ? org + dir * (t_entry + EPS) : org;
                beta = v3(1.0f, 1.0f, 1.0f);
                L = v3(0.0f, 0.0f, 0.0f);
                alpha = depth_aov = 0.0f;
                cost = 0;
                go = hit && p.ray_depth > 0;
            } else {
                int kind_was;
                load_state(w.state, r, pos, dir, beta, L, alpha, depth_aov,
                           cost, kind_was);
            }
            if (go) {
                const Track tr = delta_track<EXT, SC>(
                    c, steps_of<true>(c, VJ_WALK), pos, dir);
                beta = beta * tr.value;
                alpha = alpha + tr.alpha_add;
                cost += tr.steps;
                pos = tr.pos;
                go = !(beta.x == 0.0f && beta.y == 0.0f && beta.z == 0.0f) &&
                     tr.interaction;
            }
            if (!go) {
                finish_path(p, out, origin, r, pos, dir, beta, L, alpha,
                            depth_aov, cost);
                bounces += (unsigned)d;
            } else {
                if (d == 0)
                    depth_aov = length(v3(origin + 3 * (long long)r) - pos);
                const int pick =
                    (int)(uniform_at32(key_at<true>(c, V_PICK), c.idx) * 3.0f);
                kind = pick == 0   ? K_SUN
                       : pick == 1 ? (p.n_lights > 0 ? K_POINT : K_NONE)
                                   : (p.nee_env != NEE_BLACK ? K_SKY : K_NONE);
                store_state(w.state, r, pos, dir, beta, L, alpha, depth_aov,
                            cost, kind);
            }
            steps += c.n_steps;
        }
        push(w.queue + (long long)Q_SUN * p.B, cnt + C_SUN, r, kind == K_SUN,
             lane);
        push(w.queue + (long long)Q_POINT * p.B, cnt + C_POINT, r,
             kind == K_POINT, lane);
        push(w.queue + (long long)Q_SKY * p.B, cnt + C_SKY, r, kind == K_SKY,
             lane);
        push(w.queue + (long long)Q_SCATTER * p.B, cnt + C_SCATTER, r,
             kind != K_DONE, lane);
    }
    add_stage_stats(stats, n_stats, 0, bounces, steps, 0u);
}

// NEE at bounce d, one kernel for every kind: each warp takes 32 paths at
// a time from the sky's light samples, then its phase samples, then the
// sun's queue, then the point lights' (the longest work first, so the
// kinds' tails overlap), each lane the estimate of its path's kind: the
// sun on fold_in(kl, 1), the point lights on fold_in(kl, 2), the sky's
// two strategies on fold_in(kl, 3) apart (sky_light, sky_phase).  It
// writes the estimate into the path state; SCATTER adds it to L.
constexpr int N_NEE_LISTS = 4;

template <int SC, int SKY>
__global__ void __launch_bounds__(THREADS, STAGE_BLOCKS)
walk_nee_kernel(const __grid_constant__ WalkParams p,
                const __grid_constant__ WalkEnv e,
                const __grid_constant__ WalkTables t,
                const __grid_constant__ WalkWork w, int d,
                unsigned long long* stats, int n_stats,
                const __grid_constant__ WalkScene sc) {
    const int lane = threadIdx.x & 31;
    unsigned* cnt = w.counts + (long long)d * N_COUNTS;
    // (queue, its length's counter, the list's work counter, stats stage)
    const int q_of[N_NEE_LISTS] = {Q_SKY, Q_SKY, Q_SUN, Q_POINT};
    const int c_of[N_NEE_LISTS] = {C_SKY, C_SKY, C_SUN, C_POINT};
    const int w_of[N_NEE_LISTS] = {W_SKY, W_SKY_B, W_SUN, W_POINT};
    unsigned steps[3] = {0u, 0u, 0u}, sky = 0;
    for (int list = 0; list < N_NEE_LISTS;) {
        const unsigned n = queue_length(cnt + c_of[list]);
        const unsigned base = take32(cnt + w_of[list], lane);
        if (base >= n) {
            ++list;
            continue;
        }
        const unsigned i = base + lane;
        if (i < n) {
        const int r = w.queue[(long long)q_of[list] * p.B + i];
        const Ctx c = path_ctx(p, e, t, table(w), r, sc);
        const float4* sw = path_words(w.state, r);
        const float4 a = sw[0], b = sw[1];
        const V3 pos = v3(a.x, a.y, a.z), dir = v3(a.w, b.x, b.y);
        float* out = w.state + 4LL * PATH_WORDS * r + 16;
        if (list == 1) {
            V3 xb;
            const bool has_b = sky_phase<SC, SKY>(c, pos, dir, xb);
            out[3] = xb.x;
            out[4] = xb.y;
            out[5] = xb.z;
            out[6] = has_b ? 1.0f : 0.0f;
        } else {
            const V3 ld =
                list == 0 ? sky_light<SC, SKY>(c, pos, dir)
                : list == 2
                    ? estimate_sun<SC>(c, steps_of<true>(c, VJ_SUN), pos, dir)
                    : estimate_point_lights<true, SC>(c, V_POINT, VJ_POINT,
                                                      pos, dir);
            out[0] = ld.x;
            out[1] = ld.y;
            out[2] = ld.z;
        }
        steps[list < 2 ? 2 : list - 2] += c.n_steps;
        sky += c.n_sky;
        }
    }
    add_stage_stats(stats, n_stats, K_SUN, 0u, steps[0], 0u);
    add_stage_stats(stats, n_stats, K_POINT, 0u, steps[1], 0u);
    add_stage_stats(stats, n_stats, K_SKY, 0u, steps[2], sky);
}

// SCATTER at bounce d on every path that met the medium: NEE's estimate
// added to L, the emission walk on fold_in(kd, 2) (EXT with emission), the
// phase sample on fold_in(kd, 3); a path at ray_depth ends, the others go
// onto bounce d + 1's queue.
template <bool EXT, int SC>
__global__ void __launch_bounds__(THREADS, STAGE_BLOCKS)
walk_scatter_kernel(const __grid_constant__ WalkParams p,
                    const __grid_constant__ WalkEnv e,
                    const __grid_constant__ WalkTables t,
                    const float* __restrict__ origin, float* __restrict__ out,
                    const __grid_constant__ WalkWork w, int d,
                    unsigned long long* stats, int n_stats,
                    const __grid_constant__ WalkScene sc) {
    const int lane = threadIdx.x & 31;
    unsigned* cnt = w.counts + (long long)d * N_COUNTS;
    const unsigned n = queue_length(cnt + C_SCATTER);
    const int* q = w.queue + (long long)Q_SCATTER * p.B;
    const bool last = d + 1 >= p.ray_depth;
    int* next_q = w.queue + (long long)(Q_LIVE + ((d + 1) & 1)) * p.B;
    unsigned* next_cnt = cnt + N_COUNTS + C_LIVE;
    unsigned bounces = 0, steps = 0;
    for (;;) {
        const unsigned base = take32(cnt + W_SCATTER, lane);
        if (base >= n) break;
        const unsigned i = base + lane;
        int r = -1;
        if (i < n) {
            r = q[i];
            const Ctx c = path_ctx(p, e, t, table(w), r, sc);
            V3 pos, dir, beta, L;
            float alpha, depth_aov;
            int cost;
            int kind;
            load_state(w.state, r, pos, dir, beta, L, alpha, depth_aov, cost,
                       kind);
            // NEE's estimate: L + beta * (ld * 3) (0 for a kind with
            // nothing to estimate), then the emission
            const float4* sw = path_words(w.state, r);
            const float4 e4 = sw[4], f4 = sw[5];
            V3 ld = v3(0.0f, 0.0f, 0.0f);
            if (kind == K_SKY) {
                ld = v3(e4.x, e4.y, e4.z);
                if (f4.z != 0.0f) ld = ld + v3(e4.w, f4.x, f4.y);
                ld = ld * p.sky_mult;
            } else if (kind != K_NONE) {
                ld = v3(e4.x, e4.y, e4.z);
            }
            L = L + beta * (ld * 3.0f);
            if (EXT && p.em_off >= 0)
                L = L + estimate_emission<EXT, SC>(
                            c, steps_of<true>(c, vj_emit(p)), pos, dir);
            float ph;
            dir = phase_sample(p, dir, hg_at<true>(c, V_SCATTER_HG), c.idx,
                               ph);
            if (last) {
                finish_path(p, out, origin, r, pos, dir, beta, L, alpha,
                            depth_aov, cost);
                bounces += (unsigned)(d + 1);
            } else {
                store_state(w.state, r, pos, dir, beta, L, alpha, depth_aov,
                            cost, K_DONE);
            }
            steps += c.n_steps;
        }
        push(next_q, next_cnt, r, r >= 0 && !last, lane);
    }
    add_stage_stats(stats, n_stats, 4, bounces, steps, 0u);
}


// The scene kind of SCATTER's instance: SCATTER reads the scene only in
// the EXT emission walk, so without EXT every kind runs SC_F32's, and
// SC_F32_OCT, whose emission is SC_F32's, runs SC_F32's with EXT too.
template <bool EXT, int SC>
constexpr int scatter_sc() {
    return (!EXT || SC == SC_F32_OCT) ? SC_F32 : SC;
}

}  // namespace

// The addresses of one launch's kernels (their host stubs, which
// cudaLaunchKernel takes): walk_direct's, and walk_volumetric's stages;
// null where the source that fills them leaves the kernel to walk.cu
// (walk_keys always, SCATTER of scatter_sc SC_F32, and every kernel but
// NEE of SC_F32 under the Bruneton sky kinds).
struct WalkKernels {
    const void *direct, *extend, *nee, *scatter;
};

namespace {

// The kernels of scene kind SC and sky kind SKY, each instantiated where
// this is called (walk.cu: SC_F32 under SKY_RUNTIME).
template <int SC, int SKY>
WalkKernels kernels_of(bool ext) {
    WalkKernels k{};
    k.direct = ext ? (const void*)walk_direct_kernel<true, SC>
                   : (const void*)walk_direct_kernel<false, SC>;
    k.extend = ext ? (const void*)walk_extend_kernel<true, SC>
                   : (const void*)walk_extend_kernel<false, SC>;
    k.nee = (const void*)walk_nee_kernel<SC, SKY>;
    if constexpr (scatter_sc<true, SC>() == SC) {
        if (ext) k.scatter = (const void*)walk_scatter_kernel<true, SC>;
    }
    if constexpr (SC == SC_F32) {
        if (!ext) k.scatter = (const void*)walk_scatter_kernel<false, SC>;
    }
    return k;
}

// The kernels of scene kind SC (not SC_F32) under sky kind `sky`: every
// kernel of SKY_RUNTIME, NEE of the Bruneton kind
template <int SC>
WalkKernels kernels_of_sky(int sky, bool ext) {
    static_assert(SC != SC_F32, "SC_F32 under a Bruneton kind: NEE alone");
    WalkKernels k = kernels_of<SC, SKY_RUNTIME>(ext);
    if (sky == SKY_ATMOSPHERE)
        k.nee = (const void*)walk_nee_kernel<SC, SKY_ATMOSPHERE>;
    else if (sky == SKY_CACHE)
        k.nee = (const void*)walk_nee_kernel<SC, SKY_CACHE>;
    return k;
}

}  // namespace

// walk_rows.cu: SC_F32_OCT and SC_BF16 under every sky kind, and SC_F32's
// NEE under the Bruneton ones
WalkKernels walk_kernels_rows(int sc, int sky, bool ext);
// walk_cells.cu: SC_CELLS and SC_LOOP under every sky kind
WalkKernels walk_kernels_cells(int sc, int sky, bool ext);
