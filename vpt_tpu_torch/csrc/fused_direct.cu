// K1 — the fused walk: persistent warps, one ray per lane, each lane
// refilled with a new ray when its own ends.
//
// Replaces: vpt_tpu/render/fused.py::fused_direct (Q = 1, single
// instance) with vpt_tpu/render/tracking.py::_unified_fetch_single
// inlined as fetch_row; on its in-kernel-ray route also K2's
// renderer.py::_pixel_jitter + camera.py::Camera.get_rays (raygen.cuh).
// Its plain PyTorch version is
// vpt_tpu_torch/render/fused.py::fused_direct_plain.
//
// What bounds it on the H100: each walk step is one dependent load of a
// 60-124 byte corner row at a data-dependent address (the next step's
// position depends on this row's density and box extents), and the rays
// of one warp take different numbers of steps (a mean of 5.7 in cached
// mode, up to the step cap) and different phases (divergence).
//
// What the design does about it:
// - the 23-entry walk state lives in registers for the whole walk, so a
//   step costs one row load and no other memory traffic; the row loads
//   only the columns the step needs (15, plus the taus on accepted
//   events in cached mode; in the EXT variant the 8 emission columns on
//   EMIT steps and the 24 color columns on accepted events); the draws
//   are computed in the lane from their counters, never loaded;
// - persistent warps: the grid is SMs x resident blocks per SM (asked of
//   the runtime once per library load).  When at least refill_min lanes
//   of a warp are idle, one lane takes as many slots as lanes are idle
//   from a global counter (one atomicAdd; the base is shuffled to the
//   idle lanes, each taking the slot of its rank among them), so lanes
//   do not sit idle while the warp's longest ray runs; slots may walk
//   the frame in small tiles, so a warp's rays are neighbours.  Every draw is a function of (key, ray
//   index, the ray's own step), so any schedule writes the same bits as
//   the reference's Q = 1 loop, where a DONE lane is never modified.
//   The schedule per shadow mode (render/fused.py::SCHEDULE) and the
//   resident blocks (5: 96 registers, no spills, where 4 leaves warps
//   short and 6 spills) were chosen by timing on the H100 (PERF.md);
// - the per-launch keys (fold_in(key, s) for each step s, its HG
//   subkeys, and the pre-loop seek key) are computed once per block
//   into shared memory, not by every step of every lane;
// - on the in-kernel-ray route a lane generates its own primary ray, so
//   the sample writes and reads no ray buffer.
//
// CELLS (a template argument): instanced scenes with per-cell instance
// lists (vpt_tpu/render/tracking.py::_cells_banded_fetch, the cells
// branches of fused.py::fused_direct).  A step loads its majorant cell
// row (accel/majorant.py: T_box, the box extents, the 72 octant columns,
// the K instance ids, the folded taus): the box exit, widened on an empty
// cell by the anchored box of the ray's octant and major axis (3 floats
// of the 72); then, for each listed instance, its instance row (the 19
// floats of the world->index transform, bbox, dim and atlas offset,
// through the read-only path) and its 8 corner taps, the densities added
// in slot order.  In cached mode the taus come from the same cell row, at
// the cell's (R+1)^3 corner lattice.  What bounds it: the dependent cell
// row, then 1 + K dependent loads per step; a simple kernel that is right
// (the 1024 x 96 B instance rows stay in global memory and L1/L2, not
// staged in shared memory).  Its arguments are a struct of their own
// after ExtParams, so the variants without CELLS compile as before.
// LOOP (a template argument of the CELLS instances): an instanced scene of
// at most
// instance_list_threshold instances, without lists (CellParams::loop;
// vpt_tpu/render/tracking.py::scene_density's static loop, accel/
// majorant.py::local_majorant_query): the cell table is the majorant
// grid's packed rows (T_box, the box extents, the octant columns where
// `octant`), and the slots are every instance 0 ... k-1 in order.  Its
// cached taus come from one row of the world tau grid at an accepted
// event (accel/shadow.py::world_tau_fetch), 8 (1 + L) floats at the
// grid's node lattice, in place of the cell row's.  A template argument,
// not a run-time mode, and fetch_cells keeps its slot body written out:
// as a run-time mode with that body in a function of its own the
// density-only CELLS instances went from 91-93 registers to 96 with 2-14
// B of spills; as now they keep 91-93 and none (PERF.md).
// CELLS with EXT (6 instances, 6 more with LOOP): an instanced scene's
// emission, color or
// volume_depth > 1.  An EMIT sample adds the emission LUT's row of each
// slot's emission taps, over the slots whose grid has the channel and
// holds the point (tracking.py::scene_emission); Cd is the component-wise
// max over the slots from 0, white for a slot whose grid has no color
// channel wherever it is listed (scene_color).  Both read the slots of the
// cell that the reference's lookup picks, (pos - root) / extent * R,
// which may be the next cell at a boundary; both run only where needed
// (an EMIT sample, an accepted event), each slot's rows loaded again.  An
// EMIT walk jumps no empty cell there: the cell bounds come from the
// density alone.
//
// EXT (a template argument): scenes with an emission or a color channel,
// or volume_depth > 1.  The emission walk (EMIT) follows a medium event
// along its scattered direction and adds the emission LUT's row of each
// sample (unscaled by beta, QUIRKS #5/#21); Cd scales the collision
// weight; an event before the walk's volume_depth-th scatters and
// restarts MARCH with no NEE.  Density-only scenes at volume_depth 1 run
// the variants without EXT, which compile none of that code.
//
// Row (a template argument, float or __nv_bfloat16): the corner rows'
// element type.  Every read of a row goes through ld(), the one typed
// load, which widens a 16-bit element with __bfloat162float; the walk's
// arithmetic stays float32, as the reference reads its bfloat16 rows
// (vpt_tpu/render/tracking.py:445, astype(float32) after the gather).
// OCT (a template argument): the row carries the 72 per-(octant x
// major-axis) anchored extents in cols 15:87 where the launch says so
// (CellParams::octant), and an empty box's exit is widened by the box of
// the ray's octant and major axis, the CELLS branch's arithmetic in the
// grid's index space (vpt_tpu/render/tracking.py:502-513).  ROWS_* below
// says which instances a launch's rows take.  A simple kernel that is
// right: one 2-byte load per column read, no vector row loads.
//
// The step budget is max_steps steps per ray: max_fused_steps, or 16
// times that where the reference queues 16 rays per lane
// (render/params.py::resolve_queue); the keys of the first key_steps
// steps (at most KEY_CACHE) are cached, later steps fold their key in
// the lane.  With `queued` a ray still walking at the end is written as
// the reference's unretired queue slot.  With `defer_env` (HDRI, the
// simple sky, the Bruneton atmosphere) each ray's beta and direction go
// beside its outputs for K4 (csrc/environment.cu), which adds the
// environment after this kernel; BLACK and CONSTANT are added here.
// defer_env 2 (the live Bruneton atmosphere, which reads where a ray
// retired) also writes the ray's env_pos, as the reference's loop keeps
// it (vpt_tpu/render/fused.py:293, :361, :730): the ray's origin, moved
// to the sphere's anchor by a sphere event and by nothing else (a volume
// scatter leaves it), the primary origin for a queued ray that is cut.

#include <cuda_bf16.h>

#include "raygen.cuh"

using namespace vpt;

namespace {

constexpr int P_SEEK = 0, P_MARCH = 1, P_SHADOW = 2, P_EMIT = 3, P_DONE = 4;
constexpr int AS_SUN = 0, AS_PT = 1, AS_SPHERE = 2;
constexpr uint32_t SEEK_FOLD = 1u << 20, HG_FOLD = 7u;
constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 128;
// __launch_bounds__' resident blocks per SM: 96 registers, no spills
constexpr int MIN_BLOCKS = 5;
constexpr int KEY_CACHE = 1024;   // steps whose keys live in shared memory
constexpr int KEYS_PER_STEP = 5;  // fold_in(key, s) and 4 HG subkeys
// The corner rows of a launch (vpt_tpu_torch/ops/cuda.py::row_kind) and
// the instances each takes (launch_rows, rows_info): ROWS_F32 those
// without OCT, which compile as before; ROWS_F32_OCTANT the float32 OCT
// ones; ROWS_BF16 and ROWS_BF16_OCTANT both the bfloat16 OCT ones, which
// a single grid's launch tells apart at run time by CellParams::octant
// (its only field such a launch sets), so that bfloat16 rows cost one
// set of instances and not two.
constexpr int ROWS_F32 = 0, ROWS_F32_OCTANT = 1, ROWS_BF16 = 2,
              ROWS_BF16_OCTANT = 3;

// Mirror of vpt_tpu_torch/render/fused.py::_FusedParams (all 4-byte
// fields, same order).
struct FusedParams {
    int B, max_steps, ray_depth, n_lights, n_pt_walks, cached;
    int reference_falloff, use_double_hg, env_constant, row_w, tau_off,
        grid_off, refill_min, tile_w, tile_h, frame_w;
    int dim[3];
    unsigned key[2];
    float sigma_max, sigma_c, sigma_r, inv_rate_march, rate_inv_shadow,
        density_mult, tr_depth, pt_w, emission_pivot, energy_inject, g1, g2,
        phase_f, sph_radius, sph_rough;
    float albedo[3], ext[3], sun_dir[3], sun_cs[3], sky[3], root_min[3],
        root_max[3], walk_min[3], walk_max[3], gbmin[3], gdim[3],
        sph_center[3], sph_color[3];
    float inv_xf[12];
    int sph_enabled;
    int key_steps, queued, defer_env;
};

// What only the EXT variant reads: the emission and color columns (-1:
// absent), the walk's volume_depth, and the emission walk's constants.
// A kernel argument of its own, after the others, so that the
// density-only variants take their arguments where they did before EXT
// (appended to FusedParams they moved RaygenParams to an 8-byte boundary,
// which changed the in-kernel-ray route's SASS).  Mirror of
// vpt_tpu_torch/render/fused.py::_ExtParams.
struct ExtParams {
    int em_off, col_off, volume_depth;
    float emission_scale, rate_inv_emit;
};

// What only the CELLS variant reads: the cell rows (R^3, row_w) and the
// instance rows (N, 24), the cell grid's resolution, the cell rows'
// columns (the ids at ids_off, K of them; the octant columns at 7 where
// `octant`), and the cell size per axis; in loop mode the packed rows in
// place of the cell rows, K the instance count, and the world tau grid.
// Its taus sit at FusedParams::tau_off of the cell row (0 in loop mode,
// of the world tau grid's row).  Mirror of
// vpt_tpu_torch/render/fused.py::_CellParams.  A single grid's OCT
// instances read `octant` alone (ROWS_*).
struct CellParams {
    const float *rows;
    const float *inst;
    // loop mode with cached shadows: the world tau grid's rows
    // (nz * ny * nx, 8 (1 + L)), its dims and its cell; else null
    const float *wtau;
    int R, row_w, ids_off, k, octant;
    int loop;  // the slots are every instance 0 ... k-1 (no lists)
    int wdim[3];
    float cs[3];
    float wcell;
};

// The variant a launch needs: EXT for emission, color or volume_depth > 1.
inline bool extended(const ExtParams& x) {
    return x.em_off >= 0 || x.col_off >= 0 || x.volume_depth > 1;
}

template <typename Row>
struct Ctx {
    const FusedParams& p;
    const ExtParams& x;
    const Row* __restrict__ corners;
    const float* __restrict__ lights;  // (L, 7): pos, color, power
    // (512, 3): the density color LUT, then the emission LUT
    const float* __restrict__ lut;
};

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
__device__ __forceinline__ bool sphere_block(const FusedParams& p, V3 pos,
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

__device__ __forceinline__ float hg(float c, float g) {
    const float denom = 1.0f + g * g - 2.0f * g * c;
    return 0.785398185253143310546875f * (1.0f - g * g) /
           (denom * sqrtf(jmax(denom, 1e-20f)));
}

__device__ __forceinline__ float phase_eval(const FusedParams& p, float c) {
    if (p.use_double_hg)
        return p.phase_f * hg(c, p.g1) + (1.0f - p.phase_f) * hg(c, p.g2);
    return hg(c, p.g1);
}

// The subkeys phase_sample draws from at step key ks:
// split(fold_in(ks, 7)) for one HG lobe; for two, split of each half.
__device__ __forceinline__ void hg_keys(Key ks, bool two_lobes,
                                        Key (&hk)[4]) {
    const Key kh = fold_in(ks, HG_FOLD);
    if (two_lobes) {
        const Key k1 = split_at(kh, 0), k2 = split_at(kh, 1);
        hk[0] = split_at(k1, 0);
        hk[1] = split_at(k1, 1);
        hk[2] = split_at(k2, 0);
        hk[3] = split_at(k2, 1);
    } else {
        hk[0] = split_at(kh, 0);
        hk[1] = split_at(kh, 1);
        hk[2] = hk[3] = Key{0u, 0u};
    }
}

// core/phase.py::sample_hg, direction only; element `ray` of the draws
// from split(key) = (ka, kb).
__device__ V3 sample_hg(V3 wo, Key ka, Key kb, float g,
                        unsigned long long ray) {
    const float u1 = uniform_at(ka, ray);
    const float sqr_term = (1.0f - g * g) / (1.0f - g + 2.0f * g * u1);
    const float cos_aniso = (1.0f + g * g - sqr_term * sqr_term) /
                            (2.0f * (fabsf(g) < 1e-6f ? 1.0f : g));
    const float ct = fabsf(g) < EPS ? 1.0f - 2.0f * u1 : cos_aniso;
    const float st = sqrtf(jmax(1.0f - ct * ct, 0.0f));
    const float phi = TWO_PI_F * uniform_at(kb, ray);
    // coordinate_system(-wo)
    const V3 v1 = -wo;
    const bool cond = fabsf(v1.x) > fabsf(v1.y);
    V3 v2 = cond ? v3(-v1.z, 0.0f, v1.x) : v3(0.0f, v1.z, -v1.y);
    v2 = normalize(v2);
    const V3 v3_ = normalize(cross(v1, v2));
    return v2 * st * cosf(phi) + v3_ * st * sinf(phi) + wo * ct;
}

// core/phase.py::phase_sample at the step's HG subkeys (hg_keys).
__device__ V3 phase_sample(const FusedParams& p, V3 dir, const Key (&hk)[4],
                           unsigned long long ray) {
    if (!p.use_double_hg) return sample_hg(dir, hk[0], hk[1], p.g1, ray);
    // sample_double_hg(-dir): wo = dir, lobes from split(key)
    const V3 d1 = sample_hg(dir, hk[0], hk[1], p.g1, ray);
    const V3 d2 = sample_hg(dir, hk[2], hk[3], p.g2, ray);
    if (p.phase_f > 0.9999f) return d1;
    if (p.phase_f < EPS) return d2;
    return normalize(d1 + (d2 - d1) * (1.0f - p.phase_f));
}

// A corner row's element as a float: the one typed load of the rows.
__device__ __forceinline__ float ld(const float* q) { return *q; }
__device__ __forceinline__ float ld(const __nv_bfloat16* q) {
    return __bfloat162float(*q);
}

template <typename Row>
struct Fetch {
    float density, s_box, t_box;
    bool inb;        // the point lies in the grid
    const Row* row;  // the corner row, for the taus of an accepted event
    V3 fr;  // the point's fractions in its cell, for the 8 weights
};

// The trilinear weight of corner k (x fastest), as _trilerp_weights.
template <typename F>
__device__ __forceinline__ float corner_weight(const F& f, int k) {
    const float wx = (k & 1) ? f.fr.x : 1.0f - f.fr.x;
    const float wy = (k & 2) ? f.fr.y : 1.0f - f.fr.y;
    const float wz = (k & 4) ? f.fr.z : 1.0f - f.fr.z;
    return wx * wy * wz;
}

// The trilinear sum of the 8 taps at f.row + off, left to right (taps
// `stride` apart: 1, or 3 for a color channel).
template <typename Row>
__device__ __forceinline__ float taps_at(const Fetch<Row>& f, int off,
                                         int stride = 1) {
    const Row* tr = f.row + off;
    float s = ld(tr) * corner_weight(f, 0);
#pragma unroll
    for (int k = 1; k < 8; ++k)
        s = s + ld(tr + k * stride) * corner_weight(f, k);
    return s;
}

// Trilinear tau of channel ch (0 = sun, 1 + l = point light l).
template <typename Row>
__device__ __forceinline__ float tau_at(const FusedParams& p,
                                        const Fetch<Row>& f, int ch) {
    const Row* tr = f.row + p.tau_off + 8 * ch;
    float s = ld(tr) * corner_weight(f, 0);
#pragma unroll
    for (int k = 1; k < 8; ++k) s = s + ld(tr + k) * corner_weight(f, k);
    return s;
}

// tracking._emission_lut of this row's emission: the LUT row at the
// truncated index (QUIRKS #15) x emission_scale, 0 outside the grid.
template <typename Row>
__device__ __forceinline__ V3 emission_at(const Ctx<Row>& c,
                                          const Fetch<Row>& f) {
    if (!f.inb) return v3(0.0f, 0.0f, 0.0f);
    const float li =
        jclamp(taps_at(f, c.x.em_off) * 255.0f / c.p.emission_pivot, 0.0f,
               255.0f);
    const float* e = c.lut + 768 + 3 * (int)li;
    const float k = c.x.emission_scale;
    return v3(e[0] * k, e[1] * k, e[2] * k);
}

// render/tracking.py::_unified_fetch_single (banded, full): one corner
// row serves density, the banded bound and its box exit (with OCT and the
// launch's octant columns, widened on an empty box by the octant box's),
// and the taus.
template <bool OCT, typename Row>
__device__ void fetch_row(const Ctx<Row>& c, const CellParams& cp, V3 pos,
                          V3 dir, Fetch<Row>& f) {
    const FusedParams& p = c.p;
    const float* m = p.inv_xf;
    const V3 ipos = v3(pos.x * m[0] + pos.y * m[3] + pos.z * m[6] + m[9],
                       pos.x * m[1] + pos.y * m[4] + pos.z * m[7] + m[10],
                       pos.x * m[2] + pos.y * m[5] + pos.z * m[8] + m[11]);
    const V3 idir = v3(dir.x * m[0] + dir.y * m[3] + dir.z * m[6],
                       dir.x * m[1] + dir.y * m[4] + dir.z * m[7],
                       dir.x * m[2] + dir.y * m[5] + dir.z * m[8]);
    const V3 bmin = v3(p.gbmin), dimf = v3(p.gdim);
    const V3 npos = (ipos - bmin) / dimf;
    const bool inb = npos.x >= 0.0f && npos.x <= 1.0f && npos.y >= 0.0f &&
                     npos.y <= 1.0f && npos.z >= 0.0f && npos.z <= 1.0f;
    const V3 x_u = npos * dimf - v3(0.5f, 0.5f, 0.5f);
    const V3 x = v3(jmin(jmax(x_u.x, 0.0f), dimf.x - 1.0f),
                    jmin(jmax(x_u.y, 0.0f), dimf.y - 1.0f),
                    jmin(jmax(x_u.z, 0.0f), dimf.z - 1.0f));
    const V3 i0f = v3(floorf(x.x), floorf(x.y), floorf(x.z));
    const V3 fr = x - i0f;
    const long long flat =
        p.grid_off +
        ((long long)(int)i0f.z * p.dim[1] + (int)i0f.y) * p.dim[0] +
        (int)i0f.x;
    const Row* row = c.corners + flat * p.row_w;
    f.fr = fr;
    f.row = row;
    f.inb = inb;
    float d = ld(row) * corner_weight(f, 0);
#pragma unroll
    for (int k = 1; k < 8; ++k) d = d + ld(row + k) * corner_weight(f, k);
    f.density = inb ? d : 0.0f;
    const float t_box = ld(row + 8);
    const V3 cube_min =
        i0f - v3(jmax(ld(row + 9), 0.0f), jmax(ld(row + 10), 0.0f),
                 jmax(ld(row + 11), 0.0f));
    const V3 cube_max = i0f + v3(1.0f, 1.0f, 1.0f) +
                        v3(jmax(ld(row + 12), 0.0f), jmax(ld(row + 13), 0.0f),
                           jmax(ld(row + 14), 0.0f));
    const V3 sd = v3(fabsf(idir.x) < 1e-12f ? 1e-12f : idir.x,
                     fabsf(idir.y) < 1e-12f ? 1e-12f : idir.y,
                     fabsf(idir.z) < 1e-12f ? 1e-12f : idir.z);
    const V3 t1 = (cube_min - x_u) / sd;
    const V3 t2 = (cube_max - x_u) / sd;
    float t_exit = jmin(jmin(jmax(t1.x, t2.x), jmax(t1.y, t2.y)),
                        jmax(t1.z, t2.z));
    if (OCT && cp.octant && t_box <= 0.0f) {
        // accel/majorant.py::octant_exit in index space (i0f, x_u, idir):
        // the box of the ray's octant and major axis, 3 of the 72 columns
        const float ax = fabsf(idir.x), ay = fabsf(idir.y), az = fabsf(idir.z);
        const int oct =
            (idir.x > 0.0f) + 2 * (idir.y > 0.0f) + 4 * (idir.z > 0.0f);
        const int major = az > jmax(ax, ay) ? 2 : (ay > ax ? 1 : 0);
        const Row* e = row + 15 + 9 * oct + 3 * major;
        const float d3[3] = {idir.x, idir.y, idir.z};
        const float r3[3] = {x_u.x, x_u.y, x_u.z};
        const float c3[3] = {i0f.x, i0f.y, i0f.z};
        float t_oct = 0.0f;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const float ea = jmax(ld(e + a), 0.0f);
            const float face = d3[a] > 0.0f ? c3[a] + 1.0f + ea : c3[a] - ea;
            const float ta =
                fabsf(d3[a]) < 1e-12f ? 3.4e38f : (face - r3[a]) / d3[a];
            t_oct = a == 0 ? ta : jmin(t_oct, ta);
        }
        t_exit = jmax(t_exit, t_oct);
    }
    const V3 t1b = (bmin - ipos) / sd;
    const V3 t2b = (bmin + dimf - ipos) / sd;
    float t_entry = jmax(jmax(jmin(t1b.x, t2b.x), jmin(t1b.y, t2b.y)),
                         jmin(t1b.z, t2b.z));
    const float t_leave = jmin(jmin(jmax(t1b.x, t2b.x), jmax(t1b.y, t2b.y)),
                               jmax(t1b.z, t2b.z));
    const bool misses = (t_leave < jmax(t_entry, 0.0f)) || (t_leave <= 0.0f);
    t_entry = misses ? 1e30f : jmax(t_entry, 0.0f);
    f.s_box = inb ? jmax(t_exit, 0.0f) : jmax(t_entry, 0.0f);
    f.t_box = inb ? t_box : 0.0f;
}

// One instance's corner row at world pos (tracking._row_norm_coords):
// false outside its grid; else g's row and fractions for its taps.
template <typename Row>
__device__ __forceinline__ bool instance_row(const Ctx<Row>& c,
                                             const CellParams& cp, int id,
                                             V3 pos, Fetch<Row>& g) {
    const float* ir = cp.inst + 24LL * id;
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
    g.row = c.corners + flat * c.p.row_w;
    return true;
}

// render/tracking.py::_cells_banded_fetch (banded, with the taus' weights):
// the cell row gives T_box and the box exit (the octant box's on an empty
// cell), each listed instance its density, and the Fetch's row and
// fractions address the taus of an accepted event (tau_at).
template <bool LOOP, typename Row>
__device__ void fetch_cells(const Ctx<Row>& c, const CellParams& cp, V3 pos,
                            V3 dir, Fetch<Row>& f) {
    const FusedParams& p = c.p;
    const V3 root = v3(p.root_min), cs = v3(cp.cs);
    const V3 rel = (pos - root) / cs;
    const int R1 = cp.R - 1;
    const int cx = min(max((int)floorf(rel.x), 0), R1);
    const int cy = min(max((int)floorf(rel.y), 0), R1);
    const int cz = min(max((int)floorf(rel.z), 0), R1);
    const float* row =
        cp.rows + (((long long)cz * cp.R + cy) * cp.R + cx) * cp.row_w;
    const V3 cif = v3((float)cx, (float)cy, (float)cz);
    const float t_box = row[0];
    const V3 cube_min =
        root + (cif - v3(jmax(row[1], 0.0f), jmax(row[2], 0.0f),
                         jmax(row[3], 0.0f))) * cs;
    const V3 cube_max =
        root + (cif + v3(1.0f, 1.0f, 1.0f) +
                v3(jmax(row[4], 0.0f), jmax(row[5], 0.0f),
                   jmax(row[6], 0.0f))) * cs;
    const V3 inv = v3(1.0f / (fabsf(dir.x) < 1e-12f ? 1e-12f : dir.x),
                      1.0f / (fabsf(dir.y) < 1e-12f ? 1e-12f : dir.y),
                      1.0f / (fabsf(dir.z) < 1e-12f ? 1e-12f : dir.z));
    const V3 t1 = (cube_min - pos) * inv;
    const V3 t2 = (cube_max - pos) * inv;
    float s_box = jmax(jmin(jmin(jmax(t1.x, t2.x), jmax(t1.y, t2.y)),
                            jmax(t1.z, t2.z)), 0.0f);
    if (cp.octant && t_box <= 0.0f) {
        // accel/majorant.py::octant_exit: the box of the ray's octant
        // (dvec > 0 per axis) and major axis (the largest |dvec|, a tie
        // to the lower axis), 3 of the 72 columns
        const V3 dv = dir / cs;
        const float ax = fabsf(dv.x), ay = fabsf(dv.y), az = fabsf(dv.z);
        const int oct = (dv.x > 0.0f) + 2 * (dv.y > 0.0f) + 4 * (dv.z > 0.0f);
        const int major = az > jmax(ax, ay) ? 2 : (ay > ax ? 1 : 0);
        const float* e = row + 7 + 9 * oct + 3 * major;
        const float d3[3] = {dv.x, dv.y, dv.z};
        const float r3[3] = {rel.x, rel.y, rel.z};
        const float c3[3] = {cif.x, cif.y, cif.z};
        float t_oct = 0.0f;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const float ea = jmax(e[a], 0.0f);
            const float face = d3[a] > 0.0f ? c3[a] + 1.0f + ea : c3[a] - ea;
            const float ta =
                fabsf(d3[a]) < 1e-12f ? 3.4e38f : (face - r3[a]) / d3[a];
            t_oct = a == 0 ? ta : jmin(t_oct, ta);
        }
        s_box = jmax(s_box, jmax(t_oct, 0.0f));
    }
    float d = 0.0f;
    for (int j = 0; j < cp.k; ++j) {
        const int id = LOOP ? j : (int)row[cp.ids_off + j];
        if (id < 0) break;  // the valid ids fill the first slots
        // instance_row's body, written out: called here it took the
        // density-only CELLS instances from 91-93 registers to 96 (the
        // header)
        const float* ir = cp.inst + 24LL * id;
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
            continue;  // 0 outside its grid
        const V3 xu = npos * dimf - v3(0.5f, 0.5f, 0.5f);
        const V3 x = v3(jmin(jmax(xu.x, 0.0f), dimf.x - 1.0f),
                        jmin(jmax(xu.y, 0.0f), dimf.y - 1.0f),
                        jmin(jmax(xu.z, 0.0f), dimf.z - 1.0f));
        const V3 i0 = v3(floorf(x.x), floorf(x.y), floorf(x.z));
        const long long flat =
            (long long)m[18] +
            ((long long)(int)i0.z * (int)dimf.y + (int)i0.y) * (int)dimf.x +
            (int)i0.x;
        Fetch<Row> g;
        g.fr = x - i0;
        const Row* taps = c.corners + flat * p.row_w;
        float v = ld(taps) * corner_weight(g, 0);
#pragma unroll
        for (int q = 1; q < 8; ++q) v = v + ld(taps + q) * corner_weight(g, q);
        d = d + v;
    }
    f.density = d;
    f.s_box = s_box;
    f.t_box = t_box;
    f.inb = true;
    f.row = row;
    f.fr = v3(jclamp(rel.x - cif.x, 0.0f, 1.0f),
              jclamp(rel.y - cif.y, 0.0f, 1.0f),
              jclamp(rel.z - cif.z, 0.0f, 1.0f));
}

// The ids of the slots that the reference's emission and color lookups
// read at pos (tracking._cell_flat_index: (pos - root) / extent * R): the
// cell row's ids columns; null in loop mode, whose slots are 0 ... k-1.
__device__ __forceinline__ const float* list_ids(const FusedParams& p,
                                                 const CellParams& cp,
                                                 V3 pos) {
    if (cp.loop) return nullptr;
    const V3 root = v3(p.root_min);
    const V3 rel = (pos - root) / (v3(p.root_max) - root) * (float)cp.R;
    const int R1 = cp.R - 1;
    const int cx = min(max((int)floorf(rel.x), 0), R1);
    const int cy = min(max((int)floorf(rel.y), 0), R1);
    const int cz = min(max((int)floorf(rel.z), 0), R1);
    return cp.rows + (((long long)cz * cp.R + cy) * cp.R + cx) * cp.row_w +
           cp.ids_off;
}

// tracking.scene_emission: the emission LUT's row x emission_scale of
// each slot's trilinear emission, summed in slot order over the slots
// whose grid has the channel and holds pos.
template <typename Row>
__device__ V3 slots_emission(const Ctx<Row>& c, const CellParams& cp,
                             V3 pos) {
    const float* ids = list_ids(c.p, cp, pos);
    V3 e = v3(0.0f, 0.0f, 0.0f);
    for (int j = 0; j < cp.k; ++j) {
        const int id = ids ? (int)ids[j] : j;
        if (id < 0) break;
        Fetch<Row> g;
        if (__ldg(cp.inst + 24LL * id + 19) < 0.0f ||
            !instance_row(c, cp, id, pos, g))
            continue;
        const float li = jclamp(
            taps_at(g, c.x.em_off) * 255.0f / c.p.emission_pivot, 0.0f,
            255.0f);
        const float* r = c.lut + 768 + 3 * (int)li;
        const float k = c.x.emission_scale;
        e = e + v3(r[0] * k, r[1] * k, r[2] * k);
    }
    return e;
}

// tracking.scene_color: the component-wise max from 0 of each slot's Cd:
// its trilinear color, 0 outside its grid, white where its grid has no
// color channel.
template <typename Row>
__device__ V3 slots_color(const Ctx<Row>& c, const CellParams& cp, V3 pos) {
    const float* ids = list_ids(c.p, cp, pos);
    V3 cd = v3(0.0f, 0.0f, 0.0f);
    for (int j = 0; j < cp.k; ++j) {
        const int id = ids ? (int)ids[j] : j;
        if (id < 0) break;
        V3 v = v3(1.0f, 1.0f, 1.0f);
        if (__ldg(cp.inst + 24LL * id + 20) >= 0.0f) {
            Fetch<Row> g;
            v = instance_row(c, cp, id, pos, g)
                    ? v3(taps_at(g, c.x.col_off, 3),
                         taps_at(g, c.x.col_off + 1, 3),
                         taps_at(g, c.x.col_off + 2, 3))
                    : v3(0.0f, 0.0f, 0.0f);
        }
        cd = v3(jmax(cd.x, v.x), jmax(cd.y, v.y), jmax(cd.z, v.z));
    }
    return cd;
}

// accel/shadow.py::world_tau_fetch: f's row and fractions become those of
// the world tau grid's node cell at pos, for tau_at (FusedParams::tau_off
// 0 in loop mode).
__device__ __forceinline__ void world_tau_row(const CellParams& cp,
                                              const FusedParams& p, V3 pos,
                                              Fetch<float>& f) {
    const V3 x = (pos - v3(p.root_min)) / cp.wcell - v3(0.5f, 0.5f, 0.5f);
    const V3 xc =
        v3(jmin(jmax(x.x, 0.0f), (float)cp.wdim[0] - 1.0f),
           jmin(jmax(x.y, 0.0f), (float)cp.wdim[1] - 1.0f),
           jmin(jmax(x.z, 0.0f), (float)cp.wdim[2] - 1.0f));
    const V3 i0 = v3(floorf(xc.x), floorf(xc.y), floorf(xc.z));
    const long long flat =
        ((long long)(int)i0.z * cp.wdim[1] + (int)i0.y) * cp.wdim[0] +
        (int)i0.x;
    f.row = cp.wtau + flat * 8 * (1 + p.n_lights);
    f.fr = xc - i0;
}

struct Walk {
    V3 pos, dirn, anchor, sdir, beta, L, contrib;
    V3 env_pos;  // DEFER 2: where the environment is looked up from
    float alpha, tr, dist, t, skip, tbox, depth_aov;
    int phase, ascode, nshadow, depth_n, cost;
    int vd;  // EXT: the medium events of this walk so far
};

// fused._march_init's walk length: the walk box's exit along dir from
// pos, or the sphere's hit where it comes first.  (seek() keeps its own
// copy, and tau_at its own loop beside taps_at: calling these helpers
// there changed the density-only variants' SASS.)
__device__ __forceinline__ float march_dist(const FusedParams& p, V3 pos,
                                            V3 dir) {
    bool hw;
    float t_in, t_out;
    aabb_intersect(p.walk_min, p.walk_max, pos, dir, hw, t_in, t_out);
    const float t_box = hw ? jmax(t_out, 0.0f) : 0.0f;
    float t_sph;
    const bool sph_hit = sphere_block(p, pos, dir, t_sph);
    return (sph_hit && t_sph < t_box) ? t_sph : t_box;
}

// fused._shadow_init: push outside starts to the root box, sphere hit
// -> black (QUIRKS #7), control-variate T_c premultiplied.
__device__ __forceinline__ void shadow_init(const FusedParams& p, V3 start,
                                            V3 w, Walk& s) {
    const bool inside = aabb_contains(p.root_min, p.root_max, start);
    bool hit;
    float t_entry, tmax;
    aabb_intersect(p.root_min, p.root_max, start, w, hit, t_entry, tmax);
    const bool miss = !inside && !hit;
    const V3 spos = (!inside && hit) ? start + w * (t_entry + EPS) : start;
    bool h2;
    float t2, dist;
    aabb_intersect(p.root_min, p.root_max, spos, w, h2, t2, dist);
    dist = jmax(dist, 0.0f);
    float ts;
    const bool sph_hit = sphere_block(p, spos, w, ts);
    float tr0 = expf(-p.sigma_c * dist);
    tr0 = miss ? 1.0f : (sph_hit ? 0.0f : tr0);
    s.pos = spos;
    s.dirn = w;
    s.dist = (miss || sph_hit) ? 0.0f : dist;
    s.tr = tr0;
    s.t = 0.0f;
    s.skip = 0.0f;
    s.tbox = 0.0f;
}

__device__ __forceinline__ float cached_tr(const FusedParams& p, float tau,
                                           V3 point, V3 w) {
    bool hit;
    float tmin, d;
    aabb_intersect(p.root_min, p.root_max, point, w, hit, tmin, d);
    d = jmax(d, 0.0f);
    float ts;
    const bool occ = sphere_block(p, point, w, ts);
    const float tr = expf(-p.sigma_c * d - (tau - p.sigma_c * d) / p.tr_depth);
    return occ ? 0.0f : jclamp(tr, 0.0f, 1.0f);
}

__device__ __forceinline__ V3 point_contrib(const FusedParams& p,
                                            const float* light, V3 from,
                                            V3 sdir, float weight, V3& wi) {
    const V3 lp = v3(light);
    wi = normalize(lp - from);
    const float cos_pt = dot(sdir, wi);
    float sqr;
    if (p.reference_falloff)  // QUIRKS #2
        sqr = length(lp * lp - from * from);
    else
        sqr = dot(lp - from, lp - from);
    const float falloff = 1.0f / jmax(sqr, 1e-12f);
    float sc = light[6] * phase_eval(p, cos_pt) * falloff;
    if (weight != 1.0f) sc = sc * weight;
    return v3(light + 3) * sc;
}

// fused.seek_block for one SEEK ray.
template <bool EXT, typename C>
__device__ void seek(const C& c, Walk& s, Key ks,
                     unsigned long long ray) {
    const FusedParams& p = c.p;
    bool hit1;
    float t1, tmax1;
    aabb_intersect(p.root_min, p.root_max, s.pos, s.dirn, hit1, t1, tmax1);
    float t2;
    const bool hit2 = sphere_block(p, s.pos, s.dirn, t2);
    const V3 entry = s.pos + s.dirn * (t1 + EPS);
    // fused._march_init at the entry point
    bool hw;
    float t_in, t_out;
    aabb_intersect(p.walk_min, p.walk_max, entry, s.dirn, hw, t_in, t_out);
    const float t_box = hw ? jmax(t_out, 0.0f) : 0.0f;
    const bool inside = aabb_contains(p.walk_min, p.walk_max, entry);
    float skip0 = (hw && !inside) ? jmax(t_in, 0.0f) : 0.0f;
    float t_sph;
    const bool sph_hit = sphere_block(p, entry, s.dirn, t_sph);
    const bool lim = sph_hit && (t_sph < t_box);
    const float m_dist = lim ? t_sph : t_box;
    skip0 = jmin(skip0, m_dist);

    const bool hit1_eff = hit1 && (m_dist > 0.0f);
    const int obj = (hit1_eff && (!hit2 || (t1 < t2))) ? 1 : (hit2 ? 2 : 0);
    if (obj == 0 || s.depth_n >= p.ray_depth) {
        s.phase = P_DONE;
        return;
    }
    s.depth_n += 1;
    if (obj == 1) {
        s.pos = entry;
        s.dist = m_dist;
        s.t = 0.0f;
        s.skip = skip0;
        s.tbox = 0.0f;
        s.phase = P_MARCH;
        if (EXT) s.vd = 0;
        return;
    }
    // sphere shading (render_kernel.cu:1807-1834), then its sun walk
    const V3 hp = s.pos + s.dirn * t2;
    const V3 normal = normalize((hp - v3(p.sph_center)) / p.sph_radius);
    const V3 nl = dot(normal, s.dirn) < 0.0f ? normal : -normal;
    const float phi = TWO_PI_F * uniform_at(ks, ray * 5 + 2);
    const float r2 = uniform_at(ks, ray * 5 + 3);
    const float r2s = sqrtf(r2);
    const V3 w = normalize(nl);
    const V3 ref_axis = fabsf(w.x) > 0.1f ? v3(0.0f, 1.0f, 0.0f)
                                          : v3(1.0f, 0.0f, 0.0f);
    const V3 uax = normalize(cross(ref_axis, w));
    const V3 vax = cross(w, uax);
    const V3 hemi = normalize(uax * (cosf(phi) * r2s) +
                              vax * (sinf(phi) * r2s) +
                              w * sqrtf(jmax(1.0f - r2, 0.0f)));
    const V3 mirror = reflect(s.dirn, nl);
    const V3 new_dir = mirror + (hemi - mirror) * p.sph_rough;
    const V3 anchor = hp + normal * EPS;
    const V3 sun = v3(p.sun_dir);
    if (s.depth_aov == 0.0f) s.depth_aov = t2;
    s.anchor = anchor;
    s.sdir = new_dir;
    s.beta = s.beta * v3(p.sph_color);
    s.contrib = v3(p.sun_cs) * jmax(dot(sun, normal), 0.0f);
    shadow_init(p, anchor, sun, s);
    s.ascode = AS_SPHERE;
    s.phase = P_SHADOW;
}

__device__ __forceinline__ void resume(const FusedParams& p, Walk& s) {
    float ts;
    const bool ahead = sphere_block(p, s.anchor, s.sdir, ts);
    s.pos = s.anchor;
    s.dirn = s.sdir;
    s.phase = ahead ? P_SEEK : P_DONE;
}

// The end of a medium event's light estimates: the emission walk from the
// event along its scattered direction, on an emissive scene; else resume.
template <bool EXT, typename C>
__device__ __forceinline__ void after_event(const C& c, Walk& s) {
    const FusedParams& p = c.p;
    if (!(EXT && c.x.em_off >= 0)) {
        resume(p, s);
        return;
    }
    bool hit;
    float tmin, tmax;
    aabb_intersect(p.walk_min, p.walk_max, s.anchor, s.sdir, hit, tmin, tmax);
    s.pos = s.anchor;
    s.dirn = s.sdir;
    s.dist = jmax(tmax, 0.0f);
    s.t = s.skip = s.tbox = 0.0f;
    s.phase = P_EMIT;
}

__device__ __forceinline__ void init_walk(Walk& s, V3 org, V3 dir) {
    s.pos = org;
    s.dirn = dir;
    s.anchor = org;
    s.sdir = dir;
    s.beta = v3(1.0f, 1.0f, 1.0f);
    s.L = v3(0.0f, 0.0f, 0.0f);
    s.contrib = v3(0.0f, 0.0f, 0.0f);
    s.alpha = 0.0f;
    s.tr = 1.0f;
    s.dist = s.t = s.skip = s.tbox = s.depth_aov = 0.0f;
    s.phase = P_SEEK;
    s.ascode = s.nshadow = s.depth_n = s.cost = s.vd = 0;
}

// One step of one ray's walk at step key ks: the body of the reference's
// loop at Q = 1 for one lane.  `org` is the ray's origin (shared memory,
// components THREADS apart); `hk_cached` holds the step's HG subkeys
// (shared memory), or is null past the key cache.  ENVPOS: a sphere event
// moves env_pos to the sphere's anchor (seek's only way to P_SHADOW).
template <bool EXT, bool CELLS, bool ENVPOS, typename Row, bool OCT,
          bool LOOP>
__device__ __forceinline__ void walk_step(const Ctx<Row>& c,
                                          const CellParams& cp,
                                          Walk& s, const float* org, Key ks,
                                          const Key* hk_cached,
                                          unsigned long long ray) {
    const FusedParams& p = c.p;
    if (s.phase == P_SEEK) {
        seek<EXT>(c, s, ks, ray);
        if (ENVPOS && s.phase == P_SHADOW) s.env_pos = s.anchor;
    }
    if (s.phase == P_DONE) return;
    const V3 sun = v3(p.sun_dir);
    const bool marching = s.phase == P_MARCH;
    const bool emitting = EXT && s.phase == P_EMIT;
    const bool shadowing = !marching && !emitting;  // P_SHADOW

    // banded free flight: local bound inside the box, global rate past
    // it; SHADOW and EMIT jump guaranteed-empty boxes (the zero band is
    // emission-free too: volume/grid.py::_corner_pack)
    const float u0 = uniform_at(ks, ray * 5 + 0);
    const float u1 = uniform_at(ks, ray * 5 + 1);
    const float u4 = uniform_at(ks, ray * 5 + 4);
    const float rate_inv =
        marching ? p.inv_rate_march
                 : (emitting ? c.x.rate_inv_emit : p.rate_inv_shadow);
    const float e_glob = -log1pf(-u0) * rate_inv;
    const float e_loc = -log1pf(-u4) / jmax(s.tbox * p.density_mult, 1e-12f);
    const bool in_box = marching && (s.tbox > 0.0f) && (e_loc <= s.skip);
    // an instanced scene's EMIT walk jumps no empty box
    const bool jumps = !(CELLS && emitting);
    const float dt =
        marching ? (in_box ? e_loc : s.skip + e_glob)
                 : ((jumps && s.tbox <= 0.0f ? s.skip : 0.0f) + e_glob);
    const float t_new = s.t + dt;
    const bool exited = t_new >= s.dist;
    const V3 cursor = s.pos + s.dirn * t_new;

    Fetch<Row> f;
    if constexpr (CELLS)
        fetch_cells<LOOP>(c, cp, cursor, s.dirn, f);
    else
        fetch_row<OCT>(c, cp, cursor, s.dirn, f);
    const float t_old = s.tbox;
    s.skip = exited ? 0.0f : f.s_box;
    s.tbox = exited ? 0.0f : f.t_box;
    if (!exited) s.t = t_new;
    const bool sampled = !exited;
    const bool covers = sampled && (f.t_box <= 0.0f) && (f.s_box > 0.0f) &&
                        (t_new + f.s_box >= s.dist);

    // MARCH: thin at the bound the event was drawn at; trapezoid alpha
    // importance-corrected by sigma_max / bound
    const float bound = in_box ? t_old : p.sigma_max;
    const bool m_sampled = sampled && marching;
    if (m_sampled) s.alpha = s.alpha + f.density * (p.sigma_max / bound);
    const bool accept = m_sampled && (f.density / bound > u1);

    // SHADOW: residual ratio factor
    if (sampled && shadowing)
        s.tr = s.tr * (1.0f - (f.density - p.sigma_c) / p.sigma_r);
    const bool tr_dead = shadowing && (fabsf(s.tr) < EPS);
    s.cost += 1;

    if (emitting) {
        if constexpr (CELLS) {
            if (sampled) s.L = s.L + slots_emission(c, cp, cursor);
            if (exited) resume(p, s);
        } else {
            if (sampled) s.L = s.L + emission_at(c, f);
            // the walk's end: out of the box, or an empty box covers the
            // rest
            if (exited || covers) resume(p, s);
        }
        return;
    }
    if (accept) {
        const float li = jclamp(
            f.density / p.sigma_max * 255.0f / p.emission_pivot, 0.0f,
            255.0f);
        const float* lrow = c.lut + 3 * (int)li;
        // Cd, the row's trilinear color (an accepted event lies in the
        // grid); white without a color channel
        V3 cd = v3(1.0f, 1.0f, 1.0f);
        if (EXT && c.x.col_off >= 0) {
            if constexpr (CELLS)
                cd = slots_color(c, cp, cursor);
            else
                cd = v3(taps_at(f, c.x.col_off, 3),
                        taps_at(f, c.x.col_off + 1, 3),
                        taps_at(f, c.x.col_off + 2, 3));
        }
        const V3 coll =
            v3(p.albedo[0] * cd.x * lrow[0] / p.ext[0] * p.energy_inject,
               p.albedo[1] * cd.y * lrow[1] / p.ext[1] * p.energy_inject,
               p.albedo[2] * cd.z * lrow[2] / p.ext[2] * p.energy_inject);
        s.beta = s.beta * coll;
        Key hk[4];
        if (hk_cached) {
#pragma unroll
            for (int t = 0; t < 4; ++t) hk[t] = hk_cached[t];
        } else {
            hg_keys(ks, p.use_double_hg, hk);
        }
        const V3 hg_dir = phase_sample(p, s.dirn, hk, ray);
        s.anchor = cursor;
        s.sdir = hg_dir;
        if (s.depth_aov == 0.0f)
            s.depth_aov =
                length(cursor - v3(org[0], org[THREADS], org[2 * THREADS]));
        if (EXT && s.vd < c.x.volume_depth - 1) {
            // an event before the walk's last: scatter and march on from
            // the collision, with no NEE
            s.dist = march_dist(p, cursor, hg_dir);
            s.pos = cursor;
            s.dirn = hg_dir;
            s.t = s.skip = s.tbox = 0.0f;
            s.vd += 1;
            return;
        }
        const V3 sun_contrib =
            v3(p.sun_cs) * phase_eval(p, dot(s.sdir, sun));
        if (p.cached) {
            // the whole NEE from the cached taus of this row, or of the
            // world tau grid's in loop mode
            if constexpr (LOOP) {
                if (cp.wtau) world_tau_row(cp, p, cursor, f);
            }
            V3 nee =
                sun_contrib * cached_tr(p, tau_at(p, f, 0), cursor, sun);
            for (int l = 0; l < p.n_lights; ++l) {
                V3 wi;
                const V3 pc = point_contrib(p, c.lights + 7 * l, cursor,
                                            s.sdir, p.pt_w, wi);
                nee = nee + pc * cached_tr(p, tau_at(p, f, 1 + l), cursor,
                                           wi);
            }
            s.L = s.L + nee * s.beta;
            after_event<EXT>(c, s);
        } else {
            s.nshadow = p.n_pt_walks;
            shadow_init(p, s.anchor, sun, s);
            s.contrib = sun_contrib;
            s.ascode = AS_SUN;
            s.phase = P_SHADOW;
        }
        return;
    }
    if (marching) {
        // primary walk exit without interaction: DONE unless the sphere
        // lies ahead (QUIRKS #19: the box is never re-entered)
        if (exited || covers) {
            const V3 exit_pos = s.pos + s.dirn * s.t;
            float ts;
            const bool ahead = sphere_block(p, exit_pos, s.dirn, ts);
            s.pos = exit_pos;
            s.phase = ahead ? P_SEEK : P_DONE;
        }
        return;
    }
    // SHADOW walk end
    if (exited || tr_dead || covers) {
        s.L = s.L + s.contrib * jclamp(s.tr, 0.0f, 1.0f) * s.beta;
        if (s.nshadow > 0 && p.n_lights > 0) {
            // chain into the next point-light walk, light from u[:, 2]
            const float u2 = uniform_at(ks, ray * 5 + 2);
            const int idx =
                min((int)(u2 * (float)p.n_lights), p.n_lights - 1);
            V3 wi;
            const V3 pc = point_contrib(p, c.lights + 7 * idx, s.anchor,
                                        s.sdir, 1.0f, wi);
            shadow_init(p, s.anchor, wi, s);
            s.contrib = pc;
            s.nshadow -= 1;
            s.ascode = AS_PT;
        } else if (s.ascode != AS_SPHERE) {
            after_event<EXT>(c, s);
        } else {
            s.pos = s.anchor;
            s.dirn = s.sdir;
            s.phase = P_SEEK;
        }
    }
}

// K1's outputs, one float buffer of 7 S, S = B rounded up to a multiple
// of 4: L (B, 3) at 0, alpha at 3 S, cost at 4 S, unfinished at 5 S,
// depth at 6 S, so that each field starts 16-byte aligned for K3; with
// defer_env 13 S, beta (B, 3) at 7 S and the direction (B, 3) at 10 S;
// with defer_env 2 16 S, env_pos (B, 3) at 13 S.
struct Out {
    float* base;
    long long S;
};

// DEFER (= p.defer_env): beta and the direction go to K4, which adds the
// environment, and with DEFER 2 env_pos; else BLACK or CONSTANT is added
// here.  `dir0` and `org0` are the ray's primary direction and origin
// (shared memory, components THREADS apart), read with DEFER for a
// queued ray that is cut.
template <int DEFER>
__device__ __forceinline__ void write_out(const FusedParams& p,
                                          const Walk& s, Out o,
                                          long long i, const float* dir0,
                                          const float* org0) {
    if (p.queued && s.phase != P_DONE) {
        // a queued ray still walking: the reference's unretired slot, its
        // environment term on beta 0 in its primary direction
        const V3 zero = v3(0.0f, 0.0f, 0.0f);
        V3 L = zero;
        if (!DEFER)
            L = L + (p.env_constant ? v3(p.sky) : zero) * zero;
        o.base[3 * i + 0] = L.x;
        o.base[3 * i + 1] = L.y;
        o.base[3 * i + 2] = L.z;
        o.base[3 * o.S + i] = 0.0f;
        o.base[4 * o.S + i] = 0.0f;
        o.base[5 * o.S + i] = 1.0f;
        o.base[6 * o.S + i] = 0.0f;
        if (DEFER) {
            float* b = o.base + 7 * o.S + 3 * i;
            float* w = o.base + 10 * o.S + 3 * i;
            b[0] = b[1] = b[2] = 0.0f;
            w[0] = dir0[0];
            w[1] = dir0[THREADS];
            w[2] = dir0[2 * THREADS];
        }
        if (DEFER == 2) {
            float* e = o.base + 13 * o.S + 3 * i;
            e[0] = org0[0];
            e[1] = org0[THREADS];
            e[2] = org0[2 * THREADS];
        }
        return;
    }
    V3 L = s.L;
    if (!DEFER) {
        if (p.env_constant)
            L = L + v3(p.sky) * s.beta;
        else  // 0 * beta, as the reference
            L = L + v3(0.0f, 0.0f, 0.0f) * s.beta;
    }
    o.base[3 * i + 0] = L.x;
    o.base[3 * i + 1] = L.y;
    o.base[3 * i + 2] = L.z;
    o.base[3 * o.S + i] = jmin(s.alpha, 1.0f);
    o.base[4 * o.S + i] = (float)s.cost;
    o.base[5 * o.S + i] = s.phase != P_DONE ? 1.0f : 0.0f;
    o.base[6 * o.S + i] = s.depth_aov;
    if (DEFER) {
        float* b = o.base + 7 * o.S + 3 * i;
        float* w = o.base + 10 * o.S + 3 * i;
        b[0] = s.beta.x;
        b[1] = s.beta.y;
        b[2] = s.beta.z;
        w[0] = s.dirn.x;
        w[1] = s.dirn.y;
        w[2] = s.dirn.z;
    }
    if (DEFER == 2) {
        float* e = o.base + 13 * o.S + 3 * i;
        e[0] = s.env_pos.x;
        e[1] = s.env_pos.y;
        e[2] = s.env_pos.z;
    }
}

// The ray of schedule slot `slot`, or -1 for a slot outside the frame.
// With tile_w = 0 slots are rays in index order; otherwise the rays are
// a frame of frame_w columns and the slots walk it tile by tile
// (tile_w x tile_h rays, tiles in row order), so rays taken together
// are neighbours on the frame.
__device__ __forceinline__ int slot_ray(const FusedParams& p,
                                        unsigned slot) {
    if (p.tile_w == 0) return slot < (unsigned)p.B ? (int)slot : -1;
    const unsigned tw = p.tile_w, per = tw * p.tile_h;
    const unsigned t = slot / per, j = slot - t * per;
    const unsigned fw = p.frame_w, tiles_x = (fw + tw - 1) / tw;
    const unsigned x = (t % tiles_x) * tw + j % tw;
    const unsigned y = (t / tiles_x) * p.tile_h + j / tw;
    const unsigned long long r = (unsigned long long)y * fw + x;
    return (x < fw && r < (unsigned long long)p.B) ? (int)r : -1;
}

// The number of schedule slots: B, or whole tiles over the frame.
long long slot_count(const FusedParams& p) {
    if (p.tile_w == 0) return p.B;
    const long long rows = (p.B + p.frame_w - 1) / p.frame_w;
    const long long tiles_x = (p.frame_w + p.tile_w - 1) / p.tile_w;
    const long long tiles_y = (rows + p.tile_h - 1) / p.tile_h;
    return tiles_x * tiles_y * p.tile_w * p.tile_h;
}

// RAYS_IN_KERNEL: each ray from primary_ray(rp, index, true) (raygen.cuh),
// else from the (B, 3) origin and direction buffers.  The lens draws are
// taken at every aperture here: skipping them at aperture 0, as K2 does,
// measured the cached 1080p main path 8-9% slower on the H100 (at run
// time on a lens flag and as a compile-time constant alike;
// PERF.md, Findings).  DEFER = p.defer_env (0, 1, 2) is
// a template argument so that BLACK and CONSTANT compile without K4's
// extra outputs, and HDRI and the sky without env_pos: with one shared write path the cached 1080p main
// path measured 1.5% slower on the H100.  The queued cut's writes sit in
// write_out's own branch; resetting the walk state in the loop instead
// measured cached +1.6% and tracked -1.3% against this, and an
// out-of-line writer +45% (PERF.md, Findings).
template <bool RAYS_IN_KERNEL, int DEFER, bool EXT, bool CELLS,
          typename Row = float, bool OCT = false, bool LOOP = false>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fused_direct_kernel(const FusedParams p, const RaygenParams rp,
                    const float* __restrict__ origin,
                    const float* __restrict__ direction,
                    const Row* __restrict__ corners,
                    const float* __restrict__ lights,
                    const float* __restrict__ lut, const Out out,
                    unsigned* __restrict__ next_ray, unsigned n_slots,
                    const ExtParams x, const CellParams cp) {
    // the launch's keys, once per block: [0] the pre-loop seek key
    // fold_in(key, 1 << 20); then, for each step s < n_keys,
    // fold_in(key, s) and its four HG subkeys
    extern __shared__ Key skeys[];
    const Key key{p.key[0], p.key[1]};
    const int n_keys =
        max(0, min(min(p.key_steps, p.max_steps), KEY_CACHE));
    for (int j = threadIdx.x; j <= n_keys; j += blockDim.x) {
        if (j == n_keys) {
            skeys[0] = fold_in(key, SEEK_FOLD);
        } else {
            Key* e = skeys + 1 + KEYS_PER_STEP * j;
            e[0] = fold_in(key, (uint32_t)j);
            Key hk[4];
            hg_keys(e[0], p.use_double_hg, hk);
#pragma unroll
            for (int t = 0; t < 4; ++t) e[1 + t] = hk[t];
        }
    }
    __syncthreads();

    const Ctx<Row> c{p, x, corners, lights, lut};
    const Key k_seek = skeys[0];
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    // each lane's ray origin, read once per ray (the depth AOV), and,
    // where a cut ray hands K4 its primary direction, that direction
    // (dynamic shared memory after the keys, only then)
    __shared__ float s_org[3 * THREADS];
    float* org = s_org + threadIdx.x;
    const bool keep_dir = DEFER && p.queued;
    float* dir0 =
        reinterpret_cast<float*>(skeys + 1 + KEYS_PER_STEP * n_keys) +
        threadIdx.x;
    Walk s;
    int ray = 0, step = 0;
    bool live = false;
    // `dry` (warp-uniform) once the counter has passed the last slot
    bool dry = false;
    for (;;) {
        // refill: while at least refill_min lanes are idle and slots
        // remain, the idle lanes take the next slots in lane order; a ray
        // that needs no step is written at once
        while (!dry) {
            const unsigned idle = __ballot_sync(FULL, !live);
            const int n = __popc(idle);
            if (n < p.refill_min) break;
            const int leader = __ffs(idle) - 1;
            unsigned base = 0u;
            if (lane == leader) base = atomicAdd(next_ray, (unsigned)n);
            base = __shfl_sync(FULL, base, leader);
            dry = (unsigned long long)base + n >= n_slots;
            const unsigned slot = base + __popc(idle & below);
            const int r = slot < n_slots ? slot_ray(p, slot) : -1;
            if (!live && r >= 0) {
                ray = r;
                V3 o, dir;
                if (RAYS_IN_KERNEL) {
                    primary_ray(rp, r, true, o, dir);
                } else {
                    o = v3(origin + 3 * (long long)r);
                    dir = v3(direction + 3 * (long long)r);
                }
                org[0] = o.x;
                org[THREADS] = o.y;
                org[2 * THREADS] = o.z;
                if (keep_dir) {
                    dir0[0] = dir.x;
                    dir0[THREADS] = dir.y;
                    dir0[2 * THREADS] = dir.z;
                }
                init_walk(s, o, dir);
                if (DEFER == 2) s.env_pos = o;
                // pre-loop seek: uniform(fold_in(key, 1 << 20), (B, 5))
                seek<EXT>(c, s, k_seek, (unsigned long long)r);
                if (DEFER == 2 && s.phase == P_SHADOW) s.env_pos = s.anchor;
                step = 0;
                live = s.phase != P_DONE && p.max_steps > 0;
                if (!live) write_out<DEFER>(p, s, out, r, dir0, org);
            }
        }
        // the slots are gone or too few lanes are idle: step the live
        // rays; a warp ends when the slots are gone and no lane is live
        if (!__any_sync(FULL, live)) break;
        if (live) {
            const bool in_cache = step < n_keys;
            const Key* e = skeys + 1 + KEYS_PER_STEP * step;
            const Key ks = in_cache ? e[0] : fold_in(key, (uint32_t)step);
            walk_step<EXT, CELLS, DEFER == 2, Row, OCT, LOOP>(
                c, cp, s, org, ks, in_cache ? e + 1 : nullptr,
                (unsigned long long)ray);
            ++step;
            if (s.phase == P_DONE || step >= p.max_steps) {
                write_out<DEFER>(p, s, out, ray, dir0, org);
                live = false;
            }
        }
    }
}

int key_smem_bytes(int key_steps) {
    const int n = key_steps < 0 ? 0 : (key_steps < KEY_CACHE ? key_steps
                                                              : KEY_CACHE);
    return (1 + KEYS_PER_STEP * n) * (int)sizeof(Key);
}

// The dynamic shared memory of a launch: the keys, and the primary
// directions of a block's lanes where a queued ray hands K4 its own.
int smem_bytes(const FusedParams& p) {
    return key_smem_bytes(min(p.key_steps, p.max_steps)) +
           (p.queued && p.defer_env ? 3 * THREADS * (int)sizeof(float) : 0);
}

// SMs and resident blocks per SM of one variant, asked of the runtime
// once per library load (again only for another device or key-cache
// size).
template <bool RAYS_IN_KERNEL, int DEFER, bool EXT, bool CELLS,
          typename Row = float, bool OCT = false, bool LOOP = false>
cudaError_t occupancy(int smem, int& sms, int& per_sm) {
    static int o_dev = -1, o_smem = -1, o_sms = 0, o_per_sm = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev != o_dev || smem != o_smem) {
        int n_sm = 0, n_blk = 0;
        e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n_blk,
                fused_direct_kernel<RAYS_IN_KERNEL, DEFER, EXT, CELLS, Row, OCT, LOOP>,
                THREADS, smem);
        if (e != cudaSuccess) return e;
        if (n_sm <= 0 || n_blk <= 0) return cudaErrorInvalidConfiguration;
        o_dev = dev, o_smem = smem, o_sms = n_sm, o_per_sm = n_blk;
    }
    sms = o_sms;
    per_sm = o_per_sm;
    return cudaSuccess;
}

template <bool RAYS_IN_KERNEL, int DEFER, bool EXT, bool CELLS,
          typename Row = float, bool OCT = false, bool LOOP = false>
int launch_variant(const FusedParams& p, const ExtParams& x,
                   const CellParams& cp, const RaygenParams& rp,
                   const float* origin, const float* direction,
                   const void* corners, const float* lights,
                   const float* lut, float* out, unsigned* next_ray,
                   void* stream) {
    if (p.B <= 0) return 0;
    if (p.refill_min < 1 || p.refill_min > 32 ||
        (p.tile_w != 0 && (p.tile_w < 0 || p.tile_h <= 0 || p.frame_w <= 0))
        || slot_count(p) > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const int smem = smem_bytes(p);
    int sms = 0, per_sm = 0;
    cudaError_t e =
        occupancy<RAYS_IN_KERNEL, DEFER, EXT, CELLS, Row, OCT, LOOP>(
            smem, sms, per_sm);
    if (e != cudaSuccess) return (int)e;
    const long long need = ((long long)p.B + THREADS - 1) / THREADS;
    const long long grid = (long long)sms * per_sm;
    const int blocks = (int)(need < grid ? need : grid);
    const cudaStream_t st = (cudaStream_t)stream;
    e = cudaMemsetAsync(next_ray, 0, sizeof(unsigned), st);
    if (e != cudaSuccess) return (int)e;
    const Out o{out, ((long long)p.B + 3) & ~3LL};
    fused_direct_kernel<RAYS_IN_KERNEL, DEFER, EXT, CELLS, Row, OCT, LOOP>
        <<<blocks, THREADS, smem, st>>>(
            p, rp, origin, direction, static_cast<const Row*>(corners),
            lights, lut, o, next_ray, (unsigned)slot_count(p), x, cp);
    return (int)cudaGetLastError();
}

// The instance of a single grid's rows (`rows`: ROWS_* says which).
template <bool RAYS_IN_KERNEL, int DEFER, bool EXT>
int launch_rows(int rows, const FusedParams& p, const ExtParams& x,
                const RaygenParams& rp, const float* origin,
                const float* direction, const void* corners,
                const float* lights, const float* lut, float* out,
                unsigned* next_ray, void* stream) {
    CellParams oct{};
    oct.octant = rows == ROWS_F32_OCTANT || rows == ROWS_BF16_OCTANT;
    switch (rows) {
        case ROWS_F32:
            return launch_variant<RAYS_IN_KERNEL, DEFER, EXT, false>(
                p, x, oct, rp, origin, direction, corners, lights, lut, out,
                next_ray, stream);
        case ROWS_F32_OCTANT:
            return launch_variant<RAYS_IN_KERNEL, DEFER, EXT, false, float,
                                  true>(p, x, oct, rp, origin, direction,
                                        corners, lights, lut, out, next_ray,
                                        stream);
        case ROWS_BF16:
        case ROWS_BF16_OCTANT:
            return launch_variant<RAYS_IN_KERNEL, DEFER, EXT, false,
                                  __nv_bfloat16, true>(
                p, x, oct, rp, origin, direction, corners, lights, lut, out,
                next_ray, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// The variant of a launch: CELLS where a cell table is given (an
// instanced scene, in float32 rows), with LOOP where it has no lists, EXT
// or not; else EXT or not, in the instances of its rows (launch_rows).
template <bool RAYS_IN_KERNEL, int DEFER>
int launch_defer(const FusedParams& p, const ExtParams& x,
                 const CellParams* cp, int rows, const RaygenParams& rp,
                 const float* origin, const float* direction,
                 const void* corners, const float* lights, const float* lut,
                 float* out, unsigned* next_ray, void* stream) {
    if (cp) {
        if (rows != ROWS_F32) return (int)cudaErrorInvalidValue;
        if (cp->loop)
            return extended(x)
                       ? launch_variant<RAYS_IN_KERNEL, DEFER, true, true,
                                        float, false, true>(
                             p, x, *cp, rp, origin, direction, corners,
                             lights, lut, out, next_ray, stream)
                       : launch_variant<RAYS_IN_KERNEL, DEFER, false, true,
                                        float, false, true>(
                             p, x, *cp, rp, origin, direction, corners,
                             lights, lut, out, next_ray, stream);
        return extended(x)
                   ? launch_variant<RAYS_IN_KERNEL, DEFER, true, true>(
                         p, x, *cp, rp, origin, direction, corners, lights,
                         lut, out, next_ray, stream)
                   : launch_variant<RAYS_IN_KERNEL, DEFER, false, true>(
                         p, x, *cp, rp, origin, direction, corners, lights,
                         lut, out, next_ray, stream);
    }
    return extended(x)
               ? launch_rows<RAYS_IN_KERNEL, DEFER, true>(
                     rows, p, x, rp, origin, direction, corners, lights, lut,
                     out, next_ray, stream)
               : launch_rows<RAYS_IN_KERNEL, DEFER, false>(
                     rows, p, x, rp, origin, direction, corners, lights, lut,
                     out, next_ray, stream);
}

template <bool RAYS_IN_KERNEL>
int launch(const FusedParams& p, const ExtParams& x, const CellParams* cp,
           int rows, const RaygenParams& rp, const float* origin,
           const float* direction, const void* corners,
           const float* lights, const float* lut, float* out,
           unsigned* next_ray, void* stream) {
    if (p.defer_env == 2)
        return launch_defer<RAYS_IN_KERNEL, 2>(p, x, cp, rows, rp, origin,
                                               direction, corners, lights,
                                               lut, out, next_ray, stream);
    return p.defer_env
               ? launch_defer<RAYS_IN_KERNEL, 1>(
                     p, x, cp, rows, rp, origin, direction, corners, lights,
                     lut, out, next_ray, stream)
               : launch_defer<RAYS_IN_KERNEL, 0>(
                     p, x, cp, rows, rp, origin, direction, corners, lights,
                     lut, out, next_ray, stream);
}

template <bool RAYS_IN_KERNEL, int DEFER, bool EXT, bool CELLS,
          typename Row = float, bool OCT = false, bool LOOP = false>
cudaError_t variant_info(int smem, int& sms, int& per_sm,
                         cudaFuncAttributes& a) {
    const cudaError_t e =
        occupancy<RAYS_IN_KERNEL, DEFER, EXT, CELLS, Row, OCT, LOOP>(
            smem, sms, per_sm);
    return e != cudaSuccess
               ? e
               : cudaFuncGetAttributes(
                     &a, fused_direct_kernel<RAYS_IN_KERNEL, DEFER, EXT,
                                             CELLS, Row, OCT, LOOP>);
}

template <bool RAYS_IN_KERNEL, int DEFER, bool EXT>
cudaError_t rows_info(int rows, int smem, int& sms, int& per_sm,
                      cudaFuncAttributes& a) {
    if (rows == ROWS_F32_OCTANT)
        return variant_info<RAYS_IN_KERNEL, DEFER, EXT, false, float, true>(
            smem, sms, per_sm, a);
    if (rows == ROWS_BF16 || rows == ROWS_BF16_OCTANT)
        return variant_info<RAYS_IN_KERNEL, DEFER, EXT, false, __nv_bfloat16,
                            true>(smem, sms, per_sm, a);
    return variant_info<RAYS_IN_KERNEL, DEFER, EXT, false>(smem, sms, per_sm,
                                                            a);
}

// variant: 0 density only, 1 EXT, 2 CELLS, 3 CELLS with EXT, 4 CELLS with
// LOOP, 5 CELLS with LOOP and EXT (CELLS in float32 rows only); rows: the
// ROWS_* of a single grid
template <bool RAYS_IN_KERNEL, int DEFER>
cudaError_t variant_info(int variant, int rows, int smem, int& sms,
                         int& per_sm, cudaFuncAttributes& a) {
    if (variant >= 2 && rows != ROWS_F32) return cudaErrorInvalidValue;
    if (variant == 5)
        return variant_info<RAYS_IN_KERNEL, DEFER, true, true, float, false,
                            true>(smem, sms, per_sm, a);
    if (variant == 4)
        return variant_info<RAYS_IN_KERNEL, DEFER, false, true, float, false,
                            true>(smem, sms, per_sm, a);
    if (variant == 3)
        return variant_info<RAYS_IN_KERNEL, DEFER, true, true>(smem, sms,
                                                               per_sm, a);
    if (variant == 2)
        return variant_info<RAYS_IN_KERNEL, DEFER, false, true>(
            smem, sms, per_sm, a);
    return variant == 1
               ? rows_info<RAYS_IN_KERNEL, DEFER, true>(rows, smem, sms,
                                                        per_sm, a)
               : rows_info<RAYS_IN_KERNEL, DEFER, false>(rows, smem, sms,
                                                         per_sm, a);
}

}  // namespace

extern "C" int vpt_fused_params_size() { return (int)sizeof(FusedParams); }
extern "C" int vpt_fused_ext_size() { return (int)sizeof(ExtParams); }
extern "C" int vpt_fused_cells_size() { return (int)sizeof(CellParams); }

// K1 on the rays in (B, 3) origin and direction buffers.  `out` holds
// 7, 13 or 16 S floats laid out as Out says; `next_ray` is the
// 4-byte ray counter, zeroed here on the launch stream; `lut` the density
// color LUT, then the emission LUT, (512, 3); `cells` the cell table of an
// instanced scene (CellParams), or null; `rows` the corner rows' ROWS_*
// (their element type and whether they carry the octant columns).
extern "C" int vpt_fused_direct(const void* params, const void* ext,
                                const void* cells, int rows,
                                const float* origin, const float* direction,
                                const void* corners, const float* lights,
                                const float* lut, float* out,
                                unsigned* next_ray, void* stream) {
    return launch<false>(*static_cast<const FusedParams*>(params),
                         *static_cast<const ExtParams*>(ext),
                         static_cast<const CellParams*>(cells), rows,
                         RaygenParams{}, origin, direction, corners, lights,
                         lut, out, next_ray, stream);
}

// K1 on the primary rays of `raygen` (H * W = B), made in the lanes.
extern "C" int vpt_fused_direct_primary(const void* params, const void* ext,
                                        const void* cells, int rows,
                                        const void* raygen,
                                        const void* corners,
                                        const float* lights,
                                        const float* lut, float* out,
                                        unsigned* next_ray, void* stream) {
    const FusedParams& p = *static_cast<const FusedParams*>(params);
    const RaygenParams& rp = *static_cast<const RaygenParams*>(raygen);
    if ((long long)rp.H * rp.W != (long long)p.B)
        return (int)cudaErrorInvalidValue;
    return launch<true>(p, *static_cast<const ExtParams*>(ext),
                        static_cast<const CellParams*>(cells), rows, rp,
                        nullptr, nullptr, corners, lights, lut, out,
                        next_ray, stream);
}

// info[0..5] of one variant (route, deferred environment 0, 1 or 2
// (with env_pos), variant: 0 density only, 1 EXT, 2 CELLS, 3 CELLS with
// EXT, 4 and 5 the same with LOOP; rows: the
// ROWS_* of a single grid) whose keys of key_steps steps are cached,
// at Q = 1: SMs, resident blocks per SM, threads per block, registers per
// thread, local (spill and stack) bytes per thread, dynamic shared bytes
// per block.
extern "C" int vpt_fused_launch_info(int rays_in_kernel, int defer_env,
                                     int variant, int rows, int key_steps,
                                     int* info) {
    const int smem = key_smem_bytes(key_steps);
    int sms = 0, per_sm = 0;
    cudaFuncAttributes a{};
    cudaError_t e;
    if (rays_in_kernel)
        e = defer_env == 2 ? variant_info<true, 2>(variant, rows, smem, sms,
                                                   per_sm, a)
            : defer_env    ? variant_info<true, 1>(variant, rows, smem, sms,
                                                   per_sm, a)
                           : variant_info<true, 0>(variant, rows, smem, sms,
                                                   per_sm, a);
    else
        e = defer_env == 2 ? variant_info<false, 2>(variant, rows, smem, sms,
                                                    per_sm, a)
            : defer_env    ? variant_info<false, 1>(variant, rows, smem, sms,
                                                    per_sm, a)
                           : variant_info<false, 0>(variant, rows, smem, sms,
                                                    per_sm, a);
    if (e != cudaSuccess) return (int)e;
    info[0] = sms;
    info[1] = per_sm;
    info[2] = THREADS;
    info[3] = a.numRegs;
    info[4] = (int)a.localSizeBytes;
    info[5] = smem;
    return 0;
}
