// K5 — the reference engine's walks on the card: the direct integrator
// (walk_direct) and the volumetric integrator (walk_volumetric).
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
// ray's draws, so a ray here stops when it is done, and any schedule of
// the rays writes the same bits.
//
// The terminal environment: BLACK and CONSTANT are added here; for the
// simple sky, HDRI with a map and the Bruneton atmosphere each ray's beta
// and direction (and for the live atmosphere its env_pos) go beside its
// outputs to K4 (csrc/environment.cu), launched after K5, as after K1.
// The volumetric integrator's sky next-event estimate reads the
// environment toward any direction here: BLACK, CONSTANT, HDRI (the map's
// bilinear taps; uniform sphere, or the CDF's two binary searches with
// hdri_importance) and the simple sky (its 16 x 8 march; with or without
// the sky CDF), the sky and the map copied from environment.cu's device
// code; and the Bruneton atmosphere (render/nee.py:27-52 ->
// sky/runtime.py::sample_atmosphere_scene), live from the event's
// position or from the baked cache, on K4's device code (atmosphere.cuh)
// as a template argument of walk_nee (SKY_*).
//
// Scope: every scene the plain walks take (the scene kind SC_*, a
// template argument of every kernel that reads the scene): single grids
// in float32 corner rows, with or without the octant columns, or in
// bfloat16 rows (tracking.py:445, the octant columns a run-time flag);
// instanced scenes with cell lists (tracking.py:150, the slots of the
// cell at (pos - root) / extent * R) and without (the static loop,
// tracking.py:230); EXT (a template argument) for an emission or a color
// channel or volume_depth > 1.  bfloat16 rows and octant columns on
// instanced scenes stay refused where the scene is built (ROADMAP A.10).
// The device code is in walk.cuh; this source holds the SC_F32 kernels
// and the launches, walk_rows.cu and walk_cells.cu the other kinds'.
//
// What bounds it: each walk step is one dependent load of a corner row
// at a data-dependent address, and its draws are threefry hashes issued
// in the thread; the rays take different numbers of steps, walks and
// bounces, so a launch lasts as long as its longest walk.  The design, for
// the H100:
// - per-tile keys: every key above a ray's element index is the same for
//   all the rays of a tile: the bounce key fold_in(tile key, depth), the
//   walks' and the estimates' subkeys, and each walk's step keys
//   fold_in(walk key, s).  walk_keys_kernel computes them once per tile
//   and bounce into a table (a slab per tile and bounce, slot_key's
//   layout); a ray reads its tile's slab, and only a step past
//   key_steps, or a bounce the table does not hold, folds its key in the
//   thread.  A walk step hashes twice where it hashed three times (once
//   where it jumps), a shadow step once where twice; uniform_at(key,
//   element) stays in the thread: it is the ray's own draw.
// - the fetch computes an exit only where it is the answer (an empty
//   box's, or the grid's entry from outside): a step in a box that is not
//   empty divides 4 times, not 16.
// - walk_direct: persistent warps (SMs x resident blocks).  A lane runs
//   one bounce of its ray per turn; once REFILL_MIN lanes of a warp are
//   idle they take the next rays from a global counter (K1's refill, a
//   bounce at a time), so lanes do not wait for their warp's longest ray.
//   16 blocks of 128 an SM (32 registers): the walk is bound by latency,
//   and more warps in flight beat the spills to local memory.
// - walk_volumetric: a wavefront of stage kernels over compacted path
//   queues.  The path state (PathState, 96 B a ray) and the queues live
//   in device buffers the wrapper allocates once per launch size; per
//   bounce d the host issues, with no round trip: walk_keys (the bounce's
//   slabs), EXTEND (delta_track on the live queue, the breaks, the
//   one-light pick; a path that ends writes its outputs), NEE (each warp
//   on one kind: the sky's light samples, its phase samples, the sun, the
//   point lights, as separate lists, so their tails overlap in one
//   launch), and SCATTER (NEE's estimate added to L, the emission walk on
//   EXT, the phase sample, the survivors pushed into bounce d + 1's
//   queue).  Queue lengths stay on the card; a stage whose queue is empty
//   returns at once.  Each stage's blocks are persistent and take 32
//   paths at a time from a counter; a queue is filled by warp-aggregated
//   atomics, so a path's slot in it is not its ray index: its tile and
//   its index in the tile come from its ray index.  The order in which L
//   sums is kept: a bounce's L + beta * (ld * 3), then + emission, both in
//   SCATTER, NEE having written ld (the sky's as its two strategies'
//   parts, added in nee.estimate_sky's order).
// The measurements are in PERF.md (§6, the kernel table and K5's findings).

#include "walk.cuh"

namespace {

// ------------------------------------------------------------- launch --

// The persistent grid of a kernel: SMs x its resident blocks of THREADS,
// asked of the runtime once per kernel and device.
cudaError_t persistent_grid(const void* fn, int& grid) {
    struct Entry {
        const void* fn;
        int dev, grid;
    };
    static Entry cache[64];
    static int n_cache = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    for (int i = 0; i < n_cache; ++i)
        if (cache[i].fn == fn && cache[i].dev == dev) {
            grid = cache[i].grid;
            return cudaSuccess;
        }
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                          THREADS, 0);
    if (e != cudaSuccess) return e;
    if (sms <= 0 || per_sm <= 0) return cudaErrorInvalidConfiguration;
    grid = sms * per_sm;
    if (n_cache < 64) cache[n_cache++] = Entry{fn, dev, grid};
    return cudaSuccess;
}

// Holds its stream for `ns` nanoseconds of the card's clock: a timed
// launch (StageTimer) queues all its kernels behind it, so that the card
// runs them back to back and no host gap falls between two events.
__global__ void walk_hold_kernel(unsigned long long ns) {
    unsigned long long t0, t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    do {
        __nanosleep(1000);
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    } while (t - t0 < ns);
}

constexpr unsigned long long HOLD_NS = 50000000ull;  // 50 ms

// Each kernel's device ms in one launch of vpt_walk, by CUDA events: an
// event after the launch's set-up (mark(-1)) and one after each kernel
// (mark(kind)), the time between two events going to the kind of the
// second.  `ms` null: untimed, and nothing is recorded.
struct StageTimer {
    float* ms = nullptr;  // N_LAUNCH_KINDS sums, or null
    cudaStream_t st = nullptr;
    std::vector<cudaEvent_t> ev;
    std::vector<int> kind;

    cudaError_t hold() {
        if (!ms) return cudaSuccess;
        walk_hold_kernel<<<1, 1, 0, st>>>(HOLD_NS);
        return cudaGetLastError();
    }
    cudaError_t mark(int k) {
        if (!ms) return cudaSuccess;
        cudaEvent_t e;
        cudaError_t err = cudaEventCreate(&e);
        if (err != cudaSuccess) return err;
        ev.push_back(e);
        kind.push_back(k);
        return cudaEventRecord(e, st);
    }
    // After the launch is queued: cudaErrorNotReady where the card had
    // passed the first event already (the hold was too short for the
    // queue, and a host gap may lie inside a time); else each kind's ms
    // added to `ms`.  Destroys the events.
    cudaError_t finish(cudaError_t err) {
        if (!ms) return err;
        if (err == cudaSuccess && !ev.empty()) {
            if (cudaEventQuery(ev[0]) == cudaErrorNotReady)
                (void)cudaGetLastError();  // not an error: clear it
            else
                err = cudaErrorNotReady;
        }
        if (err == cudaSuccess && !ev.empty())
            err = cudaEventSynchronize(ev.back());
        for (size_t i = 1; i < ev.size() && err == cudaSuccess; ++i) {
            float t = 0.f;
            err = cudaEventElapsedTime(&t, ev[i - 1], ev[i]);
            if (err == cudaSuccess && kind[i] >= 0) ms[kind[i]] += t;
        }
        for (cudaEvent_t e : ev) cudaEventDestroy(e);
        ev.clear();
        return err;
    }
};

template <bool VOL>
cudaError_t launch_keys(const WalkParams& p, Key* keys, int d0,
                        cudaStream_t st) {
    const long long n = (long long)p.n_tiles * p.key_depths * slab_size(p);
    const long long blocks = (n + THREADS - 1) / THREADS;
    walk_keys_kernel<VOL><<<(int)(blocks < 65535 ? blocks : 65535), THREADS,
                            0, st>>>(p, keys, d0);
    return cudaGetLastError();
}

// The kernels of a launch on scene kind sc under sky kind sky: this
// source's SC_F32 ones, each replaced by the one walk_rows.cu or
// walk_cells.cu gives for another kind (walk.cuh::WalkKernels).
WalkKernels resolve(int sc, int sky, bool vol, bool ext) {
    WalkKernels k = kernels_of<SC_F32, SKY_RUNTIME>(ext);
    if (sc == SC_F32 && (sky == SKY_RUNTIME || !vol)) return k;
    const WalkKernels o = sc >= SC_CELLS
                              ? walk_kernels_cells(sc, vol ? sky : 0, ext)
                              : walk_kernels_rows(sc, vol ? sky : 0, ext);
    if (o.direct) k.direct = o.direct;
    if (o.extend) k.extend = o.extend;
    if (o.nee) k.nee = o.nee;
    if (o.scatter) k.scatter = o.scatter;
    return k;
}

// One launch's arguments.
struct Launch {
    const WalkParams* p;
    const WalkEnv* e;
    const WalkTables* t;
    const WalkScene* s;
    const WalkWork* w;
    const float *origin, *direction;
    float* out;
    unsigned long long* stats;
    int n_stats;
    int* launches;
    StageTimer* tm;
    cudaStream_t st;
};

cudaError_t launch_direct(const Launch& a, const WalkKernels& k) {
    const WalkParams& p = *a.p;
    cudaError_t err = cudaMemsetAsync(a.w->counts, 0, sizeof(unsigned), a.st);
    if (err == cudaSuccess) err = a.tm->mark(-1);
    if (err == cudaSuccess) err = launch_keys<false>(p, table(*a.w), 0, a.st);
    if (err == cudaSuccess) err = a.tm->mark(L_KEYS);
    if (err != cudaSuccess) return err;
    ++a.launches[L_KEYS];
    int grid = 0;
    err = persistent_grid(k.direct, grid);
    if (err != cudaSuccess) return err;
    const long long need = ((long long)p.B + THREADS - 1) / THREADS;
    const Key* keys = table(*a.w);
    unsigned* next_ray = a.w->counts;
    void* args[] = {(void*)a.p,         (void*)a.e,      (void*)a.t,
                    (void*)&a.origin,   (void*)&a.direction,
                    (void*)&a.out,      (void*)&keys,    (void*)&next_ray,
                    (void*)&a.stats,    (void*)a.s};
    err = cudaLaunchKernel(k.direct, dim3((int)(need < grid ? need : grid)),
                           dim3(THREADS), args, 0, a.st);
    if (err == cudaSuccess) err = a.tm->mark(L_DIRECT);
    if (err == cudaSuccess) ++a.launches[L_DIRECT];
    return err;
}

// walk_volumetric's wavefront: per bounce the keys, EXTEND, the NEE kinds
// the scene has, SCATTER, all on the stream with no host round trip.
cudaError_t launch_volumetric(const Launch& a, const WalkKernels& k) {
    const WalkParams& p = *a.p;
    // no bounce (ray_depth 0): EXTEND at 0 writes every ray as it enters
    const int depths = p.ray_depth > 0 ? p.ray_depth : 1;
    cudaError_t err = cudaMemsetAsync(
        a.w->counts, 0, sizeof(unsigned) * N_COUNTS * (depths + 1), a.st);
    if (err == cudaSuccess) err = a.tm->mark(-1);
    if (err != cudaSuccess) return err;
    int g_ext = 0, g_nee = 0, g_sc = 0;
    if ((err = persistent_grid(k.extend, g_ext)) ||
        (err = persistent_grid(k.nee, g_nee)) ||
        (err = persistent_grid(k.scatter, g_sc)))
        return err;
    const long long need = ((long long)p.B + THREADS - 1) / THREADS;
    const int g_first = (int)(need < g_ext ? need : g_ext);
    int d = 0;
    void* ext_args[] = {(void*)a.p,       (void*)a.e,   (void*)a.t,
                        (void*)&a.origin, (void*)&a.direction,
                        (void*)&a.out,    (void*)a.w,   (void*)&d,
                        (void*)&a.stats,  (void*)&a.n_stats, (void*)a.s};
    void* nee_args[] = {(void*)a.p,      (void*)a.e,       (void*)a.t,
                        (void*)a.w,      (void*)&d,        (void*)&a.stats,
                        (void*)&a.n_stats, (void*)a.s};
    void* sc_args[] = {(void*)a.p,      (void*)a.e,      (void*)a.t,
                       (void*)&a.origin, (void*)&a.out,  (void*)a.w,
                       (void*)&d,       (void*)&a.stats, (void*)&a.n_stats,
                       (void*)a.s};
    for (d = 0; d < depths; ++d) {
        if ((err = launch_keys<true>(p, table(*a.w), d, a.st)) ||
            (err = a.tm->mark(L_KEYS)))
            return err;
        ++a.launches[L_KEYS];
        if ((err = cudaLaunchKernel(k.extend, dim3(d == 0 ? g_first : g_ext),
                                    dim3(THREADS), ext_args, 0, a.st)) ||
            (err = a.tm->mark(L_EXTEND)))
            return err;
        ++a.launches[L_EXTEND];
        if (p.ray_depth <= 0) break;
        if ((err = cudaLaunchKernel(k.nee, dim3(g_nee), dim3(THREADS),
                                    nee_args, 0, a.st)) ||
            (err = a.tm->mark(L_NEE)))
            return err;
        ++a.launches[L_NEE];
        if ((err = cudaLaunchKernel(k.scatter, dim3(g_sc), dim3(THREADS),
                                    sc_args, 0, a.st)) ||
            (err = a.tm->mark(L_SCATTER)))
            return err;
        ++a.launches[L_SCATTER];
    }
    return cudaSuccess;
}

// Whether the scene struct holds what its kinds read (rows of row_w
// columns).
bool scene_ok(const WalkScene& s, int row_w, bool vol) {
    if (s.kind < 0 || s.kind >= N_SC || s.sky < 0 || s.sky >= N_SKY)
        return false;
    if (s.sky != SKY_RUNTIME) {
        const AtmParams& a = s.atm;
        if (!vol) return false;
        if (s.sky == SKY_ATMOSPHERE &&
            (a.trans == nullptr || a.irr == nullptr ||
             a.scat_mie == nullptr ||
             reinterpret_cast<uintptr_t>(a.trans) % 16 != 0 ||
             reinterpret_cast<uintptr_t>(a.irr) % 16 != 0 ||
             reinterpret_cast<uintptr_t>(a.scat_mie) % 32 != 0))
            return false;
        if (s.sky == SKY_CACHE &&
            (a.cache == nullptr || a.cache_h <= 0 || a.cache_w <= 0))
            return false;
    }
    if (s.kind < SC_CELLS)
        return row_w >= (s.octant || s.kind == SC_F32_OCT ? 87 : 15) &&
               (s.kind != SC_F32 || !s.octant) &&
               (s.kind != SC_F32_OCT || s.octant);
    return s.cells != nullptr && s.inst != nullptr && s.R >= 1 && s.k >= 1 &&
           s.cell_w >= (s.octant ? 79 : 7) &&
           (s.kind == SC_LOOP || (s.ids_off >= (s.octant ? 79 : 7) &&
                                  s.ids_off + s.k <= s.cell_w));
}

}  // namespace

extern "C" int vpt_walk_params_size() { return (int)sizeof(WalkParams); }
extern "C" int vpt_walk_env_size() { return (int)sizeof(WalkEnv); }
extern "C" int vpt_walk_tables_size() { return (int)sizeof(WalkTables); }
extern "C" int vpt_walk_scene_size() { return (int)sizeof(WalkScene); }
extern "C" int vpt_walk_work_size() { return (int)sizeof(WalkWork); }

// K5 on the B rays in (B, 3) origin and direction buffers: `volumetric`
// picks walk_volumetric over walk_direct, `ext` the EXT instances, the
// scene struct (WalkScene) the scene and sky kinds' instances; `work`
// the buffers of a launch of this size (render/walk.py::_work): the key
// table (n_tiles x key_depths slabs), the counters, and for
// walk_volumetric the path states and queues; `out` holds 7, 13 or 16 S
// floats (write_out); `stats`, n_stats (3 or 8) unsigned 64-bit counters
// the launch adds to (bounces, walk steps, sky evaluations, then
// walk_volumetric's steps by stage), or null; `launches`
// (N_LAUNCH_KINDS ints) += the kernels launched, by kind; `kernel_ms`
// (N_LAUNCH_KINDS floats, or null) += each kind's device ms in this launch
// (StageTimer: the launch queued behind walk_hold_kernel, and waited for).
extern "C" int vpt_walk(int volumetric, int ext, const void* params,
                        const void* env, const void* tables,
                        const void* scene, const void* work,
                        const float* origin, const float* direction,
                        float* out, void* stats, int n_stats, int* launches,
                        float* kernel_ms, void* stream) {
    const WalkParams& p = *static_cast<const WalkParams*>(params);
    const WalkTables& t = *static_cast<const WalkTables*>(tables);
    const WalkScene& s = *static_cast<const WalkScene*>(scene);
    const WalkWork& w = *static_cast<const WalkWork*>(work);
    if (p.B <= 0) return 0;
    const int n_tiles =
        p.tile > 0 ? (int)(((long long)p.B + p.tile - 1) / p.tile) : 1;
    const bool vol = volumetric != 0;
    if (p.B > 0x7fffffff / 16 || p.tile < 0 || p.row_w < 15 ||
        t.corners == nullptr || t.lut == nullptr || t.lights == nullptr ||
        (p.nee_env == NEE_HDRI && t.map == nullptr) ||
        (p.use_cdf && (t.cdf == nullptr || p.cdf_h < 2 || p.cdf_w < 2)) ||
        p.volume_depth < 1 || (!ext && p.volume_depth != 1) ||
        p.n_tiles != n_tiles || p.key_scalars != n_scalars(vol, p) ||
        p.key_walks != n_walks(vol, p) || p.key_steps < 0 ||
        p.key_depths < 1 || (vol && p.key_depths != 1) ||
        w.keys == nullptr || w.counts == nullptr ||
        (vol && (w.state == nullptr || w.queue == nullptr)) ||
        (stats != nullptr && n_stats != N_STATS && n_stats != N_STATS_STAGES) ||
        !scene_ok(s, p.row_w, vol))
        return (int)cudaErrorInvalidValue;
    const WalkKernels k = resolve(s.kind, s.sky, vol, ext != 0);
    if (!k.direct || !k.extend || !k.nee || !k.scatter)
        return (int)cudaErrorInvalidValue;
    StageTimer tm;
    tm.ms = kernel_ms;
    tm.st = (cudaStream_t)stream;
    const Launch a{&p, static_cast<const WalkEnv*>(env), &t, &s, &w,
                   origin, direction, out,
                   static_cast<unsigned long long*>(stats), n_stats,
                   launches, &tm, tm.st};
    cudaError_t err = tm.hold();
    if (err == cudaSuccess)
        err = vol ? launch_volumetric(a, k) : launch_direct(a, k);
    return (int)tm.finish(err);
}

// The key table alone (walk_keys_kernel), bounces [d0, d0 + key_depths),
// for the check against render/walk.py::key_table_plain.
extern "C" int vpt_walk_keys(int volumetric, const void* params, void* keys,
                             int d0, void* stream) {
    const WalkParams& p = *static_cast<const WalkParams*>(params);
    const bool vol = volumetric != 0;
    if (p.n_tiles < 1 || p.key_scalars != n_scalars(vol, p) ||
        p.key_walks != n_walks(vol, p) || p.key_steps < 0 ||
        p.key_depths < 1 || keys == nullptr)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    return (int)(vol ? launch_keys<true>(p, static_cast<Key*>(keys), d0, st)
                     : launch_keys<false>(p, static_cast<Key*>(keys), d0,
                                          st));
}

// info[0..3] of one kernel: registers per thread, local (spill and stack)
// bytes per thread, threads per block, resident blocks per SM.  `stage`:
// L_KEYS, L_DIRECT (walk_direct), L_EXTEND (walk_volumetric's EXTEND),
// L_NEE, L_SCATTER; `sc` and `sky` the scene and sky kinds.
extern "C" int vpt_walk_launch_info(int volumetric, int ext, int stage,
                                    int sc, int sky, int* info) {
    if (sc < 0 || sc >= N_SC || sky < 0 || sky >= N_SKY)
        return (int)cudaErrorInvalidValue;
    const WalkKernels k = resolve(sc, sky, volumetric != 0, ext != 0);
    const void* fn = nullptr;
    switch (stage) {
        case L_KEYS:
            fn = volumetric ? (const void*)walk_keys_kernel<true>
                            : (const void*)walk_keys_kernel<false>;
            break;
        case L_DIRECT: fn = k.direct; break;
        case L_EXTEND: fn = k.extend; break;
        case L_NEE: fn = k.nee; break;
        case L_SCATTER: fn = k.scatter; break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes a{};
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
