"""The plain versions of the gather-probe kernels P1-P3
(vpt_tpu_torch/ops/probe.py) against the Pallas kernel bodies of the
repository's tools/, run in interpret mode with the tools' BlockSpecs,
exactly.  The bodies are copied here (file and line cited) because the
tools run their probes on import.  The CUDA kernels themselves are held
against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vpt_tpu_torch.ops import probe
from vpt_tpu_torch.tools import probe_axis0, probe_dyngather, probe_gather

VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)
B, V = 4096, 106330   # T3 at B = 4096 (the tool's B is 65536)


def _call(kern, out_shape, *args):
    return np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        in_specs=[VMEM] * len(args), out_specs=VMEM, interpret=True)(*args))


# tools/probe_gather.py:96-112
def k_take(table_ref, idx_ref, out_ref):
    out_ref[:] = jnp.take(table_ref[:], idx_ref[:], axis=0)


def k_index(table_ref, idx_ref, out_ref):
    out_ref[:] = table_ref[idx_ref[:]]


def k_take_along(table_ref, idx_ref, out_ref):
    i = idx_ref[:][:, None]
    out_ref[:] = jnp.take_along_axis(
        table_ref[:], jnp.broadcast_to(i, (B, 10)), axis=0)


def k_onedim(table_ref, idx_ref, out_ref):
    out_ref[:] = jnp.take(table_ref[:, 0], idx_ref[:], axis=0)


# tools/probe_axis0.py:33-34 (make -> kern) and :57-58 (kern_roll)
def make_axis(axis):
    def kern(x_ref, idx_ref, out_ref):
        out_ref[:] = jnp.take_along_axis(x_ref[:], idx_ref[:], axis=axis)
    return kern


def kern_roll(x_ref, out_ref):
    out_ref[:] = pltpu.roll(x_ref[:], shift=3, axis=1)


# tools/probe_dyngather.py:59-69 (make_pallas -> kern), ITERS = 64
def make_pallas(axis, iters=64):
    def kern(x_ref, idx_ref, out_ref):
        x = x_ref[:]

        def body(i, carry):
            acc, idx = carry
            r = jnp.take_along_axis(x, idx, axis=axis)
            acc = acc + r
            idx = (idx + acc.astype(jnp.int32) + i) % x.shape[axis]
            return acc, idx
        acc, _ = jax.lax.fori_loop(0, iters, body,
                                   (jnp.zeros_like(x), idx_ref[:]))
        out_ref[:] = acc
    return kern


@pytest.fixture(scope="module")
def table():
    r = np.random.default_rng(0)
    return (r.uniform(size=(V, 10)).astype(np.float32),
            r.integers(0, V, B).astype(np.int32))


@pytest.mark.parametrize("kern", [k_take, k_index, k_take_along])
def test_gather_rows_matches_pallas(table, kern):
    """T3: the three row-gather bodies compute one function, P1."""
    tab, idx = table
    got = probe.gather_rows(torch.from_numpy(tab), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), _call(kern, (B, 10), tab,
                                                     idx))


def _gather_edges(rows, n, seed):
    """n in-range int32 indices with every out-of-range kind planted: -1,
    -V, -V - 1, V, 100 V, 2^31 - 1 and -2^31 (V = rows)."""
    r = np.random.default_rng(seed)
    idx = r.integers(0, rows, n).astype(np.int64)
    edges = [-1, -rows, -rows - 1, rows, 100 * rows, 2 ** 31 - 1, -2 ** 31]
    at = r.choice(n, 8 * len(edges), replace=False)
    idx[at] = np.resize(edges, at.size)
    return idx.astype(np.int32)


@pytest.mark.parametrize("kern,clip", [(k_take, False),
                                       (k_take_along, False),
                                       (k_index, True)])
def test_gather_rows_out_of_range_matches_pallas(kern, clip):
    """Out-of-range indices read what the Pallas bodies read in interpret
    mode: jnp.take and take_along_axis count [-V, 0) from the end and
    fill NaN beyond; k_index's t[idx] wraps the negatives, then clamps
    (P1 with ``clip``)."""
    r = np.random.default_rng(21)
    tab = r.uniform(size=(1000, 10)).astype(np.float32)
    idx = _gather_edges(1000, B, 22)
    want = _call(kern, (B, 10), tab, idx)
    assert np.isnan(want).any() != clip
    got = probe.gather_rows(torch.from_numpy(tab), torch.from_numpy(idx),
                            clip)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rows", [1, 16, 1000])
@pytest.mark.parametrize("clip", [False, True])
def test_gather_rows_plain_never_raises(rows, clip):
    """Any int32 index reads a row or NaN, 1-D and 2-D tables alike:
    [-V, V) by jnp.take's rule, beyond it NaN (fill) or the nearest end
    row after the wrap (clip), as numpy computes it here."""
    r = np.random.default_rng(rows)
    idx = np.concatenate([r.integers(-2 ** 31, 2 ** 31, 3000),
                          _gather_edges(rows, 64, rows)]).astype(np.int32)
    tab = r.uniform(size=(rows, 3)).astype(np.float32)
    j = idx.astype(np.int64)
    j = np.where(j < 0, j + rows, j)
    ok = (j >= 0) & (j < rows)
    for t in (tab, tab[:, 1]):
        got = probe.gather_rows_plain(torch.from_numpy(t),
                                      torch.from_numpy(idx), clip).numpy()
        if clip:
            want = t[np.clip(j, 0, rows - 1)]
        else:
            want = np.where(ok.reshape((-1,) + (1,) * (t.ndim - 1)),
                            t[np.where(ok, j, 0)], np.nan)
        np.testing.assert_array_equal(got, want)
    empty = probe.gather_rows_plain(torch.zeros((0, 3)),
                                    torch.from_numpy(idx[:5]), clip)
    assert empty.shape == (5, 3) and bool(torch.isnan(empty).all())


@pytest.mark.parametrize("args,want", [
    # (width, batch, row stride, byte offset) -> (vec, rows, threads, grid)
    ((1, 65536), (1, 2048, 256, 32)),
    ((10, 65536), (2, 409, 256, 161)),
    ((31, 2073600), (1, 66, 256, 31419)),         # the corner table
    ((128, 65536), (4, 64, 256, 1024)),
    ((2, 100), (2, 2048, 256, 1)),
    ((8, 5000), (4, 1024, 256, 5)),
    ((1, 4096, 10), (1, 2048, 256, 2)),            # one column in place
    ((10, 65536, 12), (2, 409, 256, 161)),
    ((128, 65536, 128, 4), (1, 16, 256, 4096)),    # 4 bytes off 16
    ((128, 65536, 128, 8), (2, 32, 256, 2048)),
    ((128, 65536, 130), (2, 32, 256, 2048)),       # rows 8 bytes apart
    ((128, 65536, 129), (1, 16, 256, 4096)),
    ((4096, 7), (4, 2, 256, 4)),
    ((9999, 3), (1, 1, 256, 3)),                   # a row past one pass
    ((31, 0), (1, 66, 256, 0)),
])
def test_gather_rows_design(args, want):
    """P1's launch: float4 where width, row stride and table address keep
    rows 16-byte aligned, float2 where 8, else scalar; a block owns the
    rows that give its 256 threads one pass of 8 loads each."""
    d = probe.gather_rows_design(*args)
    assert tuple(d) == want
    width, batch = args[:2]
    assert d.rows * d.grid >= batch > d.rows * (d.grid - 1) or not batch
    assert d.rows <= probe.GATHER_MAX_ROWS
    vectors = d.rows * width // d.vec
    assert vectors <= d.threads * probe.GATHER_UNROLL or d.rows == 1


@pytest.mark.parametrize("args", [(0, 10), (10, 2 ** 31), (10, 5, -1),
                                  (10, 5, 2 ** 31)])
def test_gather_rows_design_refuses(args):
    with pytest.raises(ValueError):
        probe.gather_rows_design(*args)


def test_onedim_diverges_and_p1_gathers_the_column(table):
    """T4: as written, k_onedim's (B,) value does not fit its (B, 10)
    output and JAX refuses it; P1 at width 1 on the strided column
    computes what it meant."""
    tab, idx = table
    with pytest.raises(ValueError):
        _call(k_onedim, (B, 10), tab, idx)
    for rows, i in ((tab, idx), (tab[:4096], idx % 4096)):
        t = torch.from_numpy(rows)
        got = probe.gather_rows(t[:, 0], torch.from_numpy(i))
        np.testing.assert_array_equal(got.numpy(), np.take(rows[:, 0], i))


@pytest.mark.parametrize("dtype", [np.int32, np.uint32])
def test_take_along_axis0_matches_pallas(dtype):
    """T1 at (256, 128), int32 and uint32 indices: P2 with iters = 1."""
    r = np.random.default_rng(1)
    x = r.uniform(size=(256, 128)).astype(np.float32)
    idx = r.integers(0, 256, (256, 128)).astype(dtype)
    got = probe.take_along(torch.from_numpy(x), torch.from_numpy(idx), 0)
    np.testing.assert_array_equal(got.numpy(),
                                  _call(make_axis(0), x.shape, x, idx))


def test_roll_matches_pallas():
    """T2: pltpu.roll(x, 3, axis=1) on (8, 128)."""
    x = np.arange(8 * 128, dtype=np.float32).reshape(8, 128)
    got = probe.roll(torch.from_numpy(x), 3, 1)
    want = _call(kern_roll, x.shape, x)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.roll(x, 3, 1))


@pytest.mark.parametrize("axis", [0, 1])
def test_looped_take_along_matches_pallas(axis):
    """T5 at N = 512: P2 with iters = 64, exact (in-order float adds,
    truncating casts, floor mod)."""
    r = np.random.default_rng(2 + axis)
    x = r.uniform(size=(512, 128)).astype(np.float32)
    idx = r.integers(0, x.shape[axis], x.shape).astype(np.int32)
    got = probe.take_along(torch.from_numpy(x), torch.from_numpy(idx), axis,
                           64)
    np.testing.assert_array_equal(got.numpy(),
                                  _call(make_pallas(axis), x.shape, x, idx))


def test_wrappers_on_cpu_launch_nothing():
    """CPU tensors take the plain versions: no launch is counted."""
    before = [k.launches for k in probe.KERNELS]
    x = torch.rand(8, 16)
    i = torch.randint(0, 8, (8, 16), dtype=torch.int32)
    probe.gather_rows(x, i[:, 0])
    probe.take_along(x, i, 0, 3)
    probe.roll(x, -5, 1)
    assert [k.launches for k in probe.KERNELS] == before
    np.testing.assert_array_equal(probe.roll(x, -5, 1).numpy(),
                                  np.roll(x.numpy(), -5, 1))


@pytest.mark.parametrize("tool,kw", [
    (probe_gather, dict(b=512, v=3000, iters=3, widths=(1, 31),
                        tables=(64,), corner=(5000, 31, 700), n=1)),
    (probe_axis0, {}),
    (probe_dyngather, dict(ns=(64,), iters=5, b=256, v=1000, n=1))])
def test_probe_tools_run_on_the_cpu(tool, kw):
    """Each probe tool runs end to end at small sizes on the CPU (the
    plain versions), printing its lines, every check OK."""
    lines = []
    recs = tool.run(torch.device("cpu"), out=lines.append, **kw)
    assert len(lines) == len(recs) and all(r.get("ok", True) for r in recs)
    assert any("OK" in ln for ln in lines)


# ---- P2's and P3's launches, computed in Python (csrc/take_along.cu,
# csrc/roll.cu read them from probe._ProbeLaunch)

I32, U32 = torch.int32, torch.uint32


@pytest.mark.parametrize("shape,want", [
    # T1 (iters 1) and T5's shapes (iters 64)
    ((4096, 128, 0, 1, I32), ("global", 0, 0, (512, 1), 256, 4)),
    ((256, 128, 0, 1, U32), ("global", 0, 0, (32, 1), 256, 4)),
    ((512, 128, 0, 64, I32), ("smem_cols", 8, 16384, (16, 8), 512, 1)),
    ((832, 128, 0, 64, I32), ("smem_cols", 8, 26624, (16, 8), 832, 1)),
    ((4096, 128, 0, 64, I32), ("smem_cols", 8, 131072, (16, 8), 1024, 4)),
    ((4096, 128, 1, 64, I32), ("smem_rows", 32, 16384, (128, 1), 1024, 4)),
    ((512, 128, 1, 64, I32), ("smem_rows", 4, 2048, (128, 1), 512, 1)),
    ((832, 128, 1, 64, I32), ("smem_rows", 7, 3584, (119, 1), 896, 1)),
    ((4096, 128, 1, 1, I32), ("global", 0, 0, (512, 1), 256, 4)),
    # N not a multiple of anything, C % 4 != 0: a ragged last strip
    ((301, 30, 0, 64, I32), ("smem_cols", 8, 9632, (4, 33), 96, 1)),
    ((67, 130, 1, 5, I32), ("smem_rows", 1, 520, (67, 1), 160, 1)),
    # more strips than SMs: one block per strip
    ((64, 1000, 0, 5, I32), ("smem_cols", 8, 2048, (125, 1), 512, 1)),
    # the widest strip of 8 columns, then of 4, then none (L2)
    ((7264, 128, 0, 64, I32), ("smem_cols", 8, 232448, (16, 8), 1024, 4)),
    ((7265, 128, 0, 64, I32), ("smem_cols", 4, 116240, (32, 4), 1024, 4)),
    ((14529, 128, 0, 64, I32), ("global", 0, 0, (1817, 1), 256, 4)),
    ((3, 58113, 1, 64, I32), ("global", 0, 0, (171, 1), 256, 4)),
])
def test_take_along_design(shape, want):
    """P2's design at the probes' shapes and at edge shapes; every
    launch covers each chain once and fits the card."""
    d = probe.take_along_design(*shape)
    assert (d.name, d.strip, d.smem_bytes, d.grid, d.threads,
            d.chains) == want
    n, c, axis = shape[:3]
    assert d.vec == (c % 4 == 0)
    assert d.smem_bytes <= probe.SMEM_BLOCK and d.threads % 32 == 0
    assert d.threads <= 1024 and d.grid[1] <= 65535
    if d.name == "smem_cols":   # strips x parts cover the N k chains
        k = d.strip
        assert d.grid[0] == -(-c // k) and d.smem_bytes == n * k * 4
        assert (d.grid[1] - 1) * d.per_block < n * k <= \
            d.grid[1] * d.per_block
        assert d.grid[0] * d.grid[1] <= max(probe.SMS, d.grid[0])
    elif d.name == "smem_rows":
        assert d.grid[0] * d.per_block >= n > (d.grid[0] - 1) * d.per_block
        assert d.smem_bytes == d.per_block * c * 4
        assert d.grid[0] <= probe.SMS or d.per_block == 1
    else:                       # 4 elements per thread
        assert d.grid[0] * d.threads * 4 >= n * c
    if d.name != "global":      # one chain per thread up to 1024, then
        chains = d.per_block * (1 if d.name == "smem_cols" else c)
        assert d.chains == (1 if chains <= 1024 else 2 if chains <= 2048
                            else 4)                     # 2 or 4 at once
        assert d.threads * d.chains >= min(chains, 4096)


@pytest.mark.parametrize("shape", [
    (2 ** 30 + 1, 1, 0, 1, I32),      # len above the 32-bit reindex limit
    (2, 2 ** 30 + 1, 1, 64, I32),
    (2 ** 16, 2 ** 15, 0, 1, I32),    # 2^31 elements
    (256, 128, 0, 5, U32),            # uint32 takes one step
    (256, 128, 2, 1, I32), (256, 128, 0, 0, I32),
    (256, 128, 0, 1, torch.int64)])
def test_take_along_design_refuses(shape):
    with pytest.raises(ValueError):
        probe.take_along_design(*shape)


def _udiv(n, magic, shift):
    """csrc/probe_launch.cuh::udiv on uint32 arrays."""
    n = n.astype(np.uint64)
    t = (n * np.uint64(magic)) >> np.uint64(32)
    s = t + n
    assert (s < 2 ** 32).all()
    return (s >> np.uint64(shift)).astype(np.uint64)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 100, 128, 130, 832, 4096,
                               14529, 2 ** 30 - 1, 2 ** 30, 2 ** 30 + 3,
                               2 ** 31 - 1])
def test_divider_is_exact(d):
    """The per-launch divider gives n // d for every n < 2^31."""
    r = np.random.default_rng(d)
    n = np.concatenate([
        np.arange(0, 4 * d + 3, max(1, d // 64)), [2 ** 31 - 1, 2 ** 31 - 2],
        r.integers(0, 2 ** 31, 20000), (np.arange(1, 2000) * d) - 1,
        np.arange(1, 2000) * d]).astype(np.uint64)
    n = n[n < 2 ** 31]
    magic, shift = probe.divider(d)
    assert magic < 2 ** 32
    np.testing.assert_array_equal(_udiv(n, magic, shift), n // np.uint64(d))


@pytest.mark.parametrize("length", [1, 3, 128, 512, 4096, 2 ** 30])
def test_reindex_arithmetic_is_a_floor_mod(length):
    """csrc/take_along.cu's reindex, on uint32 as the kernel does it,
    equals (j + a + i) mod len for every int32 a, with j, i in [0, len)."""
    r = np.random.default_rng(length)
    m = 50000
    a = np.concatenate([r.integers(-2 ** 31, 2 ** 31, m), [
        -2 ** 31, 2 ** 31 - 1, -1, 0, length - 1, length, -length,
        -length - 1]]).astype(np.int64)
    j = r.integers(0, length, a.size).astype(np.uint64)
    im = r.integers(0, length, a.size).astype(np.uint64)
    L, M = np.uint64(length), np.uint64(2 ** 32 - 1)
    magic, shift = probe.divider(length)
    ra = (a & 0xFFFFFFFF).astype(np.uint64)            # (unsigned)a
    u = np.where(a < 0, ~ra & M, ra)
    mod = u - _udiv(u, magic, shift) * L
    r_ = np.where(ra < L, ra, np.where(a < 0, L - np.uint64(1) - mod, mod))
    s = j + r_ + im
    assert (s < 2 ** 32).all()
    for _ in range(2):                                  # min(s, s - len)
        s = np.minimum(s, (s - L) & M)
    want = (j.astype(np.int64) + a + im.astype(np.int64)) % length
    np.testing.assert_array_equal(s.astype(np.int64), want)


def _edge_indices(length, dtype, shape, seed):
    """In-range indices with every out-of-range kind planted: for int32
    -1, -3, -len, -len - 1, len, len + 5, 2^31 - 1, -2^31; for uint32
    2^31, 2^31 + 1, 2^32 - 1, 2^32 - len, 2^32 - len - 1, len, len - 1."""
    r = np.random.default_rng(seed)
    idx = r.integers(0, length, shape).astype(np.int64)
    if dtype == np.int32:
        edges = [-1, -3, -length, -length - 1, length, length + 5,
                 2 ** 31 - 1, -2 ** 31]
    else:
        edges = [2 ** 31, 2 ** 31 + 1, 2 ** 32 - 1, 2 ** 32 - length,
                 2 ** 32 - length - 1, length, length - 1]
    flat = idx.reshape(-1)
    at = r.choice(flat.size, 8 * len(edges), replace=False)
    flat[at] = np.resize(edges, at.size)
    return flat.reshape(shape).astype(dtype)


@pytest.mark.parametrize("body,axis,iters,dtype", [
    ("T1", 0, 1, np.int32), ("T1", 0, 1, np.uint32),
    ("T5", 0, 64, np.int32), ("T5", 1, 64, np.int32)])
def test_take_along_out_of_range_matches_pallas(body, axis, iters, dtype):
    """Indices outside [0, len) read what the Pallas bodies read, in
    interpret mode: jnp.take_along_axis counts [-len, 0) from the end,
    reads uint32 as int32, and fills NaN beyond; P2's plain version (the
    kernel's contract) does the same."""
    r = np.random.default_rng(11)
    x = r.uniform(size=(64, 40)).astype(np.float32)
    idx = _edge_indices(x.shape[axis], dtype, x.shape, 12 + axis)
    kern = make_axis(axis) if body == "T1" else make_pallas(axis, iters)
    want = _call(kern, x.shape, x, idx)
    assert np.isnan(want).any() and not np.isnan(want).all()
    got = probe.take_along(torch.from_numpy(x), torch.from_numpy(idx), axis,
                           iters)
    np.testing.assert_array_equal(got.numpy(), want)


def test_take_along_plain_out_of_range():
    """The plain version's index contract, without JAX: [-len, 0) counts
    from the end, outside [-len, len) reads NaN (for good: the sum stays
    NaN), uint32 is read as int32; the rest is unchanged."""
    r = np.random.default_rng(5)
    x = r.uniform(size=(64, 32)).astype(np.float32)
    idx = r.integers(0, 64, x.shape).astype(np.int32)
    bad = np.zeros(x.shape, bool)
    bad[::5, ::3] = True
    idx[bad] = np.where(r.random(int(bad.sum())) < 0.5, -65, 64)
    idx[1::5, ::3] -= 64                       # [-64, 0): from the end
    for iters in (1, 7):
        got = probe.take_along(torch.from_numpy(x), torch.from_numpy(idx),
                               0, iters).numpy()
        assert (np.isnan(got) == bad).all()
        ok_idx = np.where(bad, 0, idx % 64)
        want = probe.take_along(torch.from_numpy(x),
                                torch.from_numpy(ok_idx), 0, iters).numpy()
        np.testing.assert_array_equal(got[~bad], want[~bad])
    for big, nan in ((2 ** 31 + 1, True), (2 ** 32 - 1, False)):
        got = probe.take_along(torch.from_numpy(x), torch.from_numpy(
            np.full(x.shape, big, np.uint32)), 1)
        assert bool(torch.isnan(got).all()) == nan
    np.testing.assert_array_equal(got.numpy(), np.repeat(x[:, -1:], 32, 1))


@pytest.mark.parametrize("length", [1, 3, 64, 4096, 2 ** 30])
def test_first_index_arithmetic(length):
    """csrc/take_along.cu's first_index, on uint32 as the kernel does it:
    raw + (len if int32(raw) < 0), in range exactly where the plain
    version reads x, and then at the plain version's index."""
    r = np.random.default_rng(length)
    raw = np.concatenate([r.integers(0, 2 ** 32, 50000), [
        0, 1, length - 1, length, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1,
        2 ** 32 - 1, 2 ** 32 - length, 2 ** 32 - length - 1]]).astype(
        np.uint64)
    w = (raw + np.where(raw >= 2 ** 31, length, 0)) % 2 ** 32
    s = np.where(raw >= 2 ** 31, raw.astype(np.int64) - 2 ** 32,
                 raw.astype(np.int64))              # int32(raw)
    s = np.where(s < 0, s + length, s)
    ok = (s >= 0) & (s < length)
    np.testing.assert_array_equal(w < length, ok)
    np.testing.assert_array_equal(w[ok].astype(np.int64), s[ok])


@pytest.mark.parametrize("shape,axis,shift,want", [
    ((8, 128), 1, 3, (3, 1, 1)),          # T2: one block of 256
    ((4096, 128), 1, 3, (3, 512, 1)),
    ((4096, 128), 0, -5, (4091, 512, 1)),
    ((37, 131), 1, 1000, (1000 % 131, 5, 0))])
def test_roll_launch(shape, axis, shift, want):
    """P3's launch: the shift taken into [0, len), 4 elements per thread,
    16-byte rows only where C % 4 == 0."""
    p = probe.roll_launch(*shape, axis, shift)
    assert (p.shift, p.grid_x, p.vec) == want
    assert p.threads == 256 and p.grid_x * 1024 >= shape[0] * shape[1]
