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
