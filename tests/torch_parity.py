"""Shared helpers of the tests that hold vpt_tpu_torch against vpt_tpu:
hand a JAX scene's leaves over as numpy arrays, and score ray-by-ray
agreement."""

from __future__ import annotations

import dataclasses

import numpy as np


def jax_scene_arrays(scene) -> dict:
    """{dotted leaf name: numpy array} of a vpt_tpu Scene (None leaves
    and nested optional tables are skipped)."""
    out = {}

    def walk(obj, prefix):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            name = f"{prefix}{f.name}"
            if v is None:
                continue
            if dataclasses.is_dataclass(v):
                walk(v, name + ".")
            elif isinstance(v, int):
                out[name] = v
            else:
                try:
                    out[name] = np.asarray(v)
                except (TypeError, ValueError):
                    continue
    walk(scene, "")
    return out


def _radiance_ok(La, Lb, rtol, atol):
    return np.all(np.abs(La - Lb) <= atol + rtol * np.abs(Lb), axis=-1)


def radiance_share(a, b, rtol=1e-4, atol=1e-6):
    """Share of pixels whose (..., 3) radiance in ``a`` agrees with
    ``b`` within rtol + atol, agreement()'s radiance test."""
    return float(_radiance_ok(np.asarray(a, np.float64),
                              np.asarray(b, np.float64), rtol, atol).mean())


def agreement(a, b, rtol=1e-4, atol=1e-6, alpha_tol=1e-5):
    """Per-ray agreement of two (L, alpha, cost, unfinished, depth)
    tuples: L within rtol + atol, alpha within alpha_tol, cost and
    unfinished exact.  Returns (share of rays agreeing, relative
    difference of the image means)."""
    La, aa, ca, ua = (np.asarray(x, np.float64) for x in a[:4])
    Lb, ab, cb, ub = (np.asarray(x, np.float64) for x in b[:4])
    ok = _radiance_ok(La, Lb, rtol, atol)
    ok &= np.abs(aa - ab) <= alpha_tol
    ok &= (ca == cb) & (ua == ub)
    mean_b = float(Lb.mean())
    rel = abs(float(La.mean()) - mean_b) / max(abs(mean_b), 1e-12)
    return float(ok.mean()), rel
