"""vpt_tpu_torch — the PyTorch + CUDA port of vpt_tpu.

The JAX package ``vpt_tpu`` is the reference; this package mirrors its
layout (``core/``, ``render/``, ``scene/``, ``volume/``, ``accel/``,
``lights/``, ``app/``, ``tools/``, ``utils/``) so each module's
counterpart is easy to find.  It imports torch, numpy and scipy only —
never jax, never vpt_tpu.

Device work on the main render path runs through three hand-written
kernels (``csrc/``): the fused walk (K1, ``render/fused.py``), primary
ray generation (K2, ``render/renderer.py``) and film accumulation (K3,
``render/film.py``), all CUDA C++; the probe tools run P1-P3
(``ops/probe.py``).  Each wrapper launches its kernel on a CUDA tensor
and calls the plain PyTorch version beside it on a CPU tensor.  Entry
points build on the card unless asked for the CPU (``core/device.py``).
"""
