"""vpt_tpu_torch — the PyTorch + CUDA port of vpt_tpu.

The JAX package ``vpt_tpu`` is the reference; this package mirrors its
layout (``core/``, ``render/``, ``scene/``, ``volume/``, ``accel/``,
``lights/``, ``sky/``, ``app/``, ``tools/``, ``utils/``) so each
module's counterpart is easy to find.  It imports torch, numpy and
scipy only — never jax, never vpt_tpu.

Device work on the render path runs through four hand-written kernels
(``csrc/``): the fused walk (K1, ``render/fused.py``), primary ray
generation (K2, ``render/renderer.py``), film accumulation (K3,
``render/film.py``) and the terminal environment, HDRI or the simple
sky (K4, ``render/integrator.py``), all CUDA C++; the probe tools run
P1-P3
(``ops/probe.py``).  Each wrapper launches its kernel on a CUDA tensor
and calls the plain PyTorch version beside it on a CPU tensor.  Entry
points build on the card unless asked for the CPU (``core/device.py``).
"""
