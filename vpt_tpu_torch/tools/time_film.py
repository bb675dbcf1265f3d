"""Time kernel K3 (film accumulation) on the card at 1080p.

    python -m vpt_tpu_torch.tools.time_film [--calls 200]

On a random 1920x1080 film and sample made on the card from a seed, with
non-finite radiance and alpha planted for the NaN scrub:

* ``warm``: the wrapper ``film.accumulate`` and ``accumulate_plain``
  back to back on the same inputs, as chip_smoke.py's phase 6 times
  them: device µs per call (torch.profiler), event and host µs per call
  (the median of 3 turns of kernel, plain, plain, kernel);
* ``cold``: each call of the wrapper after a 512 MB write that leaves
  none of its 174 MB in the 50 MB L2: the kernel's device µs per call
  (torch.profiler, the kernels whose name holds "film_accumulate");
* ``host``: the wrapper's host µs per call, the inputs' checks, the
  outputs' allocation and the launch.

The kernel's result is held against accumulate_plain (``bit_equal``,
``max_abs``; exit 1 after the report unless bit for bit equal).
Prints one JSON line per case, then the nvidia-smi line.  It calls the
film module's public entry points, so run by its path with another
checkout of the package first on PYTHONPATH it times that checkout.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from vpt_tpu_torch.render import film as film_mod
from vpt_tpu_torch.tools.time_probes import host_us, measure

W, H = 1920, 1080
FIELDS = ("accum", "alpha", "depth", "cost", "trunc")


def inputs(dev, seed=0, hw=(H, W)):
    """(film, value, alpha, depth, cost, trunc) on ``dev``: uniform film
    state and sample, NaN and Inf planted in the radiance, NaN in
    alpha."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)
    film = film_mod.Film(rand(*hw, 3), rand(*hw), rand(*hw), rand(*hw),
                         rand(*hw))
    value = rand(*hw, 3) * 4.0
    value[::17, ::13, 1] = float("nan")
    value[::19, ::11, 2] = float("inf")
    alpha = rand(*hw)
    alpha[::23, ::7] = float("nan")
    return film, value, alpha, rand(*hw), rand(*hw), rand(*hw)


def cold_us(fn, dev, n):
    """Device µs per call of the film kernel in fn(), each call after a
    write of 512 MB (the L2 holds 50 MB)."""
    flush = torch.empty(128 * 2 ** 20, dtype=torch.float32, device=dev)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as pr:
        for _ in range(n):
            flush.fill_(1.0)
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
                for e in pr.key_averages() if "film_accumulate" in e.key)
    return total / n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    n = args.calls
    film, value, alpha, depth, cost, trunc = inputs(dev)
    it = 7

    def kernel():
        return film_mod.accumulate(film, value, alpha, it, depth, cost, trunc)

    def plain():
        return film_mod.accumulate_plain(film, value, alpha, it, depth, cost,
                                         trunc)
    got, want = kernel(), plain()
    equal = all(torch.equal(getattr(got, f), getattr(want, f))
                for f in FIELDS)
    err = max(float((getattr(got, f) - getattr(want, f)).abs().nan_to_num(
        float("inf")).max()) for f in FIELDS)
    del got, want
    route = film_mod.FILM_ACCUMULATE.route
    print(json.dumps({"case": f"film_accumulate {W}x{H} warm", "route": route,
                      "bit_equal": equal, "max_abs": err,
                      **measure({"accumulate": kernel,
                                 "accumulate_plain": plain}, n)}), flush=True)
    print(json.dumps({"case": f"film_accumulate {W}x{H} cold", "route": route,
                      "device_us": cold_us(kernel, dev, n)}), flush=True)
    print(json.dumps({"case": f"film_accumulate {W}x{H} host", "route": route,
                      "host_us": host_us(kernel, n * 5)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    if not equal:
        raise SystemExit("K3 differs from accumulate_plain")


if __name__ == "__main__":
    main()
