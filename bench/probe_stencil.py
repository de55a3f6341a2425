"""Probe: depth-1 Laplace stencil forms against a copy of the same bytes.

Times, on one device, each form of ``models.pipelines.stencil2d`` (the
``roll`` and ``slices`` map_overlap formulations, through the public API
on a persisted input; the roll form also as one whole-array stencil,
``tpu.overlap-method="shard"``) and two whole-array jnp forms, against a
jitted copy that reads and writes the same bytes.  Every time is the median of
repeated calls, each ended by ``block_until_ready``.

    python bench/probe_stencil.py [--n 16384] [--chunk 4096] [--reps 20]

Prints one line per form: median ms, effective GB/s (read + write of the
array), and the share of the copy's rate.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no nvidia-smi"


def _median_ms(fn, reps):
    fn().block_until_ready()  # compile + first run
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn().block_until_ready()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import dask_array_tpu as da
    from dask_array_tpu.models import pipelines as P

    dev = jax.devices()[0]
    n, chunk = args.n, args.chunk
    nbytes = n * n * 4
    print(f"device {dev.platform} {dev.device_kind} | card {_card()} | "
          f"jax {jax.__version__} | {n}x{n} f32 chunk {chunk}", flush=True)

    x = jnp.asarray(np.random.default_rng(0).standard_normal((n, n), np.float32))
    copy = jax.jit(lambda v: v * jnp.float32(1.0000001))

    def slices_whole(v):
        p = jnp.pad(v, 1, mode="symmetric")
        return p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4 * v

    def roll_whole(v):
        return (jnp.roll(v, 1, 0) + jnp.roll(v, -1, 0) + jnp.roll(v, 1, 1)
                + jnp.roll(v, -1, 1) - 4 * v)

    forms = {
        "copy": lambda: copy(x),
        "jnp_pad_slices": (lambda f: lambda: f(x))(jax.jit(slices_whole)),
        "jnp_roll": (lambda f: lambda: f(x))(jax.jit(roll_whole)),
    }
    for form in ("roll", "slices"):
        y = P.stencil2d(n=n, chunk=chunk, form=form, persist=True)
        forms[f"stencil2d_{form}"] = (lambda y: lambda: y.compute_device())(y)
    # the roll form as one whole-array stencil (tpu.overlap-method="shard")
    with da.config.set({"tpu.overlap-method": "shard"}):
        y = P.stencil2d(n=n, chunk=chunk, form="roll", persist=True)
    forms["stencil2d_roll_shard"] = (lambda y: lambda: y.compute_device())(y)

    refs = {}  # one reference per input: the jnp array and the da.random one
    copy_ms = None
    for name, fn in forms.items():
        ms = _median_ms(fn, args.reps)
        if name == "copy":
            copy_ms = ms
        gbps = 2 * nbytes / (ms / 1e3) / 1e9
        print(f"{name:18s} {ms:9.4f} ms  {gbps:8.1f} GB/s  "
              f"{copy_ms / ms:6.3f} of copy | card {_card()}", flush=True)
        if name not in ("copy", "jnp_roll"):  # jnp_roll wraps: a periodic boundary
            got = np.asarray(fn())
            ref = refs.setdefault(name.startswith("stencil2d"), got)
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


if __name__ == "__main__":
    main()
