"""Probe: histogram lanes, compare-accumulate scan against XLA's own.

For each dtype class (f32, f64, int64 data with int64 edges, f32 with
f32 weights, and an int64 bincount) and each size, times on one device:

* ``xla``: ``jnp.histogram`` / ``jnp.bincount`` (searchsorted plus a
  scatter-add);
* ``scan<T>``: a ``lax.scan`` over tiles of ``T`` elements, each compared
  against every edge at once in the data's own dtype, counts taken as the
  first difference of the cumulative counts.

Both lanes are checked against each other and against numpy on the first
million elements.  Each time is the median of repeated calls, each ended
by ``block_until_ready``.

    python bench/probe_histogram.py [--log2n 26 28] [--bins 256] [--reps 10]
"""

from __future__ import annotations

import argparse
import functools
import statistics
import subprocess
import time

import numpy as np


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no nvidia-smi"


def _median_ms(fn, reps):
    fn().block_until_ready()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn().block_until_ready()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2n", type=int, nargs="+", default=[26, 28])
    ap.add_argument("--bins", type=int, default=256)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--tiles", type=int, nargs="+", default=[128 * 1024, 1024 * 1024])
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    dev = jax.devices()[0]
    print(f"device {dev.platform} {dev.device_kind} | card {_card()} | jax {jax.__version__}",
          flush=True)
    nb = args.bins

    @functools.partial(jax.jit, static_argnames=("tile", "weighted"))
    def scan_hist(data, edges_excl, weights, tile, weighted):
        n_tiles = data.shape[0] // tile
        xs = (data.reshape(n_tiles, tile),)
        if weighted:
            xs += (weights.reshape(n_tiles, tile),)
        acc_dt = jnp.float64 if weighted else jnp.int32

        def body(acc, t):
            cmp = t[0][:, None] < edges_excl[None, :]
            if weighted:
                part = jnp.sum(jnp.where(cmp, t[1][:, None].astype(acc_dt), 0), axis=0)
            else:
                part = jnp.sum(cmp, axis=0, dtype=acc_dt)
            return acc + part, None

        cum, _ = jax.lax.scan(body, jnp.zeros(edges_excl.shape, acc_dt), xs)
        return cum[1:] - cum[:-1]

    def last_edge_excl(e):
        e = e.copy()
        if e.dtype.kind in "iu":
            e[-1] += 1
        else:
            e[-1] = np.nextafter(e[-1], np.inf)
        return e

    rng = np.random.default_rng(0)
    for log2n in args.log2n:
        n = 1 << log2n
        cases = {}
        f32 = rng.standard_normal(n, dtype=np.float32)
        cases["f32"] = (f32, np.linspace(-4, 4, nb + 1, dtype=np.float32), None)
        cases["f64"] = (f32.astype(np.float64) * 1.0000001,
                        np.linspace(-4, 4, nb + 1), None)
        i64 = rng.integers(-(1 << 40), 1 << 40, n, dtype=np.int64)
        cases["int64"] = (i64, np.linspace(-(1 << 40), 1 << 40, nb + 1).astype(np.int64), None)
        cases["f32_weighted"] = (f32, cases["f32"][1], rng.random(n, dtype=np.float32))
        cases["bincount_int64"] = (rng.integers(0, nb, n, dtype=np.int64),
                                   np.arange(nb + 1, dtype=np.int64), None)
        del f32, i64
        for name, (data_h, edges_h, w_h) in cases.items():
            data = jax.device_put(data_h)
            w = None if w_h is None else jax.device_put(w_h)
            edges = jnp.asarray(edges_h)
            excl = jnp.asarray(last_edge_excl(edges_h))
            m = 1 << 20
            want = np.histogram(data_h[:m], bins=edges_h,
                                weights=None if w_h is None else w_h[:m].astype(np.float64))[0]
            if name.startswith("bincount"):
                xla = jax.jit(lambda d: jnp.bincount(d, length=nb))
                run_xla = (lambda f: lambda: f(data))(xla)
                got = np.asarray(xla(data[:m]))
            else:
                xla = jax.jit(lambda d, e, w: jnp.histogram(d, bins=e, weights=w)[0])
                run_xla = (lambda f: lambda: f(data, edges, w))(xla)
                got = np.asarray(xla(data[:m], edges, None if w is None else w[:m]))
            np.testing.assert_allclose(got, want, rtol=1e-5)
            ms = _median_ms(run_xla, args.reps)
            print(f"2^{log2n} {name:15s} xla      {ms:9.3f} ms | card {_card()}", flush=True)
            for tile in args.tiles:
                if n % tile:
                    continue
                wt = w if w is not None else data
                run = (lambda t: lambda: scan_hist(data, excl, wt, tile=t,
                                                   weighted=w is not None))(tile)
                got = np.asarray(scan_hist(data[:m], excl, wt[:m], tile=min(tile, m),
                                           weighted=w is not None))
                np.testing.assert_allclose(got, want, rtol=1e-5)
                ms = _median_ms(run, args.reps)
                print(f"2^{log2n} {name:15s} scan{tile // 1024}K {ms:9.3f} ms | card {_card()}",
                      flush=True)
            del data, w


if __name__ == "__main__":
    main()
