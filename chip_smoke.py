"""Smoke run of the lazy-array main path on NVIDIA GPUs.

    python chip_smoke.py             one card: every single-card phase
    python chip_smoke.py --multi     four cards: the mesh phases only
    python chip_smoke.py --rehearse  the single-card phases at a tiny size
                                     on whatever device JAX finds

Every phase builds lazy ``da`` expressions through the public API and
runs them twice: the first call (build, optimize, compile, run) is
reported as set-up, the second is timed to ``block_until_ready``.  Then
it compares the result with a plain reference and prints one line: the
phase, shapes and dtype, the device's ``peak_bytes_in_use`` so far, both
times, the error against its tolerance, and the card's name and power
limit.  A phase that fails raises, and the script exits non-zero without
printing the last line, which is one JSON object naming the device.

The data are random, made from ``--seed``.  One process drives the
card(s) for the whole run.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

import dask_array_tpu as da


@dataclasses.dataclass(frozen=True)
class Sizes:
    flag_rows: int
    flag_cols: int
    flag_b_rows: int
    flag_chunk: int
    flag_check_rows: int
    red_n: int
    red_chunk: int
    mm16_n: int
    mm16_chunk: int
    mm32_n: int
    mm32_chunk: int
    mm32_check_rows: int
    sten_n: int
    sten_chunk: int
    ts_rows: int
    ts_cols: int
    ts_chunk: int
    rel_n: int
    rel_chunk: int
    hist_log2n: int
    hist_bins: int
    hist_chunk: int
    fft_n: int
    la_n: int
    la_chunk: int
    ooc_budget: str


CARD = Sizes(
    flag_rows=131072, flag_cols=4096, flag_b_rows=2048, flag_chunk=16384,
    flag_check_rows=4096,
    red_n=32768, red_chunk=4096,
    mm16_n=16384, mm16_chunk=2048, mm32_n=8192, mm32_chunk=1024, mm32_check_rows=512,
    sten_n=16384, sten_chunk=4096,
    ts_rows=4_194_304, ts_cols=128, ts_chunk=524_288,
    rel_n=32768, rel_chunk=1024,
    hist_log2n=28, hist_bins=256, hist_chunk=1 << 25,
    fft_n=8192, la_n=4096, la_chunk=1024,
    ooc_budget="1 GiB",
)

TINY = Sizes(
    flag_rows=512, flag_cols=64, flag_b_rows=32, flag_chunk=128, flag_check_rows=128,
    red_n=256, red_chunk=64,
    mm16_n=128, mm16_chunk=32, mm32_n=128, mm32_chunk=32, mm32_check_rows=32,
    sten_n=128, sten_chunk=32,
    ts_rows=4096, ts_cols=16, ts_chunk=512,
    rel_n=256, rel_chunk=32,
    hist_log2n=14, hist_bins=16, hist_chunk=1 << 12,
    fft_n=64, la_n=128, la_chunk=32,
    ooc_budget="64 KiB",
)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"
    return out[0] if out else "no nvidia-smi"


def relerr(got, want) -> float:
    """max |got - want| / max |want|, in float64 on the host."""
    got = np.asarray(got, dtype=np.complex128 if np.iscomplexobj(got) else np.float64)
    want = np.asarray(want, dtype=got.dtype)
    if got.shape != want.shape:
        raise AssertionError(f"shape {got.shape} != {want.shape}")
    if not np.all(np.isfinite(got)):
        return float("inf")
    scale = float(np.max(np.abs(want))) if want.size else 1.0
    return float(np.max(np.abs(got - want))) / (scale or 1.0) if got.size else 0.0


def device_relerr(got, want) -> float:
    """``relerr`` computed on the device, for arrays too large to copy."""
    import jax.numpy as jnp

    if got.shape != want.shape:
        raise AssertionError(f"shape {got.shape} != {want.shape}")
    g, w = got.astype(jnp.float32), want.astype(jnp.float32)
    if not bool(jnp.all(jnp.isfinite(g))):
        return float("inf")
    return float(jnp.max(jnp.abs(g - w)) / jnp.maximum(jnp.max(jnp.abs(w)), 1e-30))


class Smoke:
    """Runs phases, times them and prints their lines."""

    def __init__(self, sizes: Sizes, seed: int, card: str):
        self.s = sizes
        self.seed = seed
        self.card = card

    def rng(self, k=0):
        return np.random.default_rng(self.seed + k)

    @staticmethod
    def twice(fn):
        """(output, set-up s, steady s): compile + run, then a timed run."""
        import jax

        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        return out, setup, time.perf_counter() - t0

    def line(self, phase, what, setup, steady, checks):
        """Print the phase's line; raise if any (name, err, tol) fails."""
        import jax

        stats = jax.devices()[0].memory_stats() or {}
        peak = stats.get("peak_bytes_in_use")
        errs = " ".join(f"{n}={e:.3g}(tol {t:g})" for n, e, t in checks)
        print(
            f"[{phase}] {what} | peak_bytes_in_use {peak if peak is not None else 'n/a'}"
            f" | setup {setup:.3f} s | steady {steady * 1e3:.3f} ms | {errs}"
            f" | card {self.card}",
            flush=True,
        )
        bad = [(n, e, t) for n, e, t in checks if not (e <= t)]
        if bad:
            raise AssertionError(f"{phase}: out of tolerance {bad}")

    # -- phases ------------------------------------------------------------

    def device(self):
        import jax

        from dask_array_tpu import native

        dev = jax.devices()[0]
        print(
            f"[device] jax {jax.__version__} | {dev.platform} {dev.device_kind} x"
            f"{len(jax.devices())} | XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
            f" | compile cache {jax.config.jax_compilation_cache_dir}"
            f" | native plankit {'engaged' if native.available() else 'Python fallback'}"
            f" | card {self.card}",
            flush=True,
        )

    def readme(self):
        from dask_array_tpu.models import pipelines as P

        y = P.readme_example(n=1000, chunk=100)
        opt = y.optimize().expr
        kinds = {type(node).__name__ for node in opt.walk()}
        leaves = [node for node in opt.walk() if not node.dependencies()]
        if "FusedBlockwise" not in kinds or any(tuple(l.shape) != (100, 100) for l in leaves):
            raise AssertionError(f"readme: optimized tree {sorted(kinds)}, leaves "
                                 f"{[tuple(l.shape) for l in leaves]}")
        out, setup, steady = self.twice(y.compute_device)
        err = float(np.max(np.abs(np.asarray(out) - 2.0)))
        self.line("readme", "(x + x.T)[:100, :100] of ones(1000x1000) f64, FusedBlockwise "
                  "over 100x100 leaves", setup, steady, [("max|y-2|", err, 0.0)])

    def flagship(self):
        import jax
        import jax.numpy as jnp

        from dask_array_tpu.models.pipelines import normalize_contract

        s = self.s
        rng = self.rng(1)
        a_np = rng.standard_normal((s.flag_rows, s.flag_cols), dtype=np.float32)
        b_np = rng.standard_normal((s.flag_b_rows, s.flag_cols), dtype=np.float32)

        def run():
            a = da.from_array(a_np, chunks=(s.flag_chunk, s.flag_cols))
            b = da.from_array(b_np, chunks=(s.flag_b_rows, s.flag_cols))
            return normalize_contract(a, b).compute_device()

        out, setup, steady = self.twice(run)
        with jax.default_matmul_precision("highest"):
            ref = jax.jit(normalize_contract)(jnp.asarray(a_np), jnp.asarray(b_np))
        e_jnp = device_relerr(out, ref)
        del ref
        # float64 on a row slice, with the statistics of the full columns
        mean = a_np.mean(axis=0, dtype=np.float64)
        std = a_np.std(axis=0, dtype=np.float64)
        k = s.flag_check_rows
        scaled = (a_np[:k].astype(np.float64) - mean) / (std + 1e-6)
        y = scaled @ b_np.astype(np.float64).T
        e_f64 = relerr(np.asarray(out[:k]), (y * y).sum(axis=1))
        self.line(
            "flagship",
            f"normalize_contract a {s.flag_rows}x{s.flag_cols} f32 (host, from_array) "
            f"b {s.flag_b_rows}x{s.flag_cols} f32, precision highest",
            setup, steady,
            # f32 sums of 4096-long dots, in another order than the reference
            [("vs jnp", e_jnp, 1e-4), (f"vs f64 rows[:{k}]", e_f64, 1e-4)],
        )

    def reductions(self):
        s = self.s
        x = da.random.default_rng(self.seed).standard_normal(
            (s.red_n, s.red_n), dtype="float32", chunks=s.red_chunk
        ).persist()

        def run():
            return da.compute(
                x.sum(axis=0, split_every=4), x.mean(axis=1, split_every=4),
                x.std(split_every=4),
            )

        (s0, m1, sd), setup, steady = self.twice(run)
        buf = x.compute_device()
        ref = (buf.sum(axis=0), buf.mean(axis=1), buf.std())
        host = np.asarray(buf)
        del buf
        f64 = (host.sum(axis=0, dtype=np.float64), host.mean(axis=1, dtype=np.float64),
               host.std(dtype=np.float64))
        del host
        checks = []
        for name, got, r, w in zip(("sum(0)", "mean(1)", "std"), (s0, m1, sd), ref, f64):
            # f32 tree sums of 32768 values against one-pass sums
            checks.append((f"{name} vs jnp", relerr(got, np.asarray(r)), 1e-4))
            checks.append((f"{name} vs f64", relerr(got, w), 1e-4))
        self.line(
            "reductions",
            f"sum(0), mean(1), std split_every=4 of persisted {s.red_n}x{s.red_n} f32 "
            f"chunks {s.red_chunk}",
            setup, steady, checks,
        )

    def matmul(self):
        import jax.numpy as jnp

        from dask_array_tpu.models import pipelines as P

        s = self.s
        with da.config.set({"tpu.matmul-precision": "default"}):
            y = P.blocked_matmul(n=s.mm16_n, chunk=s.mm16_chunk, dtype="bfloat16", seed=self.seed)
            out, setup, steady = self.twice(y.compute_device)
        rng = np.random.default_rng(self.seed)  # blocked_matmul's own draws
        a = jnp.asarray(rng.standard_normal((s.mm16_n, s.mm16_n)).astype(jnp.bfloat16))
        b = jnp.asarray(rng.standard_normal((s.mm16_n, s.mm16_n)).astype(jnp.bfloat16))
        ref = jnp.dot(a, b, preferred_element_type=jnp.float32)
        del a, b
        e = device_relerr(out, ref)
        del out, ref
        self.line(
            "matmul",
            f"{s.mm16_n}^2 bf16 chunks {s.mm16_chunk} @ {s.mm16_chunk // 2}, precision "
            "default",
            setup, steady,
            # bf16 output rounding (2^-8) and tensor-core accumulation order
            [("vs jnp.dot f32-accumulated", e, 1e-2)],
        )

        y = P.blocked_matmul(n=s.mm32_n, chunk=s.mm32_chunk, dtype="float32", seed=self.seed)
        out, setup, steady = self.twice(y.compute_device)
        rng = np.random.default_rng(self.seed)
        a = rng.standard_normal((s.mm32_n, s.mm32_n)).astype(np.float32)
        b = rng.standard_normal((s.mm32_n, s.mm32_n)).astype(np.float32)
        k = s.mm32_check_rows
        want = a[:k].astype(np.float64) @ b.astype(np.float64)
        self.line(
            "matmul",
            f"{s.mm32_n}^2 f32 chunks {s.mm32_chunk} @ {s.mm32_chunk // 2}, precision highest",
            setup, steady,
            # full f32 products (no TF32), summed in another order
            [(f"vs f64 rows[:{k}]", relerr(np.asarray(out[:k]), want), 1e-5)],
        )

    def stencil(self):
        from dask_array_tpu.models import pipelines as P

        s = self.s
        x = np.asarray(
            da.random.default_rng(self.seed).standard_normal(
                (s.sten_n, s.sten_n), dtype="float32", chunks=s.sten_chunk
            ).compute()
        )
        p = np.pad(x, 1, mode="symmetric")  # map_overlap's reflect
        want = p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4 * x
        del p, x
        for form in ("roll", "slices"):
            y = P.stencil2d(n=s.sten_n, chunk=s.sten_chunk, seed=self.seed, form=form,
                            persist=True)
            out, setup, steady = self.twice(y.compute_device)
            self.line(
                "stencil",
                f"stencil2d form={form} {s.sten_n}^2 f32 chunks {s.sten_chunk} depth 1 reflect",
                setup, steady,
                [("vs numpy pad+slices", relerr(np.asarray(out), want), 1e-6)],
            )
            del y, out

    def tsqr_svd(self):
        import jax
        import jax.numpy as jnp

        s = self.s
        x = da.random.default_rng(self.seed).standard_normal(
            (s.ts_rows, s.ts_cols), dtype="float32", chunks=(s.ts_chunk, s.ts_cols)
        ).persist()
        u, sv, vh = da.linalg.svd(x)
        (u_d, s_d, vh_d), setup, steady = self.twice(lambda: da.compute(u, sv, vh))
        a = x.compute_device()
        a_h = np.asarray(a).astype(np.float64)
        s_want = np.sqrt(np.linalg.eigvalsh(a_h.T @ a_h))[::-1]
        del a_h
        with jax.default_matmul_precision("highest"):
            u_j = jnp.asarray(u_d)
            ortho = float(jnp.max(jnp.abs(u_j.T @ u_j - jnp.eye(s.ts_cols))))
            rec = jnp.linalg.norm((u_j * jnp.asarray(s_d)) @ jnp.asarray(vh_d) - a)
            recon = float(rec / jnp.linalg.norm(a))
        self.line(
            "tsqr_svd",
            f"svd of {s.ts_rows}x{s.ts_cols} f32 chunks {s.ts_chunk} rows",
            setup, steady,
            # CholeskyQR3 and a Gram eigensolve in f32
            [("s vs sqrt(eigvalsh(AtA)) f64", relerr(s_d, s_want), 1e-4),
             ("max|UtU-I|", ortho, 1e-4), ("|USVh-A|/|A|", recon, 1e-4)],
        )

    def relayout(self):
        import jax.numpy as jnp

        from dask_array_tpu.models import pipelines as P

        s = self.s
        y = P.rechunk_relayout(n=s.rel_n, chunk=s.rel_chunk, seed=self.seed, persist=True)
        out, setup, steady = self.twice(y.compute_device)
        x = da.random.default_rng(self.seed).standard_normal(
            (s.rel_n, s.rel_n), dtype="float32", chunks=(s.rel_chunk, s.rel_n)
        ).compute_device()
        exact = bool(jnp.array_equal(out, x.T))
        self.line(
            "relayout",
            f"rechunk_relayout {s.rel_n}^2 f32 chunks ({s.rel_chunk}, {s.rel_n}), persisted",
            setup, steady, [("differs from jnp transpose", 0.0 if exact else 1.0, 0.0)],
        )

    def histogram(self):
        s = self.s
        n = 1 << s.hist_log2n
        nb = s.hist_bins
        rng = self.rng(2)
        f32 = rng.standard_normal(n, dtype=np.float32)
        cases = [
            ("f32", f32, np.linspace(-4, 4, nb + 1, dtype=np.float32), None),
            ("f64", f32.astype(np.float64) * (1 + 2**-30), np.linspace(-4, 4, nb + 1), None),
            ("int64/int64 edges", rng.integers(-(1 << 40), 1 << 40, n),
             np.linspace(-(1 << 40), 1 << 40, nb + 1).astype(np.int64), None),
            ("f32 weighted f32", f32, np.linspace(-4, 4, nb + 1, dtype=np.float32),
             rng.random(n, dtype=np.float32)),
            ("f32 weighted f64", f32, np.linspace(-4, 4, nb + 1, dtype=np.float32),
             rng.random(n)),
        ]
        for name, data, edges, w in cases:
            d = da.from_array(data, chunks=s.hist_chunk)
            dw = None if w is None else da.from_array(w, chunks=s.hist_chunk)
            h, _ = da.histogram(d, bins=edges, weights=dw)
            out, setup, steady = self.twice(h.compute_device)
            want = _np_histogram(data, edges, w)
            got = np.asarray(out)
            if w is None:
                checks = [("counts differing from numpy", float(np.sum(got != want)), 0.0)]
            else:
                # weighted sums, accumulated in another order
                checks = [("weighted vs numpy f64", relerr(got, want), 1e-5)]
            self.line("histogram", f"{name}: 2^{s.hist_log2n} elements, {nb} bins",
                      setup, steady, checks)
        ints = rng.integers(0, nb, n)
        c = da.bincount(da.from_array(ints, chunks=s.hist_chunk), minlength=nb)
        out, setup, steady = self.twice(c.compute)
        self.line("histogram", f"bincount int64: 2^{s.hist_log2n} elements, {nb} bins",
                  setup, steady,
                  [("counts differing from numpy",
                    float(np.sum(np.asarray(out) != np.bincount(ints, minlength=nb))), 0.0)])

    def f64_complex(self):
        s = self.s
        rng = self.rng(3)
        z = rng.standard_normal((s.fft_n, s.fft_n)) + 1j * rng.standard_normal((s.fft_n, s.fft_n))
        for dt, tol in ((np.complex64, 1e-5), (np.complex128, 1e-12)):
            # O(log n) rounding growth of the FFT in the input's precision
            zz = z.astype(dt)
            f = da.fft.fft2(da.from_array(zz, chunks=-1))
            out, setup, steady = self.twice(f.compute_device)
            self.line("f64_complex", f"fft2 {s.fft_n}^2 {np.dtype(dt).name}", setup, steady,
                      [("vs numpy.fft", relerr(np.asarray(out), np.fft.fft2(zz)), tol)])
        del z
        n, c = s.la_n, s.la_chunk
        a_np = rng.standard_normal((n, n))
        b_np = rng.standard_normal((n, 2))
        spd = a_np @ a_np.T + n * np.eye(n)
        a = da.from_array(a_np, chunks=c)
        what = f"{n}^2 f64 chunks {c}"
        x, setup, steady = self.twice(da.linalg.solve(a, da.from_array(b_np, chunks=c)).compute)
        self.line("f64_complex", f"solve {what}", setup, steady,
                  # backward error, and forward error within cond(A) * eps
                  [("|Ax-b|/(|A||x|)", float(np.linalg.norm(a_np @ x - b_np)
                                             / (np.linalg.norm(a_np) * np.linalg.norm(x))), 1e-14),
                   ("vs numpy", relerr(x, np.linalg.solve(a_np, b_np)), 1e-8)])
        # backward error of a factorisation: a modest multiple of n * eps
        fact_tol = 10 * n * np.finfo(np.float64).eps
        (p, l, u), setup, steady = self.twice(lambda: da.compute(*da.linalg.lu(a)))
        self.line("f64_complex", f"lu {what}", setup, steady,
                  [("|PLU-A|/|A|", relerr(p @ l @ u, a_np), fact_tol),
                   ("max|triu(L,1)|+max|tril(U,-1)|",
                    float(np.abs(np.triu(l, 1)).max() + np.abs(np.tril(u, -1)).max()), 0.0)])
        lc, setup, steady = self.twice(
            da.linalg.cholesky(da.from_array(spd, chunks=c), lower=True).compute)
        self.line("f64_complex", f"cholesky {what}", setup, steady,
                  [("vs numpy", relerr(lc, np.linalg.cholesky(spd)), 1e-12)])
        (q, r), setup, steady = self.twice(lambda: da.compute(*da.linalg.qr(a)))
        self.line("f64_complex", f"qr {what}", setup, steady,
                  [("|QR-A|/|A|", relerr(q @ r, a_np), fact_tol),
                   ("max|QtQ-I|", float(np.abs(q.T @ q - np.eye(n)).max()), fact_tol)])

    def outofcore(self):
        from dask_array_tpu import _streaming

        s = self.s
        host = self.rng(4).standard_normal((s.red_n, s.red_n), dtype=np.float32)
        x = da.from_array(host, chunks=s.red_chunk)
        exprs = {
            "sum(0)": x.sum(axis=0, split_every=4),
            "mean(1)": x.mean(axis=1, split_every=4),
            "std": x.std(split_every=4),
        }
        incore = {k: np.asarray(v.compute()) for k, v in exprs.items()}
        print(f"[outofcore] automatic budget {_streaming._budget()} bytes | card {self.card}",
              flush=True)
        cfg = {"tpu.out-of-core": "force", "tpu.memory-budget": s.ooc_budget}
        for name, expr in exprs.items():
            with da.config.set(cfg):
                before = dict(_streaming.STREAMED)
                out, setup, steady = self.twice(expr.compute)
                panels = (_streaming.STREAMED["panels"] - before["panels"]) // 2
                streamed = _streaming.STREAMED["count"] > before["count"]
            if name != "std" and not streamed:
                raise AssertionError(f"outofcore {name}: the streaming lane did not engage")
            self.line(
                "outofcore",
                f"{name} of host {s.red_n}x{s.red_n} f32, force, budget {s.ooc_budget}: "
                f"{'streamed in ' + str(panels) + ' panels' if streamed else 'in-core (lane declines)'}",
                setup, steady,
                # panel partials combine in another order than the in-core tree
                [("vs in-core", relerr(out, incore[name]), 1e-5)],
            )


def _np_histogram(data, edges, weights=None):
    """numpy's histogram semantics by searchsorted + bincount (O(n log bins),
    where ``np.histogram`` with explicit edges sorts the data)."""
    nb = len(edges) - 1
    idx = np.searchsorted(edges, data, side="right") - 1
    idx[data == edges[-1]] = nb - 1  # closed last bin
    ok = (idx >= 0) & (idx < nb)  # NaN sorts past the last edge
    return np.bincount(idx[ok], weights=None if weights is None else weights[ok], minlength=nb)


SINGLE_CARD = ("device", "readme", "flagship", "reductions", "matmul", "stencil", "tsqr_svd",
               "relayout", "histogram", "f64_complex", "outofcore")


def run_single(sizes: Sizes, seed: int, card: str, phases=SINGLE_CARD):
    smoke = Smoke(sizes, seed, card)
    for name in phases:
        getattr(smoke, name)()
        gc.collect()


def rehearse(phases=SINGLE_CARD, seed=0):
    """The single-card phases at the tiny size on JAX's default device."""
    run_single(TINY, seed, card_line(), phases)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true", help="the mesh phases on four cards")
    ap.add_argument("--rehearse", action="store_true",
                    help="the single-card phases at a tiny size on any device")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    want = 4 if args.multi else 1
    if not args.rehearse and (devices[0].platform != "gpu" or len(devices) < want):
        print(f"chip_smoke: needs {want} GPU(s); JAX finds {devices}", file=sys.stderr)
        return 2
    card = card_line()
    if args.multi:
        import __graft_entry__

        __graft_entry__._dryrun_body(4, platform="gpu", size="card", multislice=False,
                                     card=card)
    elif args.rehearse:
        rehearse(seed=args.seed)
    else:
        run_single(CARD, args.seed, card)
    print(card)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
