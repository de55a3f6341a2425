"""Random number generation: Generator / default_rng / RandomState / choice.

Parity: ``/root/reference/dask_array/random/`` (``Generator`` with ~30
distributions over a fusable ``Random(IO)`` leaf with per-block spawned
bit-generators, ``random/_expr.py:29``) — fresh implementation.

XLA-first: each block draws from ``jax.random.fold_in(base_key,
linear_block_index)`` — the counter-based analog of the reference's
spawned generators: values are deterministic per (seed, chunk-grid),
independent of execution order, and generated on-device (no host RNG, no
transfers).
"""

from __future__ import annotations

import functools
from numbers import Integral

import numpy as np

from dask_array_tpu._chunks import normalize_chunks
from dask_array_tpu._executor import BlockView, iter_block_indices
from dask_array_tpu._expr import ArrayExpr


def _jr():
    import jax.random as jr

    return jr


def _jnp():
    import jax.numpy as jnp

    return jnp


# distributions whose jax sampler requires threefry keys
_THREEFRY_ONLY = {
    "poisson",
    "negative_binomial",
    "noncentral_chisquare",  # Poisson mixture
    "noncentral_f",
}


class Random(ArrayExpr):
    """A lazy random leaf: one folded PRNG key per block."""

    _parameters = ("dist", "seed", "chunks_", "_dtype", "params")
    _defaults = {"params": ()}

    _fusable_leaf = True

    def _name_prefix(self):
        return f"random-{self.dist}"

    @property
    def chunks(self):
        return self.chunks_

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.chunks_), dtype=self._dtype)

    def _block_shape(self, idx):
        return tuple(self.chunks_[ax][i] for ax, i in enumerate(idx))

    def _build(self, ctx):
        from dask_array_tpu import config

        jr = _jr()
        impl = config.get("tpu.prng-impl", "rbg")
        if self.dist in _THREEFRY_ONLY:
            impl = "threefry2x32"
        base = jr.key(self.seed, impl=impl)
        params = dict(self.params or ())
        raw_kernel = _kernels()[self.dist]
        dtype = np.dtype(self._dtype)
        gen_dtype = dtype
        if (
            dtype == np.float64
            and config.get("tpu.random-precision", "float32") == "float32"
        ):
            # tpu.random-precision: sample at f32 and upcast
            gen_dtype = np.dtype("float32")

        # One kernel call for the WHOLE array.  Unlike the reference's
        # per-block spawned bit-generators (random/_expr.py:29), values
        # depend only on (seed, shape) — never on the chunk grid — so
        # rechunking a random array preserves its values, and generation is
        # shard-parallelized by XLA on a mesh.  (Per-block keying via
        # vmap(fold_in) is unsound with the fast "rbg" PRNG: vmapped rbg
        # sampling ignores the batched key.)
        from dask_array_tpu._chunks import is_float_dtype

        gd = gen_dtype if is_float_dtype(dtype) else dtype
        dense = raw_kernel(base, self.shape, gd, params)
        if dense.dtype != dtype:
            dense = dense.astype(dtype)
        return BlockView(self.chunks_, dense=dense)

    def _accept_rechunk(self, target_chunks):
        # values are chunk-grid-independent: absorb rechunks outright
        return type(self)(self.dist, self.seed, tuple(target_chunks), self._dtype, self.params)


def _float_kernel(fn, needs_dtype=True):
    def kernel(key, shape, dtype, params):
        jnp = _jnp()
        if needs_dtype:
            from dask_array_tpu._chunks import is_float_dtype

            out = fn(key, shape=shape, dtype=dtype if is_float_dtype(dtype) else np.float64, **params)
        else:
            out = fn(key, shape=shape, **params)
        if out.dtype != dtype:
            out = out.astype(dtype)
        return out

    return kernel


def _make_kernels():
    jr = _jr()
    jnp = _jnp()

    def uniform(key, shape, dtype, p):
        low = p.get("low", 0.0)
        high = p.get("high", 1.0)
        return jr.uniform(key, shape, dtype=dtype, minval=low, maxval=high)

    def normal(key, shape, dtype, p):
        loc = p.get("loc", 0.0)
        scale = p.get("scale", 1.0)
        return loc + scale * jr.normal(key, shape, dtype=dtype)

    def standard_normal(key, shape, dtype, p):
        return jr.normal(key, shape, dtype=dtype)

    def integers(key, shape, dtype, p):
        return jr.randint(key, shape, p["low"], p["high"], dtype=dtype)

    def beta(key, shape, dtype, p):
        return jr.beta(key, p["a"], p["b"], shape, dtype=dtype)

    def binomial(key, shape, dtype, p):
        return jr.binomial(key, p["n"], p["p"], shape=shape).astype(dtype)

    def chisquare(key, shape, dtype, p):
        return jr.chisquare(key, p["df"], shape=shape, dtype=dtype)

    def exponential(key, shape, dtype, p):
        return p.get("scale", 1.0) * jr.exponential(key, shape, dtype=dtype)

    def standard_exponential(key, shape, dtype, p):
        return jr.exponential(key, shape, dtype=dtype)

    def f(key, shape, dtype, p):
        return jr.f(key, p["dfnum"], p["dfden"], shape=shape, dtype=dtype)

    def gamma(key, shape, dtype, p):
        return p.get("scale", 1.0) * jr.gamma(key, p["shape"], shape=shape, dtype=dtype)

    def standard_gamma(key, shape, dtype, p):
        return jr.gamma(key, p["shape"], shape=shape, dtype=dtype)

    def geometric(key, shape, dtype, p):
        return jr.geometric(key, p["p"], shape=shape).astype(dtype)

    def gumbel(key, shape, dtype, p):
        return p.get("loc", 0.0) + p.get("scale", 1.0) * jr.gumbel(key, shape, dtype=dtype)

    def laplace(key, shape, dtype, p):
        return p.get("loc", 0.0) + p.get("scale", 1.0) * jr.laplace(key, shape, dtype=dtype)

    def logistic(key, shape, dtype, p):
        return p.get("loc", 0.0) + p.get("scale", 1.0) * jr.logistic(key, shape, dtype=dtype)

    def lognormal(key, shape, dtype, p):
        mean = p.get("mean", 0.0)
        sigma = p.get("sigma", 1.0)
        return jnp.exp(mean + sigma * jr.normal(key, shape, dtype=dtype))

    def pareto(key, shape, dtype, p):
        return jr.pareto(key, p["a"], shape=shape, dtype=dtype) - 1.0

    def poisson(key, shape, dtype, p):
        return jr.poisson(key, p.get("lam", 1.0), shape=shape).astype(dtype)

    def power(key, shape, dtype, p):
        u = jr.uniform(key, shape, dtype=dtype)
        return u ** (1.0 / p["a"])

    def rayleigh(key, shape, dtype, p):
        return jr.rayleigh(key, p.get("scale", 1.0), shape=shape, dtype=dtype)

    def standard_cauchy(key, shape, dtype, p):
        return jr.cauchy(key, shape, dtype=dtype)

    def standard_t(key, shape, dtype, p):
        return jr.t(key, p["df"], shape=shape, dtype=dtype)

    def triangular(key, shape, dtype, p):
        return jr.triangular(key, p["left"], p["mode"], p["right"], shape=shape, dtype=dtype)

    def wald(key, shape, dtype, p):
        # numpy wald(mean, scale): IG(mu, lam); jr.wald samples IG(m, 1) and
        # IG(mu, lam) == lam * IG(mu/lam, 1)
        lam = p.get("scale", 1.0)
        return lam * jr.wald(key, p["mean"] / lam, shape=shape, dtype=dtype)

    def weibull(key, shape, dtype, p):
        return jr.weibull_min(key, 1.0, p["a"], shape=shape, dtype=dtype)

    def vonmises(key, shape, dtype, p):
        # Best & Fisher (1979) rejection sampler (the algorithm numpy uses),
        # vectorized: a lax.while_loop resamples only the rejected lanes.
        import jax
        import jax.numpy as jnp

        mu = jnp.asarray(p["mu"], dtype)
        kappa = jnp.broadcast_to(jnp.asarray(p["kappa"], dtype), shape)
        safe_k = jnp.maximum(kappa, 1e-7)
        s = jnp.sqrt(1.0 + 4.0 * safe_k * safe_k)
        tau = 1.0 + s
        # rho = (tau - sqrt(2 tau)) / (2 k) cancels catastrophically for
        # small k (f32: rho -> 0, r -> inf, NaN acceptance => the rejection
        # loop never terminates). Conjugate form, exact and stable:
        #   tau - sqrt(2 tau) = tau (tau - 2) / (tau + sqrt(2 tau)),
        #   tau - 2 = s - 1 = 4 k^2 / (s + 1)
        rho = 2.0 * safe_k * tau / ((s + 1.0) * (tau + jnp.sqrt(2.0 * tau)))
        r = (1.0 + rho * rho) / (2.0 * rho)

        def cond(state):
            _, _, done, it = state
            # acceptance is O(1) per round; the iteration bound only
            # guarantees termination if numerics ever degenerate
            return (~jnp.all(done)) & (it < 200)

        def body(state):
            key, f, done, it = state
            key, k1, k2 = jr.split(key, 3)
            u1 = jr.uniform(k1, shape, dtype)
            u2 = jr.uniform(k2, shape, dtype, minval=1e-12)
            z = jnp.cos(jnp.pi * u1)
            fc = (1.0 + r * z) / (r + z)
            c = safe_k * (r - fc)
            acc = (c * (2.0 - c) - u2 > 0.0) | (jnp.log(c / u2) + 1.0 - c >= 0.0)
            f = jnp.where(~done & acc, fc, f)
            return key, f, done | acc, it + 1

        key, k0, k3 = jr.split(key, 3)
        init = (k0, jnp.zeros(shape, dtype), jnp.zeros(shape, bool), 0)
        _, f, _, _ = jax.lax.while_loop(cond, body, init)
        u3 = jr.uniform(k3, shape, dtype)
        theta = mu + jnp.sign(u3 - 0.5) * jnp.arccos(jnp.clip(f, -1.0, 1.0))
        # kappa ~ 0 degenerates to the uniform circle
        theta = jnp.where(kappa < 1e-6, (2.0 * u3 - 1.0) * jnp.pi + mu * 0, theta)
        # numpy returns samples wrapped onto [-pi, pi]
        return jnp.mod(theta + jnp.pi, 2.0 * jnp.pi) - jnp.pi

    def negative_binomial(key, shape, dtype, p):
        k1, k2 = jr.split(key)
        lam = jr.gamma(k1, p["n"], shape=shape) * (1.0 - p["p"]) / p["p"]
        return jr.poisson(k2, lam, shape=shape).astype(dtype)

    def multivariate_normal(key, shape, dtype, p):
        return jr.multivariate_normal(
            key, jnp.asarray(p["mean"]), jnp.asarray(p["cov"]), shape=shape[:-1], dtype=dtype
        )

    def random(key, shape, dtype, p):
        return jr.uniform(key, shape, dtype=dtype)

    def permutation_kernel(key, shape, dtype, p):
        return jr.permutation(key, p["n"]).astype(dtype)

    def hypergeometric(key, shape, dtype, p):
        # exact sequential urn draws: nsample is STATIC, so one fori_loop
        # of Bernoulli(good/total) updates traces into the program
        import jax

        f64 = jnp.float64
        good0 = jnp.broadcast_to(jnp.asarray(p["ngood"], f64), shape)
        total0 = good0 + jnp.broadcast_to(jnp.asarray(p["nbad"], f64), shape)

        def body(i, state):
            key, good, total, cnt = state
            key, k = jr.split(key)
            u = jr.uniform(k, shape, f64)
            take_good = (u * total < good).astype(f64)
            return key, good - take_good, total - 1.0, cnt + take_good

        _, _, _, cnt = jax.lax.fori_loop(
            0, int(p["nsample"]), body, (key, good0, total0, jnp.zeros(shape, f64))
        )
        return cnt.astype(dtype)

    def logseries(key, shape, dtype, p):
        # numpy's rk_logseries rejection, vectorized lanes (see vonmises)
        import jax

        f64 = jnp.float64
        pp = jnp.broadcast_to(jnp.asarray(p["p"], f64), shape)
        r = jnp.log1p(-pp)

        def cond(state):
            _, _, done, it = state
            return (~jnp.all(done)) & (it < 200)

        def body(state):
            key, out, done, it = state
            key, k1, k2 = jr.split(key, 3)
            v = jr.uniform(k1, shape, f64, minval=1e-300)
            u = jr.uniform(k2, shape, f64, minval=1e-300)
            q = -jnp.expm1(r * u)
            in_q2 = v <= q * q
            res_q2 = jnp.floor(1.0 + jnp.log(v) / jnp.log(q))
            bad = in_q2 & (res_q2 < 1.0)
            val = jnp.where(in_q2, res_q2, jnp.where(v >= q, 1.0, 2.0))
            val = jnp.where(v >= pp, 1.0, val)
            acc = (v >= pp) | ~bad
            out = jnp.where(~done & acc, val, out)
            return key, out, done | acc, it + 1

        init = (key, jnp.ones(shape, f64), jnp.zeros(shape, bool), 0)
        _, out, _, _ = jax.lax.while_loop(cond, body, init)
        return out.astype(dtype)

    def multinomial(key, shape, dtype, p):
        # conditional-binomial chain over the (static) category count; the
        # category axis is the trailing dim of ``shape``
        f64 = jnp.float64
        pvals = jnp.asarray(p["pvals"], f64)
        k = int(p["k"])
        base = shape[:-1]
        remaining = jnp.full(base, float(p["n"]), f64)
        rem_p = jnp.asarray(1.0, f64)
        outs = []
        for i in range(k - 1):
            key, ki = jr.split(key)
            cond_p = jnp.clip(pvals[i] / jnp.maximum(rem_p, 1e-300), 0.0, 1.0)
            x = jr.binomial(ki, remaining, cond_p, shape=base)
            outs.append(x)
            remaining = remaining - x
            rem_p = rem_p - pvals[i]
        outs.append(remaining)
        return jnp.stack(outs, axis=-1).astype(dtype)

    def noncentral_chisquare(key, shape, dtype, p):
        # Poisson mixture: ncx2(df, nonc) == chisq(df + 2*Poisson(nonc/2))
        k1, k2 = jr.split(key)
        i = jr.poisson(k1, jnp.asarray(p["nonc"], jnp.float64) / 2.0, shape=shape)
        a = jnp.asarray(p["df"], jnp.float64) / 2.0 + i
        return (2.0 * jr.gamma(k2, a, shape=shape)).astype(dtype)

    def noncentral_f(key, shape, dtype, p):
        k1, k2 = jr.split(key)
        num = noncentral_chisquare(k1, shape, np.dtype("f8"), {"df": p["dfnum"], "nonc": p["nonc"]})
        den = jr.chisquare(k2, p["dfden"], shape=shape, dtype=jnp.float64)
        out = (num / p["dfnum"]) / (den / p["dfden"])
        return out.astype(dtype)

    def multivariate_hypergeometric(key, shape, dtype, p):
        # exact k-category urn: nsample STATIC draws, each picking a category
        # by cumulative remaining counts (marginals and count methods sample
        # the same distribution; this is the traced analog)
        import jax

        f64 = jnp.float64
        k = int(p["k"])
        base = shape[:-1]
        colors = jnp.asarray(p["colors"], f64)
        rem0 = jnp.broadcast_to(colors, base + (k,)).astype(f64)

        def body(i, state):
            key, rem, cnt = state
            key, kk = jr.split(key)
            u = jr.uniform(kk, base, f64)
            total = jnp.sum(rem, axis=-1, keepdims=True)
            cum = jnp.cumsum(rem, axis=-1)
            idx = jnp.sum((u[..., None] * total >= cum).astype(jnp.int32), axis=-1)
            onehot = jax.nn.one_hot(idx, k, dtype=f64)
            return key, rem - onehot, cnt + onehot

        _, _, cnt = jax.lax.fori_loop(
            0, int(p["nsample"]), body, (key, rem0, jnp.zeros(base + (k,), f64))
        )
        return cnt.astype(dtype)

    def zipf(key, shape, dtype, p):
        # Devroye's rejection (numpy's rk_zipf), vectorized lanes
        import jax

        f64 = jnp.float64
        a = jnp.broadcast_to(jnp.asarray(p["a"], f64), shape)
        am1 = a - 1.0
        b = 2.0 ** am1

        def cond(state):
            _, _, done, it = state
            return (~jnp.all(done)) & (it < 200)

        def body(state):
            key, out, done, it = state
            key, k1, k2 = jr.split(key, 3)
            u = 1.0 - jr.uniform(k1, shape, f64)
            v = jr.uniform(k2, shape, f64)
            x = jnp.floor(u ** (-1.0 / am1))
            in_range = (x >= 1.0) & (x < 2.0**62)
            t = (1.0 + 1.0 / x) ** am1
            acc = in_range & (v * x * (t - 1.0) / (b - 1.0) <= t / b)
            out = jnp.where(~done & acc, x, out)
            return key, out, done | acc, it + 1

        init = (key, jnp.ones(shape, f64), jnp.zeros(shape, bool), 0)
        _, out, _, _ = jax.lax.while_loop(cond, body, init)
        return out.astype(dtype)

    return {k: v for k, v in locals().items() if callable(v)}


_KERNELS = None


def _kernels():
    global _KERNELS
    if _KERNELS is None:
        globals()["_KERNELS"] = _make_kernels()
    return globals()["_KERNELS"]


class Generator:
    """numpy.random.Generator-style API over per-block device RNG."""

    def __init__(self, seed=None):
        if seed is None:
            seed = int(np.random.SeedSequence().entropy % (2**63))
        self._seed = int(seed) % (2**63)
        self._counter = 0

    def _next_seed(self):
        # each draw gets a distinct stream (like advancing a bit-generator)
        s = (self._seed * 1000003 + self._counter) % (2**63)
        self._counter += 1
        return s

    def _draw(self, dist, size, dtype, chunks="auto", **params):
        from dask_array_tpu._collection import new_collection

        _kernels()
        if size is None:
            size = ()
        if isinstance(size, Integral):
            size = (int(size),)
        size = tuple(int(s) for s in size)
        dtype = np.dtype(dtype)
        ch = normalize_chunks(chunks, size, dtype=dtype)
        norm = tuple(sorted(
            (k, tuple(np.asarray(v).ravel().tolist()) if isinstance(v, (list, np.ndarray)) else v)
            for k, v in params.items()
        ))
        return new_collection(Random(dist, self._next_seed(), ch, dtype, norm))

    # -- distributions ------------------------------------------------------

    def random(self, size=None, dtype=float, chunks="auto", **kw):
        return self._draw("random", size, dtype, chunks)

    def uniform(self, low=0.0, high=1.0, size=None, chunks="auto", **kw):
        return self._draw("uniform", size, float, chunks, low=float(low), high=float(high))

    def normal(self, loc=0.0, scale=1.0, size=None, chunks="auto", **kw):
        return self._draw("normal", size, float, chunks, loc=float(loc), scale=float(scale))

    def standard_normal(self, size=None, dtype=float, chunks="auto", **kw):
        return self._draw("standard_normal", size, dtype, chunks)

    def integers(self, low, high=None, size=None, dtype=np.int64, endpoint=False, chunks="auto", **kw):
        if high is None:
            low, high = 0, low
        if endpoint:
            high = high + 1
        return self._draw("integers", size, dtype, chunks, low=int(low), high=int(high))

    def beta(self, a, b, size=None, chunks="auto", **kw):
        return self._draw("beta", size, float, chunks, a=float(a), b=float(b))

    def binomial(self, n, p, size=None, chunks="auto", **kw):
        return self._draw("binomial", size, np.int64, chunks, n=float(n), p=float(p))

    def chisquare(self, df, size=None, chunks="auto", **kw):
        return self._draw("chisquare", size, float, chunks, df=float(df))

    def exponential(self, scale=1.0, size=None, chunks="auto", **kw):
        return self._draw("exponential", size, float, chunks, scale=float(scale))

    def standard_exponential(self, size=None, dtype=float, chunks="auto", **kw):
        return self._draw("standard_exponential", size, dtype, chunks)

    def f(self, dfnum, dfden, size=None, chunks="auto", **kw):
        return self._draw("f", size, float, chunks, dfnum=float(dfnum), dfden=float(dfden))

    def gamma(self, shape, scale=1.0, size=None, chunks="auto", **kw):
        return self._draw("gamma", size, float, chunks, shape=float(shape), scale=float(scale))

    def standard_gamma(self, shape, size=None, dtype=float, chunks="auto", **kw):
        return self._draw("standard_gamma", size, dtype, chunks, shape=float(shape))

    def geometric(self, p, size=None, chunks="auto", **kw):
        return self._draw("geometric", size, np.int64, chunks, p=float(p))

    def gumbel(self, loc=0.0, scale=1.0, size=None, chunks="auto", **kw):
        return self._draw("gumbel", size, float, chunks, loc=float(loc), scale=float(scale))

    def laplace(self, loc=0.0, scale=1.0, size=None, chunks="auto", **kw):
        return self._draw("laplace", size, float, chunks, loc=float(loc), scale=float(scale))

    def logistic(self, loc=0.0, scale=1.0, size=None, chunks="auto", **kw):
        return self._draw("logistic", size, float, chunks, loc=float(loc), scale=float(scale))

    def lognormal(self, mean=0.0, sigma=1.0, size=None, chunks="auto", **kw):
        return self._draw("lognormal", size, float, chunks, mean=float(mean), sigma=float(sigma))

    def negative_binomial(self, n, p, size=None, chunks="auto", **kw):
        return self._draw("negative_binomial", size, np.int64, chunks, n=float(n), p=float(p))

    def pareto(self, a, size=None, chunks="auto", **kw):
        return self._draw("pareto", size, float, chunks, a=float(a))

    def poisson(self, lam=1.0, size=None, chunks="auto", **kw):
        return self._draw("poisson", size, np.int64, chunks, lam=float(lam))

    def power(self, a, size=None, chunks="auto", **kw):
        return self._draw("power", size, float, chunks, a=float(a))

    def rayleigh(self, scale=1.0, size=None, chunks="auto", **kw):
        return self._draw("rayleigh", size, float, chunks, scale=float(scale))

    def standard_cauchy(self, size=None, chunks="auto", **kw):
        return self._draw("standard_cauchy", size, float, chunks)

    def standard_t(self, df, size=None, chunks="auto", **kw):
        return self._draw("standard_t", size, float, chunks, df=float(df))

    def triangular(self, left, mode, right, size=None, chunks="auto", **kw):
        return self._draw("triangular", size, float, chunks, left=float(left), mode=float(mode), right=float(right))

    def vonmises(self, mu, kappa, size=None, chunks="auto", **kw):
        return self._draw("vonmises", size, float, chunks, mu=float(mu), kappa=float(kappa))

    def wald(self, mean, scale, size=None, chunks="auto", **kw):
        return self._draw("wald", size, float, chunks, mean=float(mean), scale=float(scale))

    def weibull(self, a, size=None, chunks="auto", **kw):
        return self._draw("weibull", size, float, chunks, a=float(a))

    def hypergeometric(self, ngood, nbad, nsample, size=None, chunks="auto", **kw):
        if not isinstance(nsample, Integral):
            raise NotImplementedError("array-valued nsample is not supported")
        ngood, nbad, nsample = int(ngood), int(nbad), int(nsample)
        total = ngood + nbad
        if nsample > total:
            raise ValueError("ngood + nbad < nsample")
        if nsample > total // 2:
            # the traced urn is O(nsample) steps: sample the COMPLEMENT
            # (same distribution, good_in_sample = ngood - good_in_rest)
            rest = self._draw(
                "hypergeometric", size, np.int64, chunks,
                ngood=ngood, nbad=nbad, nsample=total - nsample,
            )
            return ngood - rest
        return self._draw(
            "hypergeometric", size, np.int64, chunks,
            ngood=ngood, nbad=nbad, nsample=nsample,
        )

    def logseries(self, p, size=None, chunks="auto", **kw):
        if not 0.0 < float(p) < 1.0:
            raise ValueError("p must be in (0, 1)")
        return self._draw("logseries", size, np.int64, chunks, p=float(p))

    def multinomial(self, n, pvals, size=None, chunks="auto", **kw):
        pvals = tuple(float(v) for v in np.asarray(pvals).ravel())
        if np.sum(pvals[:-1]) > 1.0 + 1e-12:
            raise ValueError("sum(pvals[:-1]) > 1.0")
        k = len(pvals)
        if size is None:
            size = ()
        if isinstance(size, Integral):
            size = (int(size),)
        out_size = tuple(int(s) for s in size) + (k,)
        if chunks == "auto":
            chunks = ("auto",) * len(size) + (k,)  # categories stay one block
        return self._draw("multinomial", out_size, np.int64, chunks, n=int(n), pvals=pvals, k=k)

    def noncentral_chisquare(self, df, nonc, size=None, chunks="auto", **kw):
        if float(df) <= 0 or float(nonc) < 0:
            raise ValueError("df must be > 0, nonc >= 0")
        return self._draw("noncentral_chisquare", size, float, chunks, df=float(df), nonc=float(nonc))

    def noncentral_f(self, dfnum, dfden, nonc, size=None, chunks="auto", **kw):
        if float(dfnum) <= 0 or float(dfden) <= 0 or float(nonc) < 0:
            raise ValueError("dfnum/dfden must be > 0, nonc >= 0")
        return self._draw(
            "noncentral_f", size, float, chunks,
            dfnum=float(dfnum), dfden=float(dfden), nonc=float(nonc),
        )

    def zipf(self, a, size=None, chunks="auto", **kw):
        if float(a) <= 1.0:
            raise ValueError("a must be > 1")
        return self._draw("zipf", size, np.int64, chunks, a=float(a))

    def multivariate_hypergeometric(self, colors, nsample, size=None, method="marginals", chunks="auto", **kw):
        if method not in ("marginals", "count"):
            raise ValueError(f"method must be 'marginals' or 'count', got {method!r}")
        colors = tuple(int(c) for c in np.asarray(colors).ravel())
        if any(c < 0 for c in colors):
            raise ValueError("colors must be non-negative")
        if not isinstance(nsample, Integral):
            raise NotImplementedError("array-valued nsample is not supported")
        if int(nsample) > sum(colors):
            raise ValueError("nsample > sum(colors)")
        k = len(colors)
        if size is None:
            size = ()
        if isinstance(size, Integral):
            size = (int(size),)
        out_size = tuple(int(s) for s in size) + (k,)
        if chunks == "auto":
            chunks = ("auto",) * len(size) + (k,)
        return self._draw(
            "multivariate_hypergeometric", out_size, np.int64, chunks,
            colors=colors, nsample=int(nsample), k=k,
        )

    def multivariate_normal(self, mean, cov, size=None, chunks="auto", **kw):
        mean = np.asarray(mean, dtype="f8")
        cov = np.asarray(cov, dtype="f8")
        if size is None:
            size = ()
        if isinstance(size, Integral):
            size = (int(size),)
        return self._mvn(mean, cov, size, chunks)

    def _mvn(self, mean, cov, size, chunks):
        from dask_array_tpu._collection import new_collection

        _kernels()
        full = tuple(size) + (mean.shape[0],)
        ch = normalize_chunks(chunks, full, dtype=np.dtype("f8"))
        params = (("cov", tuple(map(tuple, cov.tolist()))), ("mean", tuple(mean.tolist())))
        return new_collection(Random("multivariate_normal", self._next_seed(), ch, np.dtype("f8"), params))

    def permutation(self, x, chunks="auto"):
        from dask_array_tpu._collection import Array, new_collection

        if isinstance(x, Integral):
            n = int(x)
            ch = normalize_chunks(chunks, (n,), dtype=np.dtype(np.int64))
            return new_collection(Random("permutation_kernel", self._next_seed(), ch, np.dtype(np.int64), (("n", n),)))
        idx = self.permutation(x.shape[0] if hasattr(x, "shape") else len(x))
        from dask_array_tpu.ops._fancy_indexing import take

        return take(x, np.asarray(idx.compute()), axis=0)

    def choice(self, a, size=None, replace=True, p=None, chunks="auto"):
        return choice(a, size=size, replace=replace, p=p, chunks=chunks, rng=self)

    def shuffle(self, x):
        raise NotImplementedError("in-place shuffle is not supported; use permutation()")


def default_rng(seed=None):
    if isinstance(seed, Generator):
        return seed
    return Generator(seed)


def choice(a, size=None, replace=True, p=None, chunks="auto", rng=None):
    rng = rng or Generator()
    if isinstance(a, Integral):
        n = int(a)
        if replace and p is None:
            return rng.integers(0, n, size=size, chunks=chunks)
        idx_np = np.random.default_rng(rng._next_seed()).choice(n, size=size, replace=replace, p=p)
        from dask_array_tpu.ops._from_array import from_array

        return from_array(idx_np, chunks=chunks)
    from dask_array_tpu.ops._from_array import asarray
    from dask_array_tpu.ops._fancy_indexing import take

    a = asarray(a)
    idx = choice(a.shape[0], size=size, replace=replace, p=p, chunks=chunks, rng=rng)
    return take(a, np.asarray(idx.compute()).ravel(), axis=0)


class RandomState:
    """Legacy numpy.random.RandomState-style API (parity:
    ``random/_random_state.py``)."""

    def __init__(self, seed=None):
        self._g = Generator(seed)

    def seed(self, seed=None):
        self._g = Generator(seed)

    def random_sample(self, size=None, chunks="auto"):
        return self._g.random(size=size, chunks=chunks)

    random = random_sample

    def rand(self, *size, chunks="auto"):
        return self._g.random(size=size or None, chunks=chunks)

    def randn(self, *size, chunks="auto"):
        return self._g.standard_normal(size=size or None, chunks=chunks)

    def randint(self, low, high=None, size=None, dtype=int, chunks="auto"):
        return self._g.integers(low, high, size=size, dtype=dtype, chunks=chunks)

    def random_integers(self, low, high=None, size=None, chunks="auto"):
        return self._g.integers(low, high, size=size, endpoint=True, chunks=chunks)

    def __getattr__(self, name):
        g = object.__getattribute__(self, "_g")
        attr = getattr(g, name, None)
        if attr is None:
            raise AttributeError(name)
        return attr


_default = None


def _module_rng():
    global _default
    if _default is None:
        _default = Generator(0xDA5C)
    return _default


# module-level convenience functions (dask.array.random namespace parity)
def _module_fn(name):
    def fn(*args, **kwargs):
        return getattr(_module_rng(), name)(*args, **kwargs)

    fn.__name__ = name
    return fn


random_sample = _module_fn("random")
random = _module_fn("random")
uniform = _module_fn("uniform")
normal = _module_fn("normal")
standard_normal = _module_fn("standard_normal")
randint = lambda low, high=None, size=None, dtype=int, chunks="auto": _module_rng().integers(low, high, size=size, dtype=dtype, chunks=chunks)
integers = _module_fn("integers")
beta = _module_fn("beta")
binomial = _module_fn("binomial")
chisquare = _module_fn("chisquare")
exponential = _module_fn("exponential")
standard_exponential = _module_fn("standard_exponential")
f = _module_fn("f")
gamma = _module_fn("gamma")
standard_gamma = _module_fn("standard_gamma")
geometric = _module_fn("geometric")
gumbel = _module_fn("gumbel")
laplace = _module_fn("laplace")
logistic = _module_fn("logistic")
lognormal = _module_fn("lognormal")
negative_binomial = _module_fn("negative_binomial")
pareto = _module_fn("pareto")
poisson = _module_fn("poisson")
power = _module_fn("power")
rayleigh = _module_fn("rayleigh")
standard_cauchy = _module_fn("standard_cauchy")
standard_t = _module_fn("standard_t")
triangular = _module_fn("triangular")
wald = _module_fn("wald")
weibull = _module_fn("weibull")
permutation = _module_fn("permutation")
multivariate_normal = _module_fn("multivariate_normal")
vonmises = _module_fn("vonmises")
hypergeometric = _module_fn("hypergeometric")
logseries = _module_fn("logseries")
multinomial = _module_fn("multinomial")
noncentral_chisquare = _module_fn("noncentral_chisquare")
noncentral_f = _module_fn("noncentral_f")
zipf = _module_fn("zipf")


def random_integers(low, high=None, size=None, chunks="auto"):
    """Legacy inclusive-endpoint randint (parity: reference random module)."""
    return _module_rng().integers(low, high, size=size, endpoint=True, chunks=chunks)


def seed(seed=None):
    """Re-seed the module-level generator (legacy np.random.seed parity)."""
    global _default
    _default = Generator(seed)
