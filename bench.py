"""Headline benchmark: blocked bf16 matmul through the full framework path.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "TFLOP/s", "vs_baseline": N,
   "device": {...}, "card": "<name>, <power limit>"}

The BASELINE.md target is >=90% of the device's published dense bf16 peak
for a chunked matmul built through the lazy expression API;
``vs_baseline`` is achieved_TFLOPs / (0.90 * peak_TFLOPs).  The matrix is
sized from that peak so one product takes several milliseconds, and every
timed trial ends in ``block_until_ready``.

The parent process stays off JAX and runs the measurement in one child,
so a single process holds the card.  A device missing from ``PEAKS`` is
an error.

    python bench.py
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

# published dense peaks by jax device_kind (NVIDIA H100 SXM data sheet;
# they assume the full 700 W power limit)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0, "tf32_tflops": 495.0, "f32_tflops": 67.0, "hbm_tb_s": 3.35,
    },
}


def peak(device, key="bf16_tflops") -> float:
    try:
        return PEAKS[device.device_kind][key]
    except KeyError:
        raise KeyError(
            f"no published peak for device_kind {device.device_kind!r}; add it to PEAKS"
        ) from None


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main():
    import jax

    import dask_array_tpu as da
    from dask_array_tpu._diagnostics import tier_report

    dev = jax.devices()[0]
    pk = peak(dev)
    # one product of at least 5 ms at peak, in power-of-two sizes
    n = max(2048, 1 << math.ceil(math.log2((5e-3 * pk * 1e12 / 2) ** (1 / 3))))
    chunk = n // 8
    rng = np.random.default_rng(0)
    a_np = rng.standard_normal((n, n), dtype=np.float32).astype(jax.numpy.bfloat16)
    b_np = rng.standard_normal((n, n), dtype=np.float32).astype(jax.numpy.bfloat16)
    flops = 2.0 * n**3
    with da.config.set({"tpu.matmul-precision": "default"}):
        a = da.from_array(a_np, chunks=chunk).persist()
        b = da.from_array(b_np, chunks=chunk).persist()
        y = a @ b
        y.compute_device().block_until_ready()  # build + optimize + compile + run
        iters = max(3, math.ceil(1.0 / (flops / (pk * 1e12))))

        def trial():
            t0 = time.perf_counter()
            for _ in range(iters):
                out = y.compute_device()
            out.block_until_ready()
            return (time.perf_counter() - t0) / iters

        dt = statistics.median(trial() for _ in range(3))

    tflops = flops / dt / 1e12
    record = {
        "metric": f"blocked_matmul_{n}x{n}_chunks{chunk}_bf16_tflops_per_chip",
        "value": round(tflops, 2),
        "unit": "TFLOP/s",
        "vs_baseline": round(tflops / (0.90 * pk), 4),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card_line(),
    }
    # lane guard: a silent trace->eager demotion shows up as a catastrophic
    # number — name the cause in the record
    tiers = tier_report(y)
    if tiers["counts"].get("trace", 0) != sum(tiers["counts"].values()):
        record["note"] = f"NOT fully on the compiled trace lane: {tiers['counts']}"
    print(json.dumps(record))


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        main()
    else:
        import os

        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child"],
                           capture_output=True, text=True, timeout=2400)
        lines = [l for l in r.stdout.splitlines() if l.startswith("{")]
        if r.returncode != 0 or not lines:
            sys.stderr.write(r.stderr[-4000:])
            sys.exit(r.returncode or 1)
        print(lines[-1])
