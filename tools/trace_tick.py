"""GPU measurements of the flagship ticks: times, matmul precision, traces.

One process, one card. Prints one line per measurement and writes the
profiler traces under ``chiprun_out/``:

1. ticks: ``Engine.replan_refresh`` (GMM) and ``Engine.replan_refresh_mi``
   at S=4096 on the bench's map and belief, timed per call up to
   ``block_until_ready`` (p50/p99);
2. precision: what DEFAULT / HIGH / HIGHEST give on the card for the
   (S, N) @ (N, K^2) refresh contraction — error vs float64, time, and the
   cuBLAS kernel the compiled program calls;
3. trace: a profiler trace of 5 ticks of each, reduced to kernels per
   tick, the largest kernels and the device's idle share.

    python tools/trace_tick.py [--S 4096] [--n 30] [--parts ticks,precision,trace]

XLA wraps a tick's kernels in CUDA graphs; the trace shows them either way.
"""

import argparse
import glob
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "chiprun_out")


def log(msg):
    print(msg, flush=True)


def p50_ms(times):
    return float(np.percentile(np.asarray(times) * 1e3, 50))


def fmt(times):
    t = np.asarray(times) * 1e3
    return f"p50 {np.percentile(t, 50):.4f} ms p99 {np.percentile(t, 99):.4f} ms n={t.size}"


def ticks(S, n):
    """The flagship GMM tick and the MI tick at S scenarios, timed per call
    up to block_until_ready; returns the warmed tick callables."""
    import bench

    engine, sc, gmm, domain, world = bench.build_case(S)
    grids = bench.batched_grids(bench.bench_belief(), S)
    mi_world = engine.prepare_world(grids)
    state = {"gmm": sc, "mi": engine.init_scenarios(np.asarray(sc.x))}

    def gmm_tick():
        state["gmm"], u, _ = engine.replan_refresh(state["gmm"], gmm, domain, world)
        return u

    def mi_tick():
        state["mi"], u, _ = engine.replan_refresh_mi(state["mi"], grids, mi_world, 3,
                                                     domain=domain)
        return u

    out = {"gmm": gmm_tick, "mi": mi_tick}
    for label, tick in out.items():
        bench.time_calls(tick, 3)
        log(f"tick {label} S={S}: {fmt(bench.time_calls(tick, n))}")
    return out


def precision():
    import jax
    import jax.numpy as jnp

    import bench

    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (4096, 10000)).astype(np.float32)
    a /= a.sum(axis=1, keepdims=True)
    b = rng.uniform(-0.4, 0.4, (10000, 100)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    A, B = jnp.asarray(a), jnp.asarray(b)
    for p in (jax.lax.Precision.DEFAULT, jax.lax.Precision.HIGH,
              jax.lax.Precision.HIGHEST):
        f = jax.jit(lambda x, y, p=p: jnp.matmul(x, y, precision=p,
                                                  preferred_element_type=jnp.float32))
        out = np.asarray(f(A, B))
        rel = np.abs(out - ref).max() / np.abs(ref).max()
        ts = bench.time_calls(lambda: f(A, B), 20)
        path = os.path.join(OUT, f"trace_matmul_{p.name}")
        jax.profiler.start_trace(path)
        jax.block_until_ready(f(A, B))
        jax.profiler.stop_trace()
        log(f"precision {p.name}: max abs err {np.abs(out - ref).max():.3e} "
            f"(relative to max {rel:.3e}); {fmt(ts)}; kernels {device_kernels(path)}")


def _device_planes(path):
    from jax.profiler import ProfileData

    files = glob.glob(os.path.join(path, "plugins", "profile", "*", "*.xplane.pb"))
    if not files:
        return []
    return [p for p in ProfileData.from_file(files[0]).planes
            if p.name.startswith("/device:GPU")]


def device_kernels(path):
    """Names of the kernels in a trace dir (first 80 characters)."""
    return sorted({e.name[:80] for plane in _device_planes(path)
                   for line in plane.lines if "Stream" in line.name
                   for e in line.events})


def reduce_trace(path, n_ticks):
    """Kernels per tick, largest kernels and idle share from a trace dir.

    Busy time is the union of the device's kernel and copy intervals; the
    window runs from the first to the last of them, so host time before the
    first launch is outside it."""
    for plane in _device_planes(path):
        log(f"trace plane {plane.name}: lines {[l.name for l in plane.lines]}")
        intervals, by_op, n_ev = [], {}, 0
        for line in plane.lines:
            if "Stream" not in line.name:
                continue
            for e in line.events:  # kernels and copies (inside CUDA graphs too)
                n_ev += 1
                intervals.append((e.start_ns, e.start_ns + e.duration_ns))
                by_op[e.name] = by_op.get(e.name, 0.0) + e.duration_ns
        if not intervals:
            continue
        intervals.sort()
        busy, cur_s, cur_e = 0.0, *intervals[0]
        for s, e in intervals[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = intervals[-1][1] - intervals[0][0]
        log(f"trace {os.path.basename(path)}: {n_ev} device events over {n_ticks} ticks "
            f"({n_ev / n_ticks:.1f}/tick); window {window / 1e6:.3f} ms, busy "
            f"{busy / 1e6:.3f} ms, idle share {1 - busy / window:.4f}")
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:15]
        for op, ns in top:
            log(f"   {ns / 1e6 / n_ticks:9.4f} ms/tick  {op[:120]}")


def traces(tick_fns, n_ticks=5):
    import jax

    for label, tick in tick_fns.items():
        path = os.path.join(OUT, f"trace_tick_{label}")
        jax.block_until_ready(tick())
        jax.profiler.start_trace(path)
        for _ in range(n_ticks):
            jax.block_until_ready(tick())
        jax.profiler.stop_trace()
        reduce_trace(path, n_ticks)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--S", type=int, default=4096)
    ap.add_argument("--n", type=int, default=30)
    ap.add_argument("--parts", default="ticks,precision,trace",
                    help="comma list of ticks, precision, trace")
    args = ap.parse_args()
    parts = set(args.parts.split(","))

    import bench
    from ergodic_exploration_tpu.utils.compile_cache import enable_persistent_cache

    devices = bench.require_gpu()
    enable_persistent_cache()
    log(f"device: {devices[0].device_kind} x{len(devices)}; card: {bench.card_info()}; "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    t0 = time.perf_counter()
    tick_fns = ticks(args.S, args.n) if parts & {"ticks", "trace"} else {}
    if "precision" in parts:
        precision()
    if "trace" in parts:
        traces(tick_fns)
    log(f"card at end: {bench.card_info()}; {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
