#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one JSON line each; any failed check exits non-zero:
  1. the card (name and power limit from nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
  3. each kernel against its plain PyTorch version on the card at the main
     path's shape and at ragged shapes, and timed beside its bound;
  4. the main path: ``Experiment.from_scenario(...).run`` on the card for a
     fleet of E = 1024 sites (4 regions x 256), k = 8 streams, windows of
     N = 256 tuples, 4 generated windows cycled to T = 200, through both
     kernels (``use_kernel=True``), with the launch counts asserted;
  5. the same scenario at T = 20 with the plain versions on the card,
     held against the kernel path;
  6. the ``fleet_scan`` golden scenario with the payload replay;
  7. the kernels line, then ``{"ok": true, "device": {...}}`` last.

Detailed profiles go to ``chiprun_out/``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# H100 SXM data sheet: HBM3 bandwidth and f32 (non-tensor-core) peak
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

MAIN = {"n_regions": 4, "sites_per_region": 256, "k": 8, "window": 256,
        "pool": 4, "T": 200, "T_plain": 20}
GOLDEN_REF_WAN_BYTES = 11080   # live JAX reference, fleet_scan, CPU

# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "stream_stats_fleet": (
        "src/repro_torch/kernels/csrc/stream_stats_fleet.cu",
        "src/repro/kernels/stream_stats/kernel.py:95"),
    "polyfit": (
        "src/repro_torch/kernels/csrc/polyfit.cu",
        "src/repro/kernels/polyfit/kernel.py:55"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def time_cuda(fn, torch, reps: int, warmup: int = 10) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timings."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main_scenario(k: int, window: int, n_regions: int, sites: int,
                  n_points: int) -> dict:
    """The fleet_scan planner and controller at the main path's size."""
    with open(os.path.join(HERE, "tests/goldens/scenarios/fleet_scan.json")) as f:
        d = json.load(f)["scenario"]
    d["data"].update(n_points=n_points, window=window, options={"k": k})
    d["topology"].update(n_regions=n_regions, sites_per_region=sites)
    return d


def main() -> int:
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        return fail("src/repro_torch not found beside chip_smoke.py; run it "
                    "from the root of a checkout")
    sys.path.insert(0, src)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false; this smoke needs a "
                    "CUDA GPU")
    os.makedirs(OUT_DIR, exist_ok=True)
    dev = torch.device("cuda")

    # ---- 1. the card -----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.stdout else "?"
    print(card_line, flush=True)
    emit({"phase": "device", "nvidia_smi": card_line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    from repro_torch.kernels import build
    from repro_torch.kernels.polyfit import ops as poly_ops
    from repro_torch.kernels.polyfit.ref import polyfit_ref
    from repro_torch.kernels.stream_stats import ops as ss_ops
    from repro_torch.kernels.stream_stats.ref import fleet_stats_ref

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    secs = build.build_all()
    ptxas = {}
    for name in build.SOURCES:
        log = build.lib_path(name).with_suffix(".log")
        if log.exists():
            ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                           if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_library_s": {k: round(v, 3) for k, v in secs.items()},
          "ptxas": ptxas})

    # ---- 3. kernels against their plain versions -------------------------
    from repro_torch.data.streams import fleet_like
    E = MAIN["n_regions"] * MAIN["sites_per_region"]
    k, N = MAIN["k"], MAIN["window"]
    t0 = time.perf_counter()
    vals, _ = fleet_like(n_sites=E, n_regions=MAIN["n_regions"], k=k,
                         n_points=MAIN["pool"] * N, seed=15)
    emit({"phase": "data", "seconds": round(time.perf_counter() - t0, 3),
          "shape": list(vals.shape)})
    gen = torch.Generator(device="cpu").manual_seed(0)
    reps = 50

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(dev)

    from repro_torch.core.stats import rank_transform
    w0 = torch.as_tensor(np.ascontiguousarray(vals[:, :, :N]), device=dev)
    counts = torch.full((E, k), N, dtype=torch.int32, device=dev)
    ranks = rank_transform(w0, counts).contiguous()
    results = {}

    def check(name, got, want, shape, exact, rtol, atol):
        """``exact``: outputs that must equal the plain version bitwise
        (the power sums, taken in the same order); the rest within
        (rtol, atol)."""
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ok = all(torch.equal(g, w) if x else
                 torch.allclose(g, w, rtol=rtol, atol=atol)
                 for g, w, x in zip(got, want, exact))
        emit({"phase": "kernel_check", "kernel": name, "shape": shape,
              "max_abs_err": err, "bitwise": list(exact), "rtol": rtol,
              "atol": atol, "ok": ok})
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {shape}: max |err| {err}")
        return err

    # stream_stats_fleet: power sums bitwise, the Gram block within the
    # tolerances of tests/test_kernel_stream_stats.py
    ss_cases = [("values", w0), ("ranks", ranks),
                ("ragged", randn(3, 5, 200, scale=1.5, shift=2.0)),
                ("ragged", randn(2, 9, 130, scale=3.0))]
    ss_err = 0.0
    for label, x in ss_cases:
        got = ss_ops.stream_stats_fleet_cuda(x)
        torch.cuda.synchronize()
        err = check("stream_stats_fleet", got, fleet_stats_ref(x),
                    [label, *x.shape], (True, False), 2e-5, 1e-2)
        if label in ("values", "ranks"):
            ss_err = max(ss_err, err)
    x = w0
    ms = time_cuda(lambda: ss_ops.stream_stats_fleet_cuda(x), torch, reps)
    plain = time_cuda(lambda: fleet_stats_ref(x), torch, reps)
    nbytes = x.numel() * 4 + E * k * (4 + k) * 4
    flops = E * (2 * k * k * N + 7 * k * N)
    b_ms, b_by = bound_ms(nbytes, flops)
    results["stream_stats_fleet"] = {"max_abs_err": ss_err, "ms": ms,
                                     "plain_ms": plain, "bound_ms": b_ms,
                                     "bound_by": b_by, "library_ms": None}
    emit({"phase": "kernel_time", "kernel": "stream_stats_fleet",
          "shape": list(x.shape), "kernel_ms": ms, "plain_ms": plain,
          "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
          "flops": flops, "launches_per_window": 2,
          "library_ms": None,
          "library_note": "no single PyTorch call computes it: torch.bmm "
                          "gives only the Gram part"})

    # polyfit: bitwise (same products, same order); the main-path rows
    # are (y*w, u*w) with u a standardized neighbouring stream
    y = w0.reshape(E * k, N)
    xp = torch.roll(w0, 1, dims=1).reshape(E * k, N)
    u = ((xp - xp.mean(-1, keepdim=True))
         / xp.std(-1, keepdim=True)).contiguous()
    pf_cases = [("fleet", y, u),
                ("ragged", randn(15, 200, scale=2.0), randn(15, 200)),
                ("ragged", randn(18, 130, scale=2.0), randn(18, 130))]
    pf_err = 0.0
    for label, yy, uu in pf_cases:
        got = poly_ops.polyfit_cuda(yy, uu)
        torch.cuda.synchronize()
        want = polyfit_ref(yy, uu)
        want[0][:, 0] = float(yy.shape[1])
        err = check("polyfit", got, want, [label, *yy.shape], (True, True),
                    0.0, 0.0)
        if label == "fleet":
            pf_err = err
    ms = time_cuda(lambda: poly_ops.polyfit_cuda(y, u), torch, reps)
    plain = time_cuda(lambda: polyfit_ref(y, u), torch, reps)
    nbytes = 2 * y.numel() * 4 + y.shape[0] * 11 * 4
    flops = y.numel() * 18
    b_ms, b_by = bound_ms(nbytes, flops)
    results["polyfit"] = {"max_abs_err": pf_err, "ms": ms, "plain_ms": plain,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "library_ms": None}
    emit({"phase": "kernel_time", "kernel": "polyfit",
          "shape": list(y.shape), "kernel_ms": ms, "plain_ms": plain,
          "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
          "flops": flops, "launches_per_window": 1, "library_ms": None,
          "library_note": "no single PyTorch call computes the 11 power "
                          "sums"})

    # ---- 4. the main path ------------------------------------------------
    from repro_torch.api.experiment import Experiment
    from repro_torch.api.scenario import ScenarioConfig
    sc = ScenarioConfig.from_dict(main_scenario(
        k, N, MAIN["n_regions"], MAIN["sites_per_region"],
        MAIN["pool"] * N))
    ex = Experiment.from_scenario(sc, use_kernel=True, collect="estimates",
                                  device="cuda")
    windows = [np.ascontiguousarray(vals[:, :, i * N:(i + 1) * N])
               for i in range(MAIN["pool"])]
    ex.run(windows, n_windows=2)                 # warm-up (allocator, libs)
    T = MAIN["T"]
    ss_ops.LAUNCHES = 0
    poly_ops.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    rep = ex.run(windows, n_windows=T)
    launches = {"stream_stats_fleet": ss_ops.LAUNCHES,
                "polyfit": poly_ops.LAUNCHES}
    raw = rep.raw
    nrmse_ok = all(np.isfinite(v) for v in rep.nrmse.values())
    emit({"phase": "main_path", "E": E, "k": k, "N": N, "T": T,
          "windows_per_sec": raw["windows_per_sec"],
          "scan_seconds": raw["scan_seconds"],
          "nrmse": rep.nrmse, "wan_bytes": rep.wan_bytes,
          "full_bytes": rep.full_bytes, "wan_fraction": rep.wan_fraction,
          "launches": launches,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    if launches["stream_stats_fleet"] != 2 * T or launches["polyfit"] != T:
        raise AssertionError(f"kernel launches on the main path: {launches}, "
                             f"want stream_stats_fleet {2 * T}, polyfit {T}")
    if not nrmse_ok or not 0 < rep.wan_bytes < rep.full_bytes:
        raise AssertionError(f"main path output out of range: nrmse "
                             f"{rep.nrmse}, wan {rep.wan_bytes} of "
                             f"{rep.full_bytes}")
    for q in rep.nrmse_per_stream.values():
        if q.shape != (E, k) or not np.isfinite(q).all():
            raise AssertionError("per-stream NRMSE table malformed")

    # where a window's time goes: the step's own profiler ranges
    profile_main_path(ex, windows, torch)

    # ---- 5. plain versions on the card -----------------------------------
    # use_kernel=False also sends the fit down the legacy least-squares
    # path (the kernel path fits from the fused Vandermonde moments), and
    # the Gram blocks associate differently in f32; either can flip an
    # occasional allocation boundary, so the two paths agree within a
    # tolerance, not bitwise.
    T2 = MAIN["T_plain"]
    ex_k = Experiment.from_scenario(sc, use_kernel=True, collect="estimates",
                                    device="cuda")
    rk = ex_k.run(windows, n_windows=T2)
    ex_p = Experiment.from_scenario(sc, use_kernel=False,
                                    collect="estimates", device="cuda")
    rp = ex_p.run(windows, n_windows=T2)
    d_avg = abs(rk.nrmse["AVG"] - rp.nrmse["AVG"]) / abs(rp.nrmse["AVG"])
    d_wan = abs(rk.wan_bytes - rp.wan_bytes) / rp.wan_bytes
    emit({"phase": "plain_vs_kernel", "T": T2,
          "nrmse_kernel": rk.nrmse, "nrmse_plain": rp.nrmse,
          "wan_kernel": rk.wan_bytes, "wan_plain": rp.wan_bytes,
          "avg_rel_diff": d_avg, "wan_rel_diff": d_wan,
          "windows_per_sec_kernel": rk.raw["windows_per_sec"],
          "windows_per_sec_plain": rp.raw["windows_per_sec"]})
    if d_avg > 0.01 or d_wan > 0.001:
        raise AssertionError(f"kernel and plain paths disagree: AVG NRMSE "
                             f"rel {d_avg}, WAN bytes rel {d_wan}")

    # ---- 6. the fleet_scan golden scenario, payload replay ---------------
    with open(os.path.join(HERE, "tests/goldens/scenarios/fleet_scan.json")) as f:
        gsc = ScenarioConfig.from_dict(json.load(f)["scenario"])
    for uk in (None, True, False):
        g = Experiment.from_scenario(gsc, use_kernel=uk, collect="payloads",
                                     device="cuda").run()
        emit({"phase": "golden_fleet_scan", "use_kernel": uk,
              "wan_bytes": g.wan_bytes,
              "reference_wan_bytes_cpu": GOLDEN_REF_WAN_BYTES,
              "nrmse": g.nrmse})

    # ---- 7. the kernels line and the result ------------------------------
    emit({"kernels": [dict(name=n, route="cuda", source=KERNELS[n][0],
                           replaces=KERNELS[n][1], launches=launches[n],
                           **results[n]) for n in KERNELS]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def profile_main_path(ex, windows, torch, n_prof: int = 3) -> None:
    """Profile ``n_prof`` windows of the main path with torch.profiler:
    the time of each stage range of ``runtime/step.py`` and the device's
    busy share (full table in chiprun_out/profile_main_path.txt)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.step import STAGES
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rep = ex.run(windows, n_windows=n_prof)
        torch.cuda.synchronize()
    evs = prof.key_averages()
    with open(os.path.join(OUT_DIR, "profile_main_path.txt"), "w") as f:
        f.write(evs.table(sort_by="cpu_time_total", row_limit=60))

    def dev_ms(e, total=False):
        name = "device_time_total" if total else "self_device_time_total"
        old = "cuda_time_total" if total else "self_cuda_time_total"
        return getattr(e, name, getattr(e, old, 0)) / 1e3

    # the stage ranges as the host ran them (one CPU event per range name)
    ranges = {e.key.split("/", 1)[1]: e for e in evs
              if e.key.startswith("window_step/")
              and not str(e.device_type).endswith("CUDA")}
    missing = [s_ for s_ in STAGES if s_ not in ranges]
    if missing:
        raise AssertionError(f"profile lacks the step's ranges {missing}")
    host = {s_: ranges[s_].cpu_time_total / 1e3 / n_prof for s_ in STAGES}
    total = sum(host.values())

    # device-side events only (an aten op's self device time repeats its
    # kernels'); memcpys apart from kernels
    on_dev = [e for e in evs if str(e.device_type).endswith("CUDA")
              and not e.key.startswith("window_step/")]
    kernels = [e for e in on_dev if not e.key.startswith("Memcpy")]
    kernel_ms = sum(dev_ms(e) for e in kernels)
    memcpy_ms = sum(dev_ms(e) for e in on_dev if e.key.startswith("Memcpy"))
    loop_ms = rep.raw["scan_seconds"] * 1e3
    top = sorted(kernels, key=lambda e: -dev_ms(e))[:10]
    emit({"phase": "profile", "windows": n_prof,
          "stage_host_ms_per_window": host,
          "stage_share": {s_: v / total for s_, v in host.items()},
          "stage_device_ms_per_window": {
              s_: dev_ms(ranges[s_], total=True) / n_prof for s_ in STAGES},
          "loop_ms": loop_ms, "kernel_ms": kernel_ms,
          "memcpy_ms": memcpy_ms,
          "device_busy_share": kernel_ms / loop_ms,
          "kernel_launches": sum(e.count for e in kernels),
          "top_kernels": [{"name": e.key[:70], "count": e.count,
                           "ms": dev_ms(e)} for e in top]})


if __name__ == "__main__":
    sys.exit(main())
