#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one JSON line each; any failed check exits non-zero:
  1. the card (name and power limit from nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
  3. each kernel against its plain PyTorch version on the card at the main
     path's shape and at ragged shapes, and timed beside its bound (event
     and profiler device time); the fleet path's two kernels also at a
     fleet larger than L2 (``LARGE``);
  4. the main path: ``Experiment.from_scenario(...).run`` on the card for a
     fleet of E = 1024 sites (4 regions x 256), k = 8 streams, windows of
     N = 256 tuples, 4 generated windows cycled to T = 200, through both
     kernels (``use_kernel=True``), with the launch counts asserted;
  5. the same scenario at T = 20 with the plain versions on the card,
     held against the kernel path;
  6. the ``fleet_scan`` golden scenario with the payload replay;
  7. slice 2's path: the kernel entry points ``window_moments_xxt`` (the
     window shapes of ``benchmarks/kernel_bench.py``, f32 and bf16) and
     ``flash_attention`` (attention heads of yi-9b, gemma3-12b's local
     layers and whisper-large-v3's cross-attention in bf16 and in f32,
     yi-9b heads at the 32k prefill length, and small shapes whose last
     rows have no live key), launch counts asserted (the bf16 cases
     through the tensor-core kernel, f32 through the CUDA-core one), every
     output held against the plain version on the card;
  8. those kernels timed beside their bounds, their plain versions and
     ``scaled_dot_product_attention`` as the library yardstick, with each
     flash kernel's registers and spills per head dim and its SASS counts
     (HGMMA in the tensor-core kernel; FFMA and no tensor-core instruction
     in the CUDA-core one);
  9. the kernels line, then ``{"ok": true, "device": {...}}`` last.

Detailed profiles go to ``chiprun_out/``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# H100 SXM data sheet: HBM3 bandwidth, f32 (non-tensor-core) peak and
# bf16 dense tensor-core peak
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

MAIN = {"n_regions": 4, "sites_per_region": 256, "k": 8, "window": 256,
        "pool": 4, "T": 200, "T_plain": 20}
GOLDEN_REF_WAN_BYTES = 11080   # live JAX reference, fleet_scan, CPU
# a fleet of the main path's kind whose data (134 MB for stream_stats_fleet,
# 268 MB for polyfit) does not fit in the 50 MB L2: (E, k, N)
LARGE = (4096, 8, 1024)

# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "stream_stats_fleet": (
        "src/repro_torch/kernels/csrc/stream_stats_fleet.cu",
        "src/repro/kernels/stream_stats/kernel.py:95"),
    "polyfit": (
        "src/repro_torch/kernels/csrc/polyfit.cu",
        "src/repro/kernels/polyfit/kernel.py:55"),
    "stream_stats": (
        "src/repro_torch/kernels/csrc/stream_stats.cu",
        "src/repro/kernels/stream_stats/kernel.py:122"),
    # bf16 on the tensor cores, f32 on the CUDA cores
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "src/repro/kernels/flash_attention/kernel.py:107"),
    "flash_attention_f32": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:107"),
}

# slice 2.  window_moments_xxt: (k, N, dtype), benchmarks/kernel_bench.py's
# shapes; the kernels line carries the largest in f32.
WINDOWS = [(8, 4096, "float32"), (32, 8192, "float32"),
           (64, 16384, "float32"), (64, 16384, "bfloat16")]
WINDOW_TIMED = 2
# (rtol, atol): tests/test_kernel_stream_stats.py's f32 tolerance for both
# types, since kernel and plain version both sum in f32 from the same
# bf16-rounded inputs
WINDOW_TOL = {"float32": (2e-5, 1e-2), "bfloat16": (2e-5, 1e-2)}
# flash_attention at full head width, batch 1:
# name -> (S, T, H, KV, hd, causal, window, dtype); configs/<model>.py
ATTENTION = {
    "a_yi_9b_causal": (4096, 4096, 32, 4, 128, True, 0, "bfloat16"),
    "b_gemma3_12b_local": (4096, 4096, 16, 8, 240, True, 1024, "bfloat16"),
    "c_whisper_cross": (448, 1500, 20, 20, 64, False, 0, "bfloat16"),
    "d_yi_9b_causal_f32": (4096, 4096, 32, 4, 128, True, 0, "float32"),
    "e_gemma3_12b_local_f32": (4096, 4096, 16, 8, 240, True, 1024,
                               "float32"),
    "f_whisper_cross_f32": (448, 1500, 20, 20, 64, False, 0, "float32"),
    # configs/__init__.py prefill_32k; the plain version's (B, H, S, T)
    # scores do not fit, so only its last rows are checked
    "yi_9b_prefill_32k": (32768, 32768, 32, 4, 128, True, 0, "bfloat16"),
}
# rows with no live key (S >= T + window): the plain version gives them
# the mean of v over all T keys; checked, not timed
NO_LIVE_KEY = {
    "nokey_causal": (200, 64, 2, 2, 32, True, 16, "bfloat16"),
    "nokey_cross": (200, 64, 2, 2, 32, False, 16, "bfloat16"),
    "nokey_causal_f32": (200, 64, 2, 2, 32, True, 16, "float32"),
    "nokey_cross_f32": (200, 64, 2, 2, 32, False, 16, "float32"),
}
# the case each flash_attention row of the kernels line carries
ATTENTION_TIMED = {"flash_attention": "a_yi_9b_causal",
                   "flash_attention_f32": "d_yi_9b_causal_f32"}
LONG_CASE, LONG_ROWS = "yi_9b_prefill_32k", 256
# f32: max |err| <= atol.  bf16: the plain version computes in f32 and
# rounds once to bf16; the tensor-core kernel reads the same bf16 inputs,
# forms the scores exactly in f32 and carries P to ~16 bits as two bf16
# halves, so it too is the f32 result rounded once, up to summation order:
# the two differ by at most one bf16 step (2**-7 |want|) per element.  So
# every |err| <= atol + rtol |want|, and the RMS of the error <= rms x the
# RMS of the plain output (a kernel off by a uniform 1.5% fails the RMS
# test; one returning half the value or zeros fails both; P rounded once
# to bf16 fails the first by 3-16x, tests/test_torch_flash_attention.py)
ATTENTION_TOL = {"float32": {"atol": 1e-5},
                 "bfloat16": {"rtol": 1e-2, "atol": 1e-4, "rms": 2e-3}}


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


def bound_ms(nbytes: float, flops: float, peak_flops: float = PEAK_F32_FLOPS):
    """The least time the card could take: bytes over the memory rate or
    operations over ``peak_flops``, whichever is longer."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def live_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one attention head."""
    import numpy as np
    qp = np.arange(S, dtype=np.int64)
    hi = np.minimum(qp, T - 1) if causal else np.full(S, T - 1)
    lo = (np.maximum(qp - window + 1, 0) if window > 0
          else np.zeros(S, np.int64))
    return int(np.maximum(hi - lo + 1, 0).sum())


def device_ms(fn, torch, reps: int, match: str, launches_per_call: int,
              attempts: int = 3, pad: int = 16) -> float:
    """Device time per call of the kernels whose names contain ``match``,
    from torch.profiler over ``reps`` calls (the CUDA-event time of a small
    kernel also counts its wrapper's host work), each call launching
    ``launches_per_call`` of them.  After a long profile with CPU activity
    (``profile_main_path``) later profiles drop a few kernel records, so
    the calls sit between ``pad`` launches of a small fill kernel on each
    side, the time is divided by the calls the profile recorded, not by
    ``reps``, and a profile without a record is taken again, up to
    ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    fill = torch.zeros(1, device="cuda")
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(pad):
                fill.add_(1.0)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            for _ in range(pad):
                fill.add_(1.0)
            torch.cuda.synchronize()
        total, records = 0.0, 0
        for e in prof.key_averages():
            if match in e.key:
                total += getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0))
                records += e.count
        if total > 0.0:
            break
    else:
        raise AssertionError(f"{attempts} profiles show no device time for "
                             f"{match}")
    # the fill kernels the profile kept before the first and after the last
    # matched record, in device order: a dropped record shows as fewer
    on_dev = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    hits = [i for i, e in enumerate(on_dev) if match in e.name]
    before, after = hits[0], len(on_dev) - 1 - hits[-1]
    calls = records / launches_per_call
    if calls != reps or attempt > 1 or min(before, after) < pad:
        emit({"phase": "profile_records", "match": match, "calls": reps,
              "kernel_records": records, "attempt": attempt,
              "fill_records_before": before, "fill_records_after": after,
              "fill_launches_each_side": pad})
    return total / 1e3 / calls


def fleet_kernel_time(torch, kernel, label, shape, fn, plain, match, nbytes,
                      flops, reps, note) -> dict:
    """Time one of the fleet path's kernels (CUDA events and the profiler's
    device time) beside its plain version and its bound; print the
    ``kernel_time`` line and return the kernels line's numbers."""
    ms = time_cuda(fn, torch, reps)
    dev_ms = device_ms(fn, torch, reps, match, launches_per_call=1)
    plain_ms = time_cuda(plain, torch, reps)
    b_ms, b_by = bound_ms(nbytes, flops)
    emit({"phase": "kernel_time", "kernel": kernel, "case": label,
          "shape": shape, "kernel_ms": ms, "kernel_device_ms": dev_ms,
          "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
          "device_over_bound": dev_ms / b_ms, "bytes": nbytes,
          "flops": flops, "launches_per_window":
              2 if kernel == "stream_stats_fleet" else 1,
          "library_ms": None, "library_note": note})
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


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
    # tolerances of tests/test_kernel_stream_stats.py.  The large fleet's
    # inputs are seeded torch.randn on the card.
    gen_l = torch.Generator(device=dev).manual_seed(16)
    El, kl, Nl = LARGE
    xl = torch.randn(El, kl, Nl, device=dev, generator=gen_l) * 1.5 + 2.0
    ss_cases = [("values", w0), ("ranks", ranks),
                ("ragged", randn(3, 5, 200, scale=1.5, shift=2.0)),
                ("ragged", randn(2, 9, 130, scale=3.0)), ("large", xl)]
    ss_err = 0.0
    for label, x in ss_cases:
        got = ss_ops.stream_stats_fleet_cuda(x)
        torch.cuda.synchronize()
        err = check("stream_stats_fleet", got, fleet_stats_ref(x),
                    [label, *x.shape], (True, False), 2e-5, 1e-2)
        if label in ("values", "ranks"):
            ss_err = max(ss_err, err)
    for label, x in (("main", w0), ("large", xl)):
        e_, k_, n_ = x.shape
        nbytes = x.numel() * 4 + e_ * k_ * (4 + k_) * 4
        flops = e_ * (2 * k_ * k_ * n_ + 7 * k_ * n_)
        row = fleet_kernel_time(
            torch, "stream_stats_fleet", label, list(x.shape),
            lambda: ss_ops.stream_stats_fleet_cuda(x),
            lambda: fleet_stats_ref(x), "stream_stats_fleet_kernel",
            nbytes, flops, reps,
            note="no single PyTorch call computes it: torch.bmm gives only "
                 "the Gram part")
        if label == "main":
            results["stream_stats_fleet"] = {"max_abs_err": ss_err, **row}

    # polyfit: bitwise (same products, same order); the main-path rows
    # are (y*w, u*w) with u a standardized neighbouring stream
    y = w0.reshape(E * k, N)
    xp = torch.roll(w0, 1, dims=1).reshape(E * k, N)
    u = ((xp - xp.mean(-1, keepdim=True))
         / xp.std(-1, keepdim=True)).contiguous()
    yl = torch.randn(El * kl, Nl, device=dev, generator=gen_l) * 2.0
    ul = torch.randn(El * kl, Nl, device=dev, generator=gen_l)
    pf_cases = [("fleet", y, u),
                ("ragged", randn(15, 200, scale=2.0), randn(15, 200)),
                ("ragged", randn(18, 130, scale=2.0), randn(18, 130)),
                ("large", yl, ul)]
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
    for label, yy, uu in (("main", y, u), ("large", yl, ul)):
        nbytes = 2 * yy.numel() * 4 + yy.shape[0] * 11 * 4
        row = fleet_kernel_time(
            torch, "polyfit", label, list(yy.shape),
            lambda: poly_ops.polyfit_cuda(yy, uu),
            lambda: polyfit_ref(yy, uu), "polyfit_kernel", nbytes,
            yy.numel() * 18, reps,
            note="no single PyTorch call computes the 11 power sums")
        if label == "main":
            results["polyfit"] = {"max_abs_err": pf_err, **row}
    # free the large fleet before the main path's peak memory is read
    del ss_cases, pf_cases, xl, yl, ul, x, yy, uu, got, want

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

    # ---- 7. slice 2's path: the kernel entry points at model widths -----
    launches.update(slice2_path(torch, dev, results))

    # ---- 9. the kernels line and the result ------------------------------
    emit({"kernels": [dict(name=n, route="cuda", source=KERNELS[n][0],
                           replaces=KERNELS[n][1], launches=launches[n],
                           **results[n]) for n in KERNELS]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def slice2_path(torch, dev, results) -> dict:
    """Phases 7 and 8: drive ``window_moments_xxt`` and ``flash_attention``
    through their entry points with the launch counts at 0, hold every
    output against its plain version, then time the kernels.  Fills
    ``results`` and returns the launch counts of the run."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, window_moments_xxt
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.stream_stats import ops as ss_ops
    from repro_torch.kernels.stream_stats.ref import stream_stats_ref

    gen = torch.Generator(device=dev).manual_seed(14)
    xs = [torch.randn(k, n, device=dev, generator=gen).to(getattr(torch, dt))
          for k, n, dt in WINDOWS]
    qkv = {}
    cases = {**ATTENTION, **NO_LIVE_KEY}
    for name, (S, T, H, KV, hd, _, _, dt) in cases.items():
        qkv[name] = [torch.randn(1, L, heads, hd, device=dev, generator=gen)
                     .to(getattr(torch, dt))
                     for L, heads in ((S, H), (T, KV), (T, KV))]

    # ---- 7. the path, counted --------------------------------------------
    ss_ops.WINDOW_LAUNCHES = 0
    fa_ops.LAUNCHES = 0
    fa_ops.SM90_LAUNCHES = 0
    t0 = time.perf_counter()
    stats = [window_moments_xxt(x) for x in xs]
    outs = {name: flash_attention(*qkv[name], causal=cases[name][5],
                                  window=cases[name][6])
            for name in cases}
    torch.cuda.synchronize()
    launches = {"stream_stats": ss_ops.WINDOW_LAUNCHES,
                "flash_attention": fa_ops.SM90_LAUNCHES,
                "flash_attention_f32": fa_ops.LAUNCHES - fa_ops.SM90_LAUNCHES}
    emit({"phase": "slice2_path", "seconds": time.perf_counter() - t0,
          "windows": [list(w) for w in WINDOWS],
          "attention": {n: list(c) for n, c in cases.items()},
          "launches": launches, "flash_attention_all": fa_ops.LAUNCHES})
    n_bf16 = sum(c[7] == "bfloat16" for c in cases.values())
    if launches != {"stream_stats": len(WINDOWS), "flash_attention": n_bf16,
                    "flash_attention_f32": len(cases) - n_bf16}:
        raise AssertionError(f"kernel launches on slice 2's path: {launches};"
                             f" every bf16 case must take the tensor-core "
                             f"kernel, every f32 case the CUDA-core one")

    ss_err = 0.0
    for (k, n, dt), x, got in zip(WINDOWS, xs, stats):
        want = stream_stats_ref(x)
        rtol, atol = WINDOW_TOL[dt]
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ok = all(g.shape == w.shape and torch.isfinite(g).all()
                 and torch.allclose(g, w, rtol=rtol, atol=atol)
                 for g, w in zip(got, want))
        emit({"phase": "kernel_check", "kernel": "stream_stats",
              "shape": [k, n], "dtype": dt, "max_abs_err": err,
              "rtol": rtol, "atol": atol, "ok": ok})
        if not ok:
            raise AssertionError(f"stream_stats disagrees with its plain "
                                 f"version at {(k, n, dt)}: max |err| {err}")
        ss_err = max(ss_err, err)

    fa_err = {"bfloat16": 0.0, "float32": 0.0}
    for name, (S, T, H, KV, hd, causal, window, dt) in cases.items():
        q, k, v = qkv[name]
        got = outs[name]
        rows = LONG_ROWS if name == LONG_CASE else S
        want = flash_attention_ref(q[:, S - rows:], k, v, causal=causal,
                                   window=window, q_offset=S - rows)
        got = got[:, S - rows:]
        tol = ATTENTION_TOL[dt]
        d = (got.float() - want.float()).abs()
        w = want.float().abs()
        err = float(d.max())
        # the largest |err| / (atol + rtol |want|): <= 1 passes
        scaled = float((d / (tol["atol"] + tol.get("rtol", 0.0) * w)).max())
        rms = float(d.square().mean().sqrt() / w.square().mean().sqrt())
        ok = (got.dtype == q.dtype and bool(torch.isfinite(got).all())
              and scaled <= 1.0 and rms <= tol.get("rms", float("inf")))
        emit({"phase": "kernel_check", "kernel": "flash_attention",
              "case": name, "shape": [1, S, T, H, KV, hd],
              "causal": causal, "window": window, "dtype": dt,
              "rows_checked": [S - rows, S], "rows_without_keys":
                  max(0, S - T - window + 1) if window > 0 else 0,
              "max_abs_err": err,
              "max_abs_want": float(w.max()), "err_over_tol": scaled,
              "rms_err_over_rms_want": rms, **tol, "ok": ok})
        if not ok:
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version on {name}: max |err| {err}, "
                                 f"err/tol {scaled}, RMS ratio {rms}")
        fa_err[dt] = max(fa_err[dt], err)
        del want, d, w
    del outs, stats

    # ---- 8. times beside bounds ------------------------------------------
    for i, ((k, n, dt), x) in enumerate(zip(WINDOWS, xs)):
        ms = time_cuda(lambda: ss_ops.stream_stats_cuda(x), torch, 50)
        # two kernels per call: stream_stats_partial, stream_stats_finish
        dev_ms = device_ms(lambda: ss_ops.stream_stats_cuda(x), torch, 20,
                           "stream_stats_", launches_per_call=2)
        plain = time_cuda(lambda: stream_stats_ref(x), torch, 50)
        nbytes = x.numel() * x.element_size() + (4 * k + k * k) * 4
        flops = k * (k + 1) * n + 7 * k * n   # the upper triangle suffices
        b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS
                              if dt == "bfloat16" else PEAK_F32_FLOPS)
        emit({"phase": "kernel_time", "kernel": "stream_stats",
              "shape": [k, n], "dtype": dt, "kernel_ms": ms,
              "kernel_device_ms": dev_ms, "plain_ms": plain,
              "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
              "flops": flops, "library_ms": None,
              "library_note": "none: x @ x.T gives only the Gram part"})
        if i == WINDOW_TIMED:
            results["stream_stats"] = {
                "max_abs_err": ss_err, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None}

    sm90 = flash_build_facts("flash_attention")
    emit({"phase": "kernel_build", "kernel": "flash_attention", **sm90})
    f32 = flash_build_facts("flash_attention_f32")
    emit({"phase": "kernel_build", "kernel": "flash_attention_f32", **f32})
    for name, (S, T, H, KV, hd, causal, window, dt) in ATTENTION.items():
        q, k, v = qkv[name]
        long = name == LONG_CASE
        reps, warm = (3, 1) if long else (20, 5)
        ms = time_cuda(lambda: fa_ops.flash_attention_cuda(
            q, k, v, causal=causal, window=window), torch, reps, warm)
        dev_ms = device_ms(lambda: fa_ops.flash_attention_cuda(
            q, k, v, causal=causal, window=window), torch, reps, "flash_fwd",
            launches_per_call=1)
        plain = None if long else time_cuda(lambda: flash_attention_ref(
            q, k, v, causal=causal, window=window), torch, 10, 2)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if window > 0:
            qp = torch.arange(S, device=dev)[:, None]
            kp = torch.arange(T, device=dev)[None, :]
            mask = (qp - kp < window) & ((kp <= qp) if causal else True)

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=H != KV)
        lib = time_cuda(sdpa, torch, reps + 2, warm)
        lib_diff = float((sdpa().transpose(1, 2).float() - fa_ops
                          .flash_attention_cuda(q, k, v, causal=causal,
                                                window=window).float())
                         .abs().max())
        nbytes = 2 * q.numel() * q.element_size() \
            + 2 * k.numel() * k.element_size()
        flops = 4 * H * hd * live_pairs(S, T, causal, window)
        b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS
                              if dt == "bfloat16" else PEAK_F32_FLOPS)
        emit({"phase": "kernel_time", "kernel": "flash_attention",
              "case": name, "shape": [1, S, T, H, KV, hd], "dtype": dt,
              "kernel_ms": ms, "kernel_device_ms": dev_ms, "plain_ms": plain,
              "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
              "flops": flops, "tflops": flops / ms / 1e9, "library_ms": lib,
              "library": "scaled_dot_product_attention",
              "library_max_abs_diff": lib_diff,
              "kernel_source": KERNELS["flash_attention" if dt == "bfloat16"
                                       else "flash_attention_f32"][0],
              "ptxas": (sm90 if dt == "bfloat16" else f32)["ptxas"].get(hd)})
        for row, case in ATTENTION_TIMED.items():
            if name == case:
                results[row] = {
                    "max_abs_err": fa_err[dt], "ms": ms, "device_ms": dev_ms,
                    "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib}
    return launches


# kernels line name -> (library, the kernel's name as ptxas mangles it
# with its head dim, SASS opcodes it must have, opcodes it must not have)
FLASH_BUILDS = {
    "flash_attention": ("flash_attention_sm90", "flash_fwd_sm90", ("HGMMA",),
                        ()),
    # f32 on the CUDA cores: FFMA, and no tensor-core product (no TF32)
    "flash_attention_f32": ("flash_attention", "flash_fwd", ("FFMA",),
                            ("HMMA", "HGMMA")),
}


def flash_build_facts(kernel: str) -> dict:
    """A flash kernel as built: registers and spills of each head-dim
    instantiation from ``nvcc -Xptxas -v``, and, where the toolkit has
    ``cuobjdump``, the count of each SASS opcode of ``FLASH_BUILDS`` in
    its library (those it must have are there, those it must not are
    not)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import HEAD_DIMS
    lib_name, symbol, need, forbid = FLASH_BUILDS[kernel]
    lib = build.lib_path(lib_name)
    ptxas, hd = {}, None
    for ln in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in ln:
            m = re.search(symbol + r"ILi(\d+)E", ln)
            hd = int(m.group(1)) if m else None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and hd is not None:
            ptxas.setdefault(hd, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and hd is not None:
            ptxas.setdefault(hd, {})["registers"] = int(m.group(1))
    if any(len(ptxas.get(d, {})) != 3 for d in HEAD_DIMS):
        raise AssertionError(f"ptxas -v of {kernel} lacks head dims: {ptxas}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = None
    if os.path.exists(cuobjdump):
        out = subprocess.run([cuobjdump, "-sass", str(lib)],
                             capture_output=True, text=True, timeout=120)
        ops = re.findall(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                         out.stdout, flags=re.M)
        sass = {op: sum(o == op for o in ops) for op in (*need, *forbid)}
        if any(sass[op] == 0 for op in need) or any(sass[op] for op in forbid):
            raise AssertionError(f"{kernel}'s library has SASS counts {sass}: "
                                 f"it needs {need} and must not have {forbid}")
    return {"source": KERNELS[kernel][0], "ptxas": ptxas,
            "sass_counts": sass, "cuobjdump": cuobjdump
            if sass is not None else None}


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
