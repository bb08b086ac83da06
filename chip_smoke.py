#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one JSON line each; any failed check exits non-zero:
  1. the card (name and power limit from nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
  3. each kernel against its plain PyTorch version on the card at the main
     path's shape and at ragged and short shapes (the fleet kernel's
     outputs all bitwise), and timed beside its bound (event
     and profiler device time); the fleet path's two kernels also at a
     fleet larger than L2 (``LARGE``);
  4. the main path: ``Experiment.from_scenario(...).run`` on the card for a
     fleet of E = 1024 sites (4 regions x 256), k = 8 streams, windows of
     N = 256 tuples, 4 generated windows cycled to T = 60 (100 before
     slice 19, 200 before slice 14), through both kernels (``use_kernel=True``), with the
     launch counts asserted;
  5. the same scenario at T = 20 with the plain versions on the card,
     held against the kernel path;
  6. the ``fleet_scan`` golden scenario with the payload replay;
  7. slice 2's path: the kernel entry points ``window_moments_xxt`` (the
     window shapes of ``benchmarks/kernel_bench.py``, f32 and bf16, and a
     67 MB window larger than L2) and
     ``flash_attention`` (attention heads of yi-9b, gemma3-12b's local
     layers and whisper-large-v3's cross-attention in bf16 and in f32,
     yi-9b heads at the 32k prefill length, and small shapes whose last
     rows have no live key), launch counts asserted (the bf16 cases
     through the tensor-core kernel, f32 through the CUDA-core one), every
     output held against the plain version on the card;
  8. those kernels timed beside their bounds, their plain versions and
     ``scaled_dot_product_attention`` as the library yardstick (the window
     kernel also beside the launch floor, the device time of a one-element
     ``add_``), with each kernel's registers and spills per instantiation
     and its SASS counts (HGMMA in the tensor-core flash kernel; FFMA and no
     tensor-core instruction in the f32 flash and the window kernels);
  9. slice 7's goldens on the card: ``single_scan`` and
     ``single_scan_steps`` with the payload replay, under both kernel
     settings, against the live JAX reference's WAN bytes, with the
     launch counts asserted and the one-site sample sets drawn on the
     card held bitwise against the same code on the CPU;
 10. slice 7's path: one edge gateway (``turbine``, k = 8 streams,
     windows of N = 4096 tuples, 4 generated windows cycled to T = 50;
     200 before slice 14)
     through both kernels, profiled over 3 windows, then at T = 5 (10
     before slice 14) with
     the plain versions on the card, held against the kernel path; both
     kernels held against their plain versions and timed at this path's
     shapes and at ``single_scan``'s;
 11. ``fleet_scan`` under the mean and multi model families;
 12. slices 8 and 9's golden sweep: ``repro_torch.sweep`` over the seven
     scan goldens the port runs, on the card with the kernels and with the
     plain versions, against the committed ``tests/torch_goldens/reports``
     (every counter bitwise, every float within the class the runner
     holds it to; the two chaos goldens' counters also against the live
     reference's, ``CHAOS_REF``, and on the kernels' path the region
     golden against the reference's own kernel path,
     ``CHAOS_REF_KERNEL_PATH``);
 13. slice 8's path: adaptive re-planning (the page_hinkley drift gate on
     ``stream_stats_fleet``) at the main path's width, E = 1024 sites,
     k = 8, N = 256, over ``ADAPTIVE["T"]`` generated windows whose
     regional correlations flip at the middle; launches asserted (row 1 =
     T + re-plans, row 2 = re-plans), windows/sec beside the same windows
     planned every window, the stage split with ``window_step/gate`` over
     the first ``ADAPTIVE["n_prof"]`` windows (all T before slice 19), the
     plain versions on the card against the kernels, and the adaptive
     golden on the card against the live reference's counters;
 14. slice 9's path: chaos fault injection at the main path's width (its
     fleet, planner and 4 windows cycled to ``CHAOS["T"]``; a regional
     outage, joins, flaps and random flaps): launches asserted, dead
     (window, site) cells with budget 0 and 0 bytes, the liveness table
     against the CPU's, windows/sec, and the stage split and busy share
     over a 3-window profile;
 15. the chaos path's checkpoint resume: the carry saved at window
     ``CHAOS["cut"]`` (inside the outage), restored into a fresh runtime
     and run to the end, held bitwise against the uninterrupted run (byte
     and budget histories, served estimates, final state), each window's
     live budgets summing to what the CPU computes from the same
     controller state;
 16. slice 10's fleet event path (``runtime="event"``) at the main path's
     width: its fleet, planner and 4 windows cycled to ``EVENT["T"]`` on
     the WAN of ``fleet_event_cost_aware_wan`` (latency, jitter, drops,
     bandwidth, the link-cost-aware controller) with
     ``single_event_retransmit``'s retransmits and a fixed straggler rule
     (~1% of counts at 0); launches asserted (row 1 = 2 T, row 2 = T),
     windows/sec, the plan's and the per-site loop's seconds a window,
     the WAN counters, freshness, and the card's busy share over a
     3-window profile;
 17. the event loop fed the scan's per-window plans (zero-latency links,
     a static controller, samples drawn on the card) at E = 1024: WAN
     bytes and cost, every per-stream NRMSE table and the budget history
     bitwise the scan's;
 18. phase 16's scenario with the plain versions on the card, held
     against the kernels (WAN bytes within 0.1%, AVG NRMSE within 1%);
 19. slice 11's single-edge event path: one edge gateway (``turbine``,
     k = 8 streams, windows of N = 4096 tuples, ``SINGLE_EVENT["T"]``
     generated windows; 8 since slice 14, 15 since slice 12, 50 before)
     planned by the host planner with
     ``single_event_cubic``'s planner (cubic, Spearman, k-SE, the f64
     IPM, budget 0.3) on ``single_event_retransmit``'s WAN (drops 0.5,
     3 retries at 150 ms) with a fixed straggler rule: windows/sec, the
     plan's seconds a window split into the card's part (statistics,
     fit, epsilon, permutations, one read) and the host's (the IPM and
     rounding), Newton steps a window, the WAN counters, NRMSE and peak
     memory; the window statistics on the card, rows 1 and 2 launched 0
     times, and the same run on the CPU bitwise in every window's
     allocation, every counter and every NRMSE;
 20. slice 12's baseline path: Fig. 5's comparison on one edge
     (``BASELINE``: smartcity, windows of 256, budget 0.26) planned by the
     host planner (model, mean) and by the ApproxIoT, S-VOILA and SRS
     baselines; per method the WAN fraction, NRMSE per query, windows/sec
     and plan seconds a window;
 21. slice 12's iid path: Fig. 9's settings (``IID``) under iid,
     thinning and m-dependence: the strides, AVG NRMSE and windows/sec;
 22. slice 12's host engine path: ``fleet_event_host_engine``'s planner
     and controller on fleet_bench's fleet (``HOST_ENGINE``: 16 sites,
     k = 6, N = 128, T = 2; 4 before slice 14, 8 before slice 13): plan
     seconds a site,
     windows/sec, the WAN fraction; in 20-22 rows 1 and 2 launched 0
     times, and each run repeated on the CPU, every allocation (and
     stride, and r2), counter and NRMSE bitwise;
 23. slice 13's site sharding at the main path's width (``SHARDED``):
     ``runtime="scan_sharded"`` in this process (world size 1) for
     ``SHARDED["T"]`` windows, bitwise ``runtime="scan"``'s run (every
     per-window table, every NRMSE, the final state); then two ranks on a
     gloo group, both on the one card, each over half the fleet for
     ``SHARDED["T_ranks"]`` windows, bitwise this process's run of as many
     windows, with rows 1 and 2 launched 2 and 1 times a window on each
     rank; and ``engine="sharded"`` on the fleet event path in this
     process and on the two ranks, bitwise ``engine="batched"``'s run;
     windows/sec at world sizes 1 and 2;
 24. slice 14's LM serving path on gemma3-12b at full width (``LM``: 48
     layers, d 3840, 16 heads of 240, 8 kv heads, vocab 262144; weights
     from a seeded generator on the card): in f32, the flash kernel on
     every layer's own q, k and v of a 4 x 512 prefill against the same
     attention in f64, at most twice the plain version's error there; the
     rings layer by layer (layers 0 and 5 prefill 1000 positions into a
     cache and decode 40 that wrap the local layer's 1032-slot ring, each
     step within 1e-3 of the layer's largest output over all 1040
     positions); the two routes end to end at one period (6 layers),
     printed (random weights make any two f32 orders part ways there).
     Then ``ServeEngine`` serves 8 requests of 16-1000 prompt tokens, 32
     new tokens each, in bf16 on 4 slots, every prefill layer's
     self-attention on the tensor-core flash kernel (48 launches a
     prefill, asserted): tokens/sec, prefill ms a batch, decode ms a step,
     peak memory, and a profile of a prefill batch and three decode steps;
     the 4 x 512 batch in bf16 on the kernel route no further from the f32
     plain route than 1.25 times the bf16 plain route; the bf16 kernel on
     layers 0 and 5's own q, k, v against its plain version (row 4's RMS
     bound; element-wise, each against f64); and the kernel timed at the
     prefill shape, local and global, beside SDPA and its bound;
 25. slice 15's LM training path on starcoder2-3b at full width
     (``TRAIN``: 30 layers, d 3072, 24 heads of 128, 2 kv heads, vocab
     49152; f32 masters, m and v, 69 GB with the gradients; bf16
     activations; every period block recomputed in the backward pass),
     after the serve model is freed: ``launch.train.main`` for 8 steps of
     4 x 512 tokens (losses, grad norms, median step ms split into forward
     + backward and optimizer, tokens/sec, peak memory); a fixed batch at
     a constant lr of 1e-4 for 8 steps (every leaf a finite, nonzero
     gradient after step 1; the loss after step 8 below step 0's); the
     four dense smoke families' f32 step on the card against the CPU; the
     driver's smoke run failed at step 15 and resumed from its step-10
     checkpoint (25 and 20 of 30 steps before slice 18) against the
     uninterrupted run (losses to 1e-5 relative,
     and whether bitwise).  The flash kernels launch 0 times (asserted):
     a training forward takes the plain attention, as the reference's
     does;
 26. slice 16's MoE serving path on deepseek-moe-16b at full width
     (``MOE_SERVE``: 28 layers, d 2048, 16 heads of 128, 64 routed
     experts top-6 and 2 shared, vocab 102400; 16.9 B seeded parameters):
     in f32 on the first 2 layers (4 before slice 18), each layer's MoE
     on its own input of a 4 x 512 prefill, card against CPU (routes equal but at near ties,
     the card's error against an f64 evaluation of the same routes at
     most twice the CPU's); then ``ServeEngine`` as in 24 in bf16 (28
     tensor-core flash launches a prefill, asserted; the dropped slots of
     every prefill layer), a profile of a prefill and three decode steps,
     one MoE layer's router, dispatch, experts and shared experts
     profiled at the prefill and decode shapes, the 4 x 512 batch on both
     attention routes, and row 4 on layer 0's q, k, v against its plain
     version and timed beside SDPA and its bound;
 27. slice 16's MoE training path on qwen3-moe-30b-a3b at full width cut
     to 4 of 48 layers (``MOE_TRAIN``: 128 experts top-8, d 2048, vocab
     151936; 3.1 B parameters, ~50 GB of state): ``launch.train.main`` for
     8 steps of 4 x 512 tokens (losses near ln 151936, ``moe_lb`` and
     ``moe_z`` finite, step ms, tokens/sec, peak memory); one step's
     gradients all finite, the experts with an all-zero gradient exactly
     those no token was routed to; both MoE smoke families' f32 step on
     the card against the CPU, routes equal; 0 flash launches;
 28. slice 17's Mamba2 serving path on mamba2-780m at full width
     (``SSM_SERVE``: 48 layers, d 1536, 48 SSD heads of 64, d_state 128,
     chunk 256, vocab 50280; 0.78 B seeded parameters): in f32 on the
     first 2 layers (4 before slice 18), each Mamba mixer on its own input
     of a 4 x 512 prefill (two chunks) and one decode step from the cache it leaves,
     card against CPU (the card's error against an f64 evaluation at most
     twice the CPU's); at full depth in f32 the 4 x 512 batch in chunks of
     256 against one chunk of 512, and 12 decode steps after a 500-token
     prefill against the forward (rtol and atol 1e-3); then
     ``ServeEngine`` as in 24 in bf16 (no flash launch, asserted; the
     padded prefill lengths, one not a multiple of 256: the one-chunk
     fallback), a profile of a prefill and three decode steps
     (``chiprun_out/profile_ssm.txt``), the 4 x 512 batch in bf16 against
     f32 (printed); and jamba smoke's serve run (Mamba, attention and MoE
     layers) in f32 on the card against the CPU, tokens equal, and in
     bf16, one tensor-core flash launch a prefill (asserted);
 29. slice 17's Mamba2 training path on mamba2-780m at full width
     (``SSM_TRAIN``: ~12.5 GB of state): ``launch.train.main`` for 8 steps
     of 4 x 512 tokens (losses near ln 50280, step ms split into forward +
     backward and optimizer, tokens/sec, peak memory); mamba2 and jamba
     smoke's f32 step on the card against the CPU; 0 flash launches;
 30. slice 18's encoder serve path on whisper-large-v3 at full width
     (``ENC_SERVE``: 32 decoder layers with cross-attention, a 32-layer
     encoder over 1500 frames, d 1280, 20 heads of 64, vocab 51866; 2.02
     B seeded bf16 parameters) through ``launch.make_prefill`` and
     ``make_decode_step`` (``ServeEngine`` refuses the stubs): one prefill
     of 4 x 64 tokens over 4 x 1500 seeded normal frames and 32 greedy
     steps (prefill ms, decode ms a step, tokens/sec, peak memory), row 4
     counted by site (32 encoder, 32 self, 32 cross launches, asserted;
     none in decode), a profile (``chiprun_out/profile_enc.txt``), row 4
     on the model's own q, k, v at the encoder and cross shapes against
     its plain version and timed beside its bound and SDPA, and the f32
     model at one layer on the card against the CPU (tokens equal, logits
     within 1e-3) and its decode against its forward;
 31. slice 18's vision-stub serve path on qwen2-vl-2b at full width
     (``VLM_SERVE``: 28 layers, d 1536, 12 heads of 128 over 2 kv heads,
     vocab 151936; 256 seeded normal patches before 4 x 512 tokens, the
     model's own M-RoPE positions): as 30, 28 launches a prefill, row 4
     held and timed at (4, 768, 12, 2, 128), profile in
     ``chiprun_out/profile_vlm.txt``;
 32.-33. slice 18's training paths (``ENC_TRAIN``, ``VLM_TRAIN``): both
     families at full width through ``launch.train.main`` (4 steps of 4 x
     448 tokens over zero frames; 4 x 512 tokens after zero patches; the
     reference driver's inputs, on which both packages' grad norms are
     NaN at this depth, asserted), a fixed batch with seeded normal stub
     inputs through ``make_train_step`` (every loss finite and near
     ln(vocab)), and the smoke family's f32 step on the card against the
     CPU; no flash launch (asserted);
 34. slice 19's cross-pod gradient exchange (``POD_TRAIN``): the driver
     with ``--pods 2 --edge-exchange`` on starcoder2-3b at full width cut
     to 12 of 30 layers (25 steps of 8 x 512 tokens, two pods of 4 x 512,
     budget 0.4, windows of 10: the step split into the pods' forward and
     backward, the exchange and AdamW, tokens/sec, peak memory, the sync
     fraction and all-reduced bytes per window, at least one replan, every
     loss finite); two exchanged smoke steps (full sync, then the
     controller's plan) on the card against the CPU, every skipped
     stream's gradient the step's momentum bitwise; the same steps on two
     gloo ranks sharing the card, one pod a rank, bitwise in parameters;
     no flash launch (asserted);
 35. the kernels line, then ``{"ok": true, "device": {...}}`` last.

Phase 12's sweep also runs the six fleet event goldens and the seven
single-edge event goldens (all twenty-one goldens), their counters held
also against the live reference's (``EVENT_REF``).

Detailed profiles go to ``chiprun_out/``.
"""
from __future__ import annotations

import contextlib
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
        "pool": 4, "T": 60, "T_plain": 20}
GOLDEN_REF_WAN_BYTES = 11080   # live JAX reference, fleet_scan, CPU
# slice 7: the live JAX reference's WAN bytes (CPU, jax 0.9): the
# single-edge goldens (cubic), and fleet_scan under the other families
SINGLE_REF_WAN_BYTES = {"single_scan": 4662, "single_scan_steps": 3544}
FAMILY_REF_WAN_BYTES = {"mean": 11540, "multi": 9436}
# one edge gateway: the turbine sensor suite at k = 8, windows of 4096
# tuples (the permutation sampler's two-round branch)
SINGLE = {"k": 8, "window": 4096, "pool": 4, "T": 50, "T_plain": 5}
# slice 8: the adaptive golden's live reference (CPU, jax 0.9), and the
# adaptive path: the main path's fleet, T generated windows (not cycled)
# whose four regions' correlation strengths reverse at window T // 2
ADAPTIVE_REF = {"wan_bytes": 21096, "planner_invocations": 6,
                "plans_reused": 6, "drift_fires": 7}
ADAPTIVE = {"n_regions": 4, "sites_per_region": 256, "k": 8, "window": 256,
            "T": 12, "n_prof": 3, "strength": [0.9, 0.65, 0.4, 0.15]}
# slice 9: the chaos goldens' live reference (CPU, jax 0.9), on its CPU
# path and, for the region golden, on its kernel path (Pallas in interpret
# mode, the fused fit), which the kernels' path is held to; the committed
# goldens say 10752 and 1052136 WAN bytes (ROADMAP.md queue 3, note b)
CHAOS_REF = {"fleet_scan_chaos_join": {"wan_bytes": 10732,
                                       "down_site_windows": 5,
                                       "gap_served_cells": 3},
             "fleet_scan_chaos_region": {"wan_bytes": 1053280,
                                         "down_site_windows": 320,
                                         "gap_served_cells": 320}}
CHAOS_REF_KERNEL_PATH = {"fleet_scan_chaos_region": {
    "wan_bytes": 1053064, "down_site_windows": 320, "gap_served_cells": 320}}
# the chaos path: the main path's fleet, 4 windows cycled to T; region 1
# dark for [30, 50), sites 0-31 joining at window 10, site 5 down for
# [60, 70) by two flaps, and random flaps; resumed from a checkpoint at
# window ``cut``, inside the outage
CHAOS = {"T": 80, "cut": 40,
         "spec": {"outages": [[30, 20, 1]],
                  "joins": [[10, s] for s in range(32)],
                  "flaps": [[60, 5, "down"], [70, 5, "up"]],
                  "flap_prob": 0.01, "flap_len": 3, "seed": 7}}
# slice 10: the four fleet event goldens' live reference (CPU, jax 0.9); the
# committed goldens differ (ROADMAP.md queue 3, note b)
EVENT_REF = {"fleet_event_batched_rebalance": {"wan_bytes": 10816,
                                               "gaps": 0},
             "fleet_event_cost_aware_wan": {"wan_bytes": 6916, "gaps": 5,
                                            "revisions": 18,
                                            "retransmits": 0},
             "fleet_event_adaptive_threshold": {"wan_bytes": 21264,
                                                "planner_invocations": 6},
             "fleet_event_chaos_flap": {"wan_bytes": 10412, "gaps": 3},
             "fleet_event_host_engine": {"wan_bytes": 4796, "gaps": 0},
             # slice 13: the two sharding goldens (one JAX device)
             "fleet_scan_sharded": {"wan_bytes": 11080, "gaps": 0},
             "fleet_event_sharded_static": {"wan_bytes": 3568, "gaps": 0},
             # slice 11: the five single-edge event goldens (the reference's
             # IPM run with the x64 workaround of the port's tests), and
             # slice 12's two
             **{name: dict(zip(("wan_bytes", "gaps", "revisions",
                                "late_drops", "duplicates", "retransmits"),
                               counters))
                for name, counters in (
                    ("single_event_cubic", (4662, 0, 0, 0, 0, 0)),
                    ("single_event_retransmit", (10878, 1, 0, 0, 0, 4)),
                    ("single_event_drop_gaps", (1554, 4, 0, 1, 0, 0)),
                    ("single_event_jitter_bandwidth", (2496, 0, 0, 0, 0, 0)),
                    ("single_event_latency_revise", (3736, 0, 4, 0, 0, 0)),
                    ("single_event_baseline_srs", (3894, 0, 0, 0, 0, 0)),
                    ("single_event_linear_alpha", (5372, 0, 0, 0, 0, 0)))}}
# slice 11: one edge gateway on the host planner (turbine, k = 8, N = 4096,
# T generated windows) with single_event_cubic's planner and
# single_event_retransmit's WAN; a fixed rule zeroes ~8% of the counts
SINGLE_EVENT = {"k": 8, "window": 4096, "T": 8, "seed": 21,
                "straggle_mod": 13}
# slice 12: the paper's comparison on one edge (benchmarks/fig5_smartcity.py:
# smartcity, windows of 256 tuples, seed 9; the planner's defaults, the
# f64 IPM) at one of its budgets over 12 of its 16 windows, model and mean
# imputation beside three baselines; the iid relaxations of
# benchmarks/fig9_iid.py (smartcity, windows of 256, seed 13, budget 0.3,
# m = 1) over 8 of its 12 windows; and the host
# engine: fleet_event_host_engine's planner and controller on
# benchmarks/fleet_bench.py's heterogeneous fleet (4 regions x 4 sites,
# k = 6, windows of 128 tuples) over T windows
BASELINE = {"data": {"dataset": "smartcity", "n_points": 3072,
                     "window": 256, "seed": 9, "options": {}},
            "budget_fraction": 0.26,
            "methods": ["model", "mean", "approx_iot", "s_voila", "srs"],
            "queries": ["AVG", "VAR", "MIN", "MAX"]}
IID = {"data": {"dataset": "smartcity", "n_points": 2048, "window": 256,
                "seed": 13, "options": {}},
       "budget_fraction": 0.3, "m_lags": 1,
       "modes": ["iid", "thinning", "m_dependence"]}
HOST_ENGINE = {"T": 2,
               "data": {"dataset": "fleet", "window": 128, "seed": 2,
                        "options": {"k": 6,
                                    "region_strength": [0.9, 0.7, 0.4, 0.15],
                                    "region_volatility": [0.4, 1.0, 1.8,
                                                          3.0]}},
               "topology": {"n_regions": 4, "sites_per_region": 4, "seed": 2,
                            "hetero_links": True, "latency_scale": 1.0}}
# slice 13: site sharding on the main path's fleet, planner and windows:
# T windows in this process, T_ranks on each of ``world`` gloo ranks
# sharing the card, T_event windows of the fleet event loop on the sharded
# engine; the ranks' run fails past ``timeout_s``
SHARDED = {"T": 10, "T_ranks": 4, "T_event": 2, "world": 2,
           "timeout_s": 420}
# the fleet event path: the main path's fleet, planner and windows on the
# WAN of fleet_event_cost_aware_wan (heterogeneous links, latency_scale 1,
# 30 ms jitter, 10% drops, a 100 ms period, link-cost-aware controller),
# with single_event_retransmit's retransmits.  The golden's 5 B/ms is
# scaled by the payload's size (k N is 8x the golden's), so that a payload
# takes as long to put on the wire (~60 ms of the period): at 5 B/ms a
# main-width payload takes ~490 ms, every retry timer fires before its
# first copy lands, and each window ships four copies, more than the raw
# tuples.  A fixed rule zeroes ~1% of the (site, stream) counts a window.
EVENT = {"T": 6, "T_parity": 4, "T_plain": 4, "n_prof": 3,
         "wan": {"latency_scale": 1.0, "jitter_ms": 30.0, "drop_prob": 0.1,
                 "bandwidth_bytes_per_ms": 40.0, "hetero_links": True},
         "transport": {"window_period_ms": 100.0,
                       "retransmit_timeout_ms": 150.0, "max_retries": 3},
         "straggle_mod": 97}
# slice 14: LM serving on gemma3-12b FULL (configs/gemma3_12b.py): the
# serve run's 8 requests (prompt lengths in [16, 1000], 32 new tokens, 4
# slots, max_seq 1100), the 4 x 512 prefill batch held against f32 and the
# layers whose q, k, v are checked and timed (0: local, 5: global), the
# ring check's prompt and decode steps, and its bounds
LM = {"arch": "gemma3-12b", "seed": 29, "slots": 4, "max_seq": 1100,
      "requests": 8, "prompt": (16, 1000), "new_tokens": 32,
      "batch": (4, 512), "layers": (0, 5), "ring_prompt": 1000,
      "ring_decode": 40, "kernel_over_plain": 1.25, "ring_tol": 1e-3,
      "f32_layer_ratio": 2.0}
# slice 15: LM training on starcoder2-3b FULL (configs/starcoder2_3b.py:
# 30 layers, d 3072, vocab 49152; f32 masters, m and v, bf16 activations):
# the driver's run of 8 steps of 4 x 512 tokens, the fixed-batch run at a
# constant lr, the four dense smoke families' f32 step on the card against
# the CPU on ``smoke_batch`` (the CPU tests' f32 limits, each gradient leaf
# within their 1e-3 of its largest |grad|; gemma3's within 2e-3: its f32
# gradients sit 1.66e-3 from its f64 step on the CPU alone, the backward of
# a sliding-window attention with nearly one-hot probabilities magnifying
# the f32 rounding, while its f64 step on the card equals the CPU's, see
# scripts/lm_grad_probe.py), and the driver's failed-and-resumed smoke run
# against the uninterrupted one
TRAIN = {"arch": "starcoder2-3b", "steps": 8, "batch": 4, "seq": 512,
         "fixed_lr": 1e-4, "fixed_steps": 8, "seed": 30,
         "smoke_archs": ("starcoder2-3b", "yi-9b", "chatglm3-6b",
                         "gemma3-12b"),
         "smoke_batch": (2, 24), "smoke_lr": 1e-3, "loss_rtol": 1e-5,
         "gnorm_rtol": 1e-3, "grad_limit": 1e-3, "grad_limit_gemma3": 2e-3,
         "resume": {"steps": 20, "every": 10, "fail": 15, "batch": 4,
                    "seq": 32}, "resume_rtol": 1e-5}
# slice 16: MoE serving on deepseek-moe-16b FULL (configs/deepseek_moe_16b.py:
# 28 layers, d 2048, 16 heads of 128, 64 routed experts top-6 and 2 shared,
# vocab 102400; 16.9 B seeded parameters, bf16): the serve run as ``LM``'s,
# the 4 x 512 prefill batch on both attention routes and row 4 on layer 0's
# q, k, v; and the MoE layer at full width in f32 on the first ``f32_layers``
# layers' own inputs of that batch, card against CPU: every token's routes
# equal but at a near tie (k-th and (k+1)-th probabilities within
# ``near_tie`` relative), and on the tokens whose routes and ranks agree the
# card's error against an f64 evaluation of the same routes at most
# ``f32_ratio`` times the CPU's, times the largest ratio the two devices'
# f32 products alone show on the layer's own products, where it passes 1
MOE_SERVE = {"arch": "deepseek-moe-16b", "seed": 31, "slots": 4,
             "max_seq": 1100, "requests": 8, "prompt": (16, 1000),
             "new_tokens": 32, "batch": (4, 512), "f32_layers": 2,
             "near_tie": 1e-6, "f32_ratio": 2.0, "n_decode_prof": 3}
# slice 16: MoE training on qwen3-moe-30b-a3b at full width (128 experts
# top-8, d 2048, 32 heads of 128, 4 kv heads, vocab 151936), cut to 4 of
# its 48 layers (3.1 B parameters, ~50 GB of masters, gradients, m and v;
# the whole model's 30.5 B do not train on one card): the driver's 8 steps
# of 4 x 512 tokens, losses within ``loss_band`` of ln(vocab); one step's
# gradients, the experts with an all-zero gradient being exactly those no
# token was routed to; and both MoE smoke families' f32 step on the card
# against the CPU, routes equal, at ``TRAIN``'s limits
MOE_TRAIN = {"arch": "qwen3-moe-30b-a3b", "n_layers": 4, "steps": 8,
             "batch": 4, "seq": 512, "seed": 31, "loss_band": 2.5,
             "smoke_archs": ("deepseek-moe-16b", "qwen3-moe-30b-a3b")}
# slice 17: Mamba2 serving on mamba2-780m FULL (configs/mamba2_780m.py: 48
# layers, d 1536, 48 SSD heads of 64, d_state 128, chunk 256, vocab 50280;
# 0.78 B seeded parameters, bf16): the serve run as ``LM``'s (its batches
# pad to lengths that are not multiples of 256, the one-chunk fallback);
# the Mamba mixers of the first ``f32_layers`` layers in f32 on their own
# inputs of the 4 x 512 batch (two chunks) and one decode step from the
# cache that prefill leaves, card against CPU, the card's error against an
# f64 evaluation at most ``f32_ratio`` times the CPU's, times the largest
# ratio the two devices' f32 products alone show on the layer's own
# products where it passes 1; at full depth in f32, the 4 x 512 batch in
# chunks of 256 against one chunk of 512 and ``decode`` teacher-forced
# steps after a ``prompt``-token prefill against the forward (the
# reference's cache test, rtol and atol 1e-3); and jamba smoke's serve
# run (the example's six requests) in f32 card against CPU, tokens equal,
# and in bf16, one row-4 launch a prefill
SSM_SERVE = {"arch": "mamba2-780m", "seed": 32, "slots": 4, "max_seq": 1100,
             "requests": 8, "prompt": (16, 1000), "new_tokens": 32,
             "batch": (4, 512), "f32_layers": 2, "f32_ratio": 2.0,
             "prompt_decode": 500, "decode": 12, "rtol": 1e-3, "atol": 1e-3,
             "n_decode_prof": 3, "hybrid": "jamba-1-5-large-398b",
             "hybrid_new_tokens": 12}
# slice 17: Mamba2 training on mamba2-780m FULL (0.78 B parameters, ~12.5 GB
# of masters, gradients, m and v): the driver's 8 steps of 4 x 512 tokens
# (two chunks a sequence), losses within ``loss_band`` of ln(vocab); both
# Mamba smoke families' f32 step on the card against the CPU at ``TRAIN``'s
# limits
SSM_TRAIN = {"arch": "mamba2-780m", "steps": 8, "batch": 4, "seq": 512,
             "seed": 32, "loss_band": 2.5,
             "smoke_archs": ("mamba2-780m", "jamba-1-5-large-398b")}
# slice 18: the modality stubs at full width, served through
# ``launch.make_prefill`` and ``make_decode_step`` (``ServeEngine`` passes
# tokens only and refuses them, as the reference's fails on them): seeded
# bf16 weights, ``batch`` rows of ``prompt`` seeded tokens with the stub's
# seeded normal inputs (whisper-large-v3: 1500 frames of d 1280 a row;
# qwen2-vl-2b: 256 patches of d 1536 before the tokens, the model's own
# M-RoPE positions), then ``new_tokens`` greedy decode steps; row 4 held
# against its plain version and timed on the model's own q, k, v at the
# prefill calls ``row4_calls`` names (one call at each of the path's
# sites: whisper's first encoder layer, its first decoder layer's
# self-attention, causal, and cross-attention); and the f32 model cut to
# ``f32_layers`` layer (whisper's encoder too), ``f32_batch`` rows of
# ``f32_prompt`` tokens and ``f32_decode`` greedy steps, on the card (the
# flash kernels) against the CPU (plain), tokens equal and logits within
# ``rtol`` and ``atol``, and the card's decode against its full forward at
# those positions (the reference's cache test).  One layer: at these random
# weights whisper's logits at 2 layers move by 3.2e-2 (0.7% of the largest)
# when the frames move by one f32 step, at 1 layer by 1.6e-4, so two f32
# orders can be held to 1e-3 at one layer only (measured on the CPU at
# these seeds; the phase prints the same yardstick)
ENC_SERVE = {"arch": "whisper-large-v3", "seed": 33, "batch": 4,
             "prompt": 64, "new_tokens": 32, "max_seq": 128,
             "row4_calls": {"whisper_encoder": 0, "whisper_self": 32,
                            "whisper_cross": 33},
             "f32_layers": 1, "f32_batch": 2, "f32_prompt": 16,
             "f32_decode": 8, "rtol": 1e-3, "atol": 1e-3,
             "out": "profile_enc.txt"}
VLM_SERVE = {"arch": "qwen2-vl-2b", "seed": 33, "batch": 4, "prompt": 512,
             "new_tokens": 32, "max_seq": 832,
             "row4_calls": {"qwen2_vl_prefill": 0},
             "f32_layers": 1, "f32_batch": 2, "f32_prompt": 16,
             "f32_decode": 8, "rtol": 1e-3, "atol": 1e-3,
             "out": "profile_vlm.txt"}
# slice 18: training the stubs at full width through ``launch.train.main``
# (whisper-large-v3 2.0 B parameters, ~32 GB of state, at the decoder's
# 448-token context against 1500 zero frames a row, the driver's extras as
# in the reference; qwen2-vl-2b 1.8 B, ~29 GB, 512 tokens after 256 zero
# patches): the first loss within ``loss_band`` of ln(vocab), and every
# grad norm NaN, as the reference's are at this depth on the zero inputs
# (ROADMAP queue 3, note o); then ``make_train_step`` at full width on one
# fixed batch with seeded normal stub inputs at a constant lr of
# ``fixed_lr`` for ``fixed_steps`` steps (the first step's update
# recomputed on a sample of every leaf from its gradient, within 2 f32
# steps of the parameter; every loss and grad norm finite,
# every loss, and the loss after the last step, within ``loss_band`` of
# ln(vocab): at random init these models' gradients grow several-fold a
# layer towards the input, so a fixed-batch loss need not fall in a few
# sign-like Adam steps); and the smoke family's f32 step on the card against the CPU
# on seeded normal stub inputs, at ``TRAIN``'s limits
ENC_TRAIN = {"arch": "whisper-large-v3", "steps": 4, "batch": 4, "seq": 448,
             "seed": 33, "loss_band": 2.5, "fixed_lr": 1e-4,
             "fixed_steps": 4}
VLM_TRAIN = {"arch": "qwen2-vl-2b", "steps": 4, "batch": 4, "seq": 512,
             "seed": 33, "loss_band": 2.5, "fixed_lr": 1e-4,
             "fixed_steps": 4}
# slice 19: the paper's cross-pod gradient exchange.  (a) The driver with
# ``--pods 2 --edge-exchange`` on starcoder2-3b at full width (d 3072)
# cut to 12 of 30 layers (1.91 B parameters; with two pods' f32
# gradients and the exchanged tree ~24 bytes a parameter, the whole
# model's 4.31 B would not fit), the reference test's exchange settings
# (budget 0.4, a window of 10) for 25 steps of 8 x 512 tokens, each pod
# taking 4 x 512 as the single-card train path does: at least one replan,
# every loss finite.  (b) One exchanged step of starcoder2 smoke in f32
# (``smoke_batch`` rows, two pods) on the card against the CPU from full
# sync, then, after the controller's replan at ``smoke_budget``, a second
# step: the loss, grad norm, telemetry (2 x the grad norm's limit: squared
# norms) and every exchanged gradient leaf within ``TRAIN``'s limits, and
# every skipped stream's gradient the step's momentum bitwise.  (c) The
# same two steps on two gloo ranks sharing the card, each rank one pod on
# its half of the batch (``make_grad_exchange``, ``n_pods=1``), bitwise
# this process's stacked steps in parameters.
POD_TRAIN = {"arch": "starcoder2-3b", "n_layers": 12, "pods": 2,
             "dcn_budget": 0.4, "window": 10, "steps": 25, "batch": 8,
             "seq": 512, "lr": 8e-3, "seed": 34, "smoke_batch": (4, 24),
             "smoke_budget": 0.4, "timeout_s": 240}
# slice 20: LM sharding's mesh half on two ranks, spawned once for the
# phase: on two cards over NCCL where the machine has two, else both on the
# one card over gloo (every collective of a CUDA tensor staged through
# host memory).  (a) starcoder2-3b at full width cut to 12 of its 30 layers
# (the exchange phase's cut), model = 2: ``steps`` f32 steps of 4 x 512
# tokens, timed, printed and finite.  The first step is held against the
# unsplit step taken on each rank from the same seeded state at full
# width cut to ``held_layers`` layers, in f64 (every f32 of the model read
# as f64):
# loss, grad norm and each gradient leaf within ``f64_limit`` of its
# largest magnitude (the CPU tests' limit: the same function); the same
# step in f32 is printed.  At this seeded init two summation orders part
# far from the rounding they start from: at 2 layers the split f64 step
# is 3.6e-11 of a leaf's largest from the unsplit one and the f32 step
# 1.6e-2; at 12 layers (first gradient norm 8.9e11) the f64 loss alone
# is 2.0e-6 off and the f32 loss 2.4e-4 (measured on an H100 80GB HBM3
# at 700 W), so no f32 limit holds at full width while the CPU tests' f64
# steps at smoke size agree to 1e-13.  (b)
# qwen3-moe-30b-a3b at full width cut to 2 of its 48 layers, bf16 forward
# copies (``cast_params_bf16``), data = 2: one step in G = 2 dispatch
# groups of 1024 tokens, each layer's routes against the one-process
# grouped dispatch on the same tokens (equal, or a near tie within
# ``near_tie`` relative).  (c) gemma3-12b FULL's bf16 prefill of 4 x 512
# under model = 2, row 4 on each rank's 8 of 16 heads and 4 of 8 KV heads
# (48 launches a rank), held against its plain version on layer
# ``prefill_layer``; the logits' distance from the f32 prefill at most
# ``LM["kernel_over_plain"]`` times the unsplit bf16 prefill's (f64 of the
# 12 B weights, 96 GB, does not fit the card)
MESH = {"train_arch": "starcoder2-3b", "train_layers": 12, "steps": 5,
        "batch": (4, 512), "lr": 1e-4, "seed": 35,
        "moe_arch": "qwen3-moe-30b-a3b", "moe_layers": 2,
        "prefill_arch": "gemma3-12b", "prefill_layer": 5, "near_tie": 1e-6,
        "held_layers": 2, "f64_limit": 1e-10, "world": 2, "timeout_s": 300,
        "smoke": False}
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
# shapes, and one window of 64 streams whose 67 MB do not fit in the 50 MB
# L2, where the bound and not the launch sets the least time (its input
# from a generator of its own, so that the other inputs stay as they
# were); the kernels line carries (64, 16384) f32.
LARGE_WINDOW = (64, 262144, "float32")
WINDOWS = [(8, 4096, "float32"), (32, 8192, "float32"),
           (64, 16384, "float32"), (64, 16384, "bfloat16"), LARGE_WINDOW]
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
              attempts: int = 3, pad: int = 16, fill=None,
              settle_s: float = 0.02) -> float:
    """Device time per call of the kernels whose names contain ``match``,
    from torch.profiler over ``reps`` calls (the CUDA-event time of a small
    kernel also counts its wrapper's host work), each call launching
    ``launches_per_call`` of them.  A profile drops the records of the
    kernels launched in its first moments (after ``profile_main_path``'s
    long CPU+CUDA profile, 3 of 16 and sometimes every one), so the calls
    sit between ``pad`` launches of a small fill kernel on each side
    (``fill``, by default a one-element ``add_``; its kernel's name must
    not contain ``match``) and start ``settle_s`` after the leading fills.
    The time is divided by the calls the profile recorded, not by
    ``reps``, and a profile without a record is taken again, up to
    ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    if fill is None:
        buf = torch.zeros(1, device="cuda")

        def fill():
            buf.add_(1.0)
    fn()
    fill()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(pad):
                fill()
            torch.cuda.synchronize()
            time.sleep(settle_s)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            for _ in range(pad):
                fill()
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


def launch_floor_ms(torch, reps: int = 20) -> float:
    """Device time of the smallest kernel: a one-element ``add_``, timed by
    ``device_ms`` between fills of a one-element ``mul_`` (whose kernel is
    named for ``MulFunctor``, the ``add_``'s for ``CUDAFunctorOnSelf_add``).
    A kernel's device time cannot go below it, whatever its bound."""
    one = torch.zeros(1, device="cuda")
    other = torch.ones(1, device="cuda")
    return device_ms(lambda: one.add_(1.0), torch, reps, "_add",
                     launches_per_call=1, fill=lambda: other.mul_(1.0))


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

    # stream_stats_fleet: power sums and Gram block bitwise the plain
    # version's (the same products in the same order); a short row also
    # with fused (S2..S4 as multiply-add chains, the plan's order below 33
    # tuples).  The large fleet's inputs are seeded torch.randn on the card.
    gen_l = torch.Generator(device=dev).manual_seed(16)
    El, kl, Nl = LARGE
    xl = torch.randn(El, kl, Nl, device=dev, generator=gen_l) * 1.5 + 2.0
    ss_cases = [("values", w0), ("ranks", ranks),
                ("ragged", randn(3, 5, 200, scale=1.5, shift=2.0)),
                ("ragged", randn(2, 9, 130, scale=3.0)),
                ("short", randn(5, 8, 20, scale=1.5, shift=2.0)),
                ("large", xl)]
    ss_err = 0.0
    for label, x in ss_cases:
        for fused in ((False, True) if label == "short" else (False,)):
            got = ss_ops.stream_stats_fleet_cuda(x, fused)
            torch.cuda.synchronize()
            err = check("stream_stats_fleet", got, fleet_stats_ref(x, fused),
                        [label + ("/fused" if fused else ""), *x.shape],
                        (True, True), 0.0, 0.0)
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

    # ---- 9.-11. slice 7: single edges and the mean and multi families --
    single_edge_phases(torch, dev)

    # ---- 12.-13. slice 8: the golden sweep and the adaptive path ---------
    golden_sweep_phase(torch)
    adaptive = adaptive_path(torch)

    # ---- 14.-15. slice 9: chaos at full width, and its resume ------------
    chaos = chaos_phases(torch, windows, main_scenario(
        k, N, MAIN["n_regions"], MAIN["sites_per_region"],
        MAIN["pool"] * N))

    # ---- 16.-18. slice 10: the fleet event path ---------------------------
    event = event_phases(torch, windows, main_scenario(
        k, N, MAIN["n_regions"], MAIN["sites_per_region"],
        MAIN["pool"] * N), card_line)

    # ---- 19. slice 11: the single-edge event path on the host planner -----
    single_event = single_event_path(torch, card_line)

    # ---- 20.-22. slice 12: baselines, the iid relaxations, the host engine
    baseline = baseline_path(torch, card_line)
    iid = iid_path(torch, card_line)
    host_engine = host_engine_path(torch, card_line)

    # ---- 23. slice 13: site sharding --------------------------------------
    sharded = sharded_path(torch, windows, main_scenario(
        k, N, MAIN["n_regions"], MAIN["sites_per_region"],
        MAIN["pool"] * N), card_line)

    # ---- 24. slice 14: LM serving at full width ---------------------------
    lm = lm_serve_path(torch, results, card_line)

    # ---- 25. slice 15: LM training at full width --------------------------
    train = lm_train_path(torch, card_line)

    # ---- 26.-27. slice 16: MoE serving and training at full width --------
    moe_serve = lm_moe_serve_path(torch, card_line)
    moe_train = lm_moe_train_path(torch, card_line)

    # ---- 28.-29. slice 17: Mamba2 serving and training at full width -----
    ssm_serve = lm_ssm_serve_path(torch, card_line)
    ssm_train = lm_ssm_train_path(torch, card_line)

    # ---- 30.-33. slice 18: the encoder and the vision stub at full width --
    stub_paths = {}
    for settings, phase in ((ENC_SERVE, "lm_enc_serve_path"),
                            (VLM_SERVE, "lm_vlm_serve_path")):
        for n, by in stub_serve_path(torch, settings, phase, results,
                                     card_line).items():
            stub_paths.setdefault(n, {}).update(by)
    for settings, phase in ((ENC_TRAIN, "lm_enc_train_path"),
                            (VLM_TRAIN, "lm_vlm_train_path")):
        for n, count in stub_train_path(torch, settings, phase,
                                        card_line).items():
            stub_paths.setdefault(n, {})[phase] = count

    # ---- 34. slice 19: the cross-pod gradient exchange --------------------
    pod_train = lm_pod_train_path(torch, card_line)

    # ---- 35. slice 20: LM sharding's mesh half on two ranks ----------------
    mesh_path = lm_mesh_path(torch, card_line)

    # ---- 36. the kernels line and the result -----------------------------
    # launches: rows 1 and 2 on the runtime paths driven with the counts
    # at 0 (main_path, adaptive_path, chaos_path, event_path, and
    # single_event_path, baseline_path, iid_path and host_engine_path,
    # which launch neither; sharded_path in this process and
    # sharded_path_ranks summed over its two ranks), row 3 on the kernel
    # entry points, row 4 there and in the LM serve runs, dense, MoE and
    # the Mamba hybrid's (and 0 times in the LM training runs, the
    # exchanged one included, asserted: it has no backward), and in the
    # stubs' serve runs (whisper's encoder, cross-attention and decoder
    # self-attention apart; qwen2-vl's prefill)
    by_path = {n: ({"main_path": launches[n], "adaptive_path": adaptive[n],
                    "chaos_path": chaos[n], "event_path": event[n],
                    "single_event_path": single_event[n],
                    "baseline_path": baseline[n], "iid_path": iid[n],
                    "host_engine_path": host_engine[n],
                    "sharded_path": sharded["in_process"][n],
                    "sharded_path_ranks": sharded["ranks"][n]}
                   if n in adaptive else {"kernel_entry_points": launches[n],
                                          **({"lm_serve_path": lm[n],
                                              "lm_train_path": train[n],
                                              "lm_moe_serve_path":
                                                  moe_serve[n],
                                              "lm_moe_train_path":
                                                  moe_train[n],
                                              "lm_ssm_serve_path":
                                                  ssm_serve[n],
                                              "lm_ssm_train_path":
                                                  ssm_train[n],
                                              **stub_paths[n],
                                              "lm_pod_train_path":
                                                  pod_train[n],
                                              "lm_mesh_path_ranks":
                                                  mesh_path[n]}
                                             if n in lm else {})})
               for n in KERNELS}
    emit({"kernels": [dict(name=n, route="cuda", source=KERNELS[n][0],
                           replaces=KERNELS[n][1],
                           launches=sum(by_path[n].values()),
                           launches_by_path=by_path[n], **results[n])
                      for n in KERNELS]})
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
    gen_large = torch.Generator(device=dev).manual_seed(20)
    xs = [torch.randn(k, n, device=dev, generator=gen_large
                      if (k, n, dt) == LARGE_WINDOW else gen)
          .to(getattr(torch, dt)) for k, n, dt in WINDOWS]
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
    emit({"phase": "kernel_build", "kernel": "stream_stats",
          **build_facts("stream_stats")})
    floor = launch_floor_ms(torch)
    for i, ((k, n, dt), x) in enumerate(zip(WINDOWS, xs)):
        ms = time_cuda(lambda: ss_ops.stream_stats_cuda(x), torch, 50)
        # one kernel a call: stream_stats_window
        dev_ms = device_ms(lambda: ss_ops.stream_stats_cuda(x), torch, 20,
                           "stream_stats_window", launches_per_call=1)
        plain = time_cuda(lambda: stream_stats_ref(x), torch, 50)
        nbytes = x.numel() * x.element_size() + (4 * k + k * k) * 4
        flops = k * (k + 1) * n + 7 * k * n   # the upper triangle suffices
        b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS
                              if dt == "bfloat16" else PEAK_F32_FLOPS)
        emit({"phase": "kernel_time", "kernel": "stream_stats",
              "shape": [k, n], "dtype": dt, "kernel_ms": ms,
              "kernel_device_ms": dev_ms, "launches_per_call": 1,
              "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
              "share_of_bound": b_ms / dev_ms, "launch_floor_ms": floor,
              "bytes": nbytes, "flops": flops, "library_ms": None,
              "library_note": "none: x @ x.T gives only the Gram part"})
        if i == WINDOW_TIMED:
            results["stream_stats"] = {
                "max_abs_err": ss_err, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None}

    sm90 = build_facts("flash_attention")
    emit({"phase": "kernel_build", "kernel": "flash_attention", **sm90})
    f32 = build_facts("flash_attention_f32")
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


def _rms(x) -> float:
    return float(x.float().square().mean().sqrt())


def serve_run(torch, cfg, settings: dict, rng, batch: dict, line: dict,
              spy=contextlib.nullcontext, more=lambda fields: {}):
    """``ServeEngine`` for ``cfg`` on the card (weights drawn from
    ``settings["seed"]``), warmed by a 16-token prefill of ``batch``, then
    ``settings["requests"]`` requests of ``settings["prompt"]`` tokens
    drawn from ``rng``, ``settings["new_tokens"]`` new tokens each, run
    inside ``spy()`` with the flash kernels' counts at 0.  Emits ``line``
    with the run's fields and ``more(fields)``, then raises unless every
    request got its tokens and every logit was finite.  Returns (the
    engine, the fields: times, tokens/s, peak memory, the flash launches
    of the run)."""
    import numpy as np
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.serving import Request, ServeEngine

    t0 = time.perf_counter()
    engine = ServeEngine(None, cfg, batch_slots=settings["slots"],
                         max_seq=settings["max_seq"], device="cuda",
                         seed=settings["seed"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model = engine.model
    model.prefill({"tokens": batch["tokens"][:, :16]},
                  batch["tokens"].shape[1])                 # warm
    timed = {"prefill": [], "decode": []}
    finite, prefill_len = [], []

    def timer(name, fn):
        def run(*args):
            if name == "prefill":
                prefill_len.append(int(np.shape(args[0]["tokens"])[1]))
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            timed[name].append(time.perf_counter() - t)
            finite.append(bool(torch.isfinite(out[0]).all()))
            return out
        return run
    model.prefill = timer("prefill", model.prefill)
    model.decode_step = timer("decode", model.decode_step)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(n))
                    .tolist(), max_new_tokens=settings["new_tokens"])
            for i, n in enumerate(rng.integers(settings["prompt"][0],
                                               settings["prompt"][1] + 1,
                                               settings["requests"]))]
    for r in reqs:
        engine.submit(r)
    fa_ops.LAUNCHES = 0
    fa_ops.SM90_LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    with spy():
        t0 = time.perf_counter()
        done = engine.run()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
    launches = {"flash_attention": fa_ops.SM90_LAUNCHES,
                "flash_attention_f32": fa_ops.LAUNCHES - fa_ops.SM90_LAUNCHES}
    del model.prefill, model.decode_step
    n_tok = sum(len(r.generated) for r in done)
    fields = {"params": model.n_params(), "slots": settings["slots"],
              "max_seq": settings["max_seq"], "requests": len(reqs),
              "prompt_lengths": [len(r.prompt) for r in reqs],
              "prefill_lengths": prefill_len, "tokens": n_tok,
              "seconds": serve_s, "tokens_per_sec": n_tok / serve_s,
              "prefill_calls": len(timed["prefill"]),
              "prefill_ms_per_batch": [1e3 * t for t in timed["prefill"]],
              "decode_steps": len(timed["decode"]),
              "decode_ms_per_step": 1e3 * statistics.median(timed["decode"]),
              "decode_ms_mean": 1e3 * statistics.mean(timed["decode"]),
              "peak_mem_bytes": torch.cuda.max_memory_allocated(),
              "init_seconds": init_s, "launches": launches}
    emit({**line, **fields, **more(fields)})
    if sorted(r.rid for r in done) != list(range(len(reqs))) or any(
            len(r.generated) != settings["new_tokens"] for r in done):
        raise AssertionError(f"{line['phase']}: the serve run did not give "
                             f"every request {settings['new_tokens']} "
                             f"tokens")
    if not all(finite):
        raise AssertionError(f"{line['phase']}: the serve run produced "
                             f"non-finite logits")
    return engine, fields


def lm_serve_path(torch, results, card_line: str) -> dict:
    """Phase 24: gemma3-12b at full width through ``ServeEngine`` and the
    model's prefill and decode (``LM``).  Every check raises.  Updates
    row 4's entry of ``results`` with its time at the prefill shape and
    returns the flash kernels' launches in the serve run."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import (attention_f64,
                                                         flash_attention_ref)
    from repro_torch.models import Transformer, init_cache
    from repro_torch.models import layers as lm_layers

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg16 = get_config(LM["arch"])
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    rng = np.random.default_rng(LM["seed"])
    bsz, blen = LM["batch"]
    batch = {"tokens": rng.integers(0, cfg16.vocab, (bsz, blen))}
    ring_toks = rng.integers(0, cfg16.vocab,
                             (1, LM["ring_prompt"] + LM["ring_decode"]))

    def prefill_logits(model, use_kernel, tokens=batch, max_seq=blen):
        model.use_kernel = use_kernel
        logits, cache = model.prefill(tokens, max_seq)
        torch.cuda.synchronize()
        return logits[:, -1].float().cpu(), cache

    # ---- f32 at full depth: the yardstick, and the f32 kernel on every
    # layer's own q, k, v
    t0 = time.perf_counter()
    model = Transformer(cfg32, device="cuda", seed=LM["seed"])
    torch.cuda.synchronize()
    init32_s = time.perf_counter() - t0
    l32, _ = prefill_logits(model, False)
    layer_err = []

    def f32_check(i, q, k, v, kw, out):
        # against the same attention in f64: the kernel's error and the
        # plain version's f32 error (each score sums 240 products of ~260,
        # so two f32 orders differ by ~1e-4 in a score at these weights)
        exact = attention_f64(q, k, v, **kw)
        plain = flash_attention_ref(q, k, v, **kw)
        layer_err.append((float((out - exact).abs().max()),
                          float((plain - exact).abs().max()),
                          float(exact.abs().max())))
    with _attention_spy(lm_layers, f32_check):
        l32k, _ = prefill_logits(model, True)
    worst = max(e[0] / e[1] if e[1] else (float("inf") if e[0] else 0.0)
                for e in layer_err)
    emit({"phase": "lm_f32_layers", "nvidia_smi": card_line,
          "params": model.n_params(), "param_count": cfg32.param_count(),
          "init_seconds": init32_s, "batch": [bsz, blen],
          "layers_checked": len(layer_err),
          "kernel_err_vs_f64": max(e[0] for e in layer_err),
          "plain_err_vs_f64": max(e[1] for e in layer_err),
          "max_abs_want": max(e[2] for e in layer_err),
          "worst_kernel_over_plain": worst,
          "limit": LM["f32_layer_ratio"],
          "logits_rms_kernel_minus_plain_over_rms": _rms(l32k - l32)
          / _rms(l32)})
    if len(layer_err) != cfg32.n_layers or \
            not worst <= LM["f32_layer_ratio"]:
        raise AssertionError(f"f32 flash kernel against f64 on the layers' "
                             f"own q, k, v, beside the plain version: "
                             f"{layer_err}")

    # the rings at full width, layer by layer: layers 0 (local, a
    # 1032-slot ring that wraps during decode) and 5 (global) take the
    # embedded ring tokens, prefill 1000 positions into a cache and decode
    # 40 teacher-forced ones, each step against the same layer over all
    # 1040 positions (the prefill route, on the kernel)
    p = LM["ring_prompt"]
    n = ring_toks.shape[1]
    x = model.embed[torch.as_tensor(ring_toks, device=model.device)]
    pos = torch.arange(n, dtype=torch.int32, device=model.device)[None]
    ring_rows = []
    for layer in LM["layers"]:
        blk = model.layers[layer]
        h = lm_layers.rmsnorm(blk.norm1, x, cfg32.norm_eps)
        full, _ = lm_layers.attention_apply(blk.mixer, h, pos, cfg32,
                                            window=blk.window)
        ring = init_cache(cfg32, 1, LM["max_seq"],
                          device=model.device)["layers"][layer]
        lm_layers.attention_apply(blk.mixer, h[:, :p], pos[:, :p], cfg32,
                                  window=blk.window, cache=ring)
        err = 0.0
        for t in range(p, n):
            ring["write_idx"] = t % ring["k"].shape[1]
            out, _ = lm_layers.attention_apply(
                blk.mixer, h[:, t:t + 1], pos[:, t:t + 1], cfg32,
                window=blk.window, cache=ring)
            err = max(err, float((out[:, 0] - full[:, t]).abs().max()))
        scale = float(full[:, p:].abs().max())
        ring_rows.append({"layer": layer, "window": blk.window,
                          "ring": ring["k"].shape[1], "max_abs_err": err,
                          "max_abs_want": scale})
    ring_ok = all(r["max_abs_err"] <= LM["ring_tol"] * r["max_abs_want"]
                  for r in ring_rows)
    emit({"phase": "lm_ring_layers", "nvidia_smi": card_line,
          "prompt": p, "decode": n - p, "layers": ring_rows,
          "tol_over_max_want": LM["ring_tol"], "ok": ring_ok})
    if not ring_ok:
        raise AssertionError(f"ring decode against the full attention: "
                             f"{ring_rows}")
    del model, x, h, full, ring
    torch.cuda.empty_cache()

    # ---- end to end in f32 at one period (5 local layers and a global
    # one, the depth of the reference's own ring test): printed, not held.
    # These random weights give scores of ~260 RMS, so one layer's f32
    # attention is off by up to 2e-4 of its largest output (the plain
    # version against f64 above), and a near tie that goes the other way
    # changes which value a row takes; the change spreads through the
    # later layers, and at 48 layers the two routes are as far apart as
    # unrelated logits
    cfg_p = dataclasses.replace(cfg32, n_layers=cfg32.period)
    model = Transformer(cfg_p, device="cuda", seed=LM["seed"])
    l32p, _ = prefill_logits(model, False)
    l32pk, _ = prefill_logits(model, True)
    _, cache = prefill_logits(model, True, {"tokens": ring_toks[:, :p]},
                              LM["max_seq"])
    for t in range(p, ring_toks.shape[1]):
        dec, cache = model.decode_step(cache, ring_toks[:, t:t + 1])
    full, _ = prefill_logits(model, True, {"tokens": ring_toks},
                             LM["max_seq"])
    dec = dec[:, -1].float().cpu()
    emit({"phase": "lm_f32_end_to_end", "nvidia_smi": card_line,
          "layers": cfg_p.n_layers, "batch": [bsz, blen],
          "rms_kernel_minus_plain_over_rms": _rms(l32pk - l32p) / _rms(l32p),
          "ring_prompt": p, "ring_decode": LM["ring_decode"],
          "ring_max_abs_diff": float((dec - full).abs().max()),
          "ring_max_abs_logit": float(full.abs().max())})
    del model, cache, dec, full
    torch.cuda.empty_cache()

    # ---- bf16: the serve run -----------------------------------------------
    engine, run = serve_run(
        torch, cfg16, LM, rng, batch,
        {"phase": "lm_serve_path", "nvidia_smi": card_line,
         "arch": cfg16.name, "dtype": cfg16.dtype, "layers": cfg16.n_layers,
         "d_model": cfg16.d_model, "head_dim": cfg16.head_dim,
         "vocab": cfg16.vocab})
    model = engine.model
    launches, n_pre = run["launches"], run["prefill_calls"]
    if launches != {"flash_attention": cfg16.n_layers * n_pre,
                    "flash_attention_f32": 0}:
        raise AssertionError(f"flash kernel launches in the serve run "
                             f"{launches}, want {cfg16.n_layers} a prefill "
                             f"({n_pre}), all on the tensor-core kernel")

    profile_lm(model, batch, LM["max_seq"], torch, card_line)

    # ---- bf16 kernel and plain routes against f32; layers 0 and 5 --------
    captured = {}

    def capture(i, q, k, v, kw, out):
        if i in LM["layers"]:
            captured[i] = (q, k, v, kw)
    with _attention_spy(lm_layers, capture):
        lk, _ = prefill_logits(model, True)
    lp, _ = prefill_logits(model, False)
    model.use_kernel = True
    dk, dp = _rms(lk - l32), _rms(lp - l32)
    emit({"phase": "lm_kernel_vs_plain", "nvidia_smi": card_line,
          "layers": cfg16.n_layers, "batch": [bsz, blen],
          "rms_kernel_minus_f32": dk, "rms_plain_minus_f32": dp,
          "rms_f32": _rms(l32), "ratio": dk / dp,
          "limit": LM["kernel_over_plain"],
          "argmax_agree_kernel_plain": float(
              (lk.argmax(-1) == lp.argmax(-1)).float().mean())})
    if not dk <= LM["kernel_over_plain"] * dp:
        raise AssertionError(f"bf16 kernel route is {dk / dp} times the plain "
                             f"route's distance from f32")
    fa_err = results["flash_attention"]["max_abs_err"]
    lib_line = {}
    for layer in LM["layers"]:
        q, k, v, kw = captured[layer]
        err, lib_line = row4_check_and_time(torch, q, k, v, kw,
                                            f"lm_layer_{layer}", card_line)
        fa_err = max(fa_err, err)
    # the kernels line carries the main path's shape: the global layer
    results["flash_attention"] = {"max_abs_err": fa_err, **lib_line}
    del engine, model, captured
    torch.cuda.empty_cache()

    # ---- bf16 at one period against its f32 (printed, not held: the
    # kernel reads q and k rounded to bf16, the plain route keeps them in
    # f32 after RoPE as the reference does)
    model = Transformer(dataclasses.replace(cfg_p, dtype="bfloat16"),
                        device="cuda", seed=LM["seed"])
    lk, _ = prefill_logits(model, True)
    lp, _ = prefill_logits(model, False)
    emit({"phase": "lm_kernel_vs_plain_one_period", "nvidia_smi": card_line,
          "layers": cfg_p.n_layers, "batch": [bsz, blen],
          "rms_kernel_minus_f32": _rms(lk - l32p),
          "rms_plain_minus_f32": _rms(lp - l32p), "rms_f32": _rms(l32p),
          "ratio": _rms(lk - l32p) / _rms(lp - l32p)})
    emit({"phase": "lm_serve_path_seconds",
          "seconds": time.perf_counter() - t_phase})
    del model
    torch.cuda.empty_cache()
    return launches


def row4_check_and_time(torch, q, k, v, kw, case: str, card_line: str):
    """Row 4's bf16 kernel on one prefill layer's own q, k, v: held against
    its plain version (row 4's RMS bound; element-wise, kernel and plain
    version each against f64, the kernel at most ``f32_layer_ratio`` times
    as far off), then timed at that shape beside its bound, the plain
    version and SDPA.  Returns (max |err|, the kernels line's times)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (attention_f64,
                                                         flash_attention_ref)
    tol = ATTENTION_TOL["bfloat16"]
    out = fa_ops.flash_attention_cuda(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    d = (out.float() - want.float()).abs()
    w = want.float().abs()
    err = float(d.max())
    scaled = float((d / (tol["atol"] + tol["rtol"] * w)).max())
    rms = float(d.square().mean().sqrt() / w.square().mean().sqrt())
    # row 4's element-wise bound assumes O(1) scores; at these weights
    # (scores of ~260 RMS) a row whose top two scores nearly tie mixes
    # two value rows by a share that either f32 score order moves, so
    # the element-wise gate is the same one as in f32: each version
    # against the attention in f64, the kernel at most
    # ``f32_layer_ratio`` times as far off as the plain version (which
    # also rounds its output to bf16), beside row 4's RMS bound
    exact = attention_f64(q, k, v, **kw)
    err_k = float((out.double() - exact).abs().max())
    err_p = float((want.double() - exact).abs().max())
    ok = (err_k <= LM["f32_layer_ratio"] * err_p and rms <= tol["rms"]
          and bool(torch.isfinite(out).all()))
    emit({"phase": "kernel_check", "kernel": "flash_attention",
          "case": case, "shape": list(q.shape),
          "kv_shape": list(k.shape), **kw, "max_abs_err": err,
          "err_over_tol": scaled, "rms_err_over_rms_want": rms, **tol,
          "kernel_err_vs_f64": err_k, "plain_err_vs_f64": err_p,
          "max_abs_want": float(w.max()),
          "limit_kernel_over_plain": LM["f32_layer_ratio"], "ok": ok})
    if not ok:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version on {case}'s q, k, v: max "
                             f"|err| {err} (against f64: kernel {err_k},"
                             f" plain {err_p}), RMS {rms}")

    # ---- row 4 timed at the prefill shape -------------------------------
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    window, causal = kw["window"], kw["causal"]
    ms = time_cuda(lambda: fa_ops.flash_attention_cuda(q, k, v, **kw),
                   torch, 20, 5)
    dev_ms = device_ms(lambda: fa_ops.flash_attention_cuda(q, k, v, **kw),
                       torch, 20, "flash_fwd", launches_per_call=1)
    plain = time_cuda(lambda: flash_attention_ref(q, k, v, **kw), torch,
                      10, 2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if window > 0 and window < S:
        qp = torch.arange(S, device=q.device)[:, None]
        kp = torch.arange(S, device=q.device)[None, :]
        mask = (qp - kp < window) & (kp <= qp)

    def sdpa():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=H != KV)
    lib = time_cuda(sdpa, torch, 20, 5)
    lib_diff = float((sdpa().transpose(1, 2).float() - out.float())
                     .abs().max())
    nbytes = 2 * q.numel() * q.element_size() \
        + 2 * k.numel() * k.element_size()
    flops = 4 * B * H * hd * live_pairs(S, T, causal, window)
    b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
    emit({"phase": "kernel_time", "kernel": "flash_attention",
          "case": f"prefill_{case}", "nvidia_smi": card_line,
          "shape": [B, S, T, H, KV, hd], "causal": causal,
          "window": window, "dtype": "bfloat16", "kernel_ms": ms,
          "kernel_device_ms": dev_ms, "plain_ms": plain,
          "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
          "flops": flops, "device_over_bound": dev_ms / b_ms,
          "library_ms": lib, "library": "scaled_dot_product_attention",
          "library_max_abs_diff": lib_diff})
    lib_line = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
    return err, lib_line


def _finite(xs) -> bool:
    import math
    return all(math.isfinite(x) for x in xs)


def lm_train_path(torch, card_line: str) -> dict:
    """Phase 25: training at full width and the training checks (``TRAIN``).
    Every check raises.  Returns the flash kernels' launches in the
    phase, asserted 0."""
    import gc
    import tempfile

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import MarkovTokenStream
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import make_train_step
    from repro_torch.launch import train as train_mod
    from repro_torch.models import forward_train, init_params
    from repro_torch.optim import adamw_init, tree_leaves

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    fa_ops.LAUNCHES = 0
    fa_ops.SM90_LAUNCHES = 0
    cfg = get_config(TRAIN["arch"])
    bsz, seq = TRAIN["batch"], TRAIN["seq"]

    # ---- (a) the driver at full width -------------------------------------
    stats = {}
    t0 = time.perf_counter()
    losses = train_mod.main(
        ["--arch", TRAIN["arch"], "--full", "--steps", str(TRAIN["steps"]),
         "--batch", str(bsz), "--seq", str(seq), "--log-every", "1",
         "--seed", str(TRAIN["seed"]), "--device", "cuda"], stats=stats)
    run_s = time.perf_counter() - t0
    emit({"phase": "lm_train_driver", "nvidia_smi": card_line,
          "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab, "params": stats["params"],
          "state_bytes": 16 * stats["params"], "batch": [bsz, seq],
          "tokens_per_step": stats["tokens_per_step"],
          "steps": stats["step"], "losses": stats["loss"],
          "grad_norms": stats["grad_norm"],
          "fwd_bwd_ms": stats["fwd_bwd_ms"], "opt_ms": stats["opt_ms"],
          "median_step_ms": stats["median_step_ms"],
          "median_fwd_bwd_ms": stats["median_fwd_bwd_ms"],
          "median_opt_ms": stats["median_opt_ms"],
          "tokens_per_sec": stats["tokens_per_sec"],
          "peak_mem_bytes": stats["peak_mem_bytes"], "seconds": run_s})
    if len(stats["loss"]) != TRAIN["steps"] or len(losses) != TRAIN["steps"] \
            or not _finite(stats["loss"] + stats["grad_norm"]
                           + stats["fwd_bwd_ms"] + stats["opt_ms"]):
        raise AssertionError(f"the driver's full-width run: {stats}")
    del stats
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) one fixed batch at a constant lr -----------------------------
    toks = MarkovTokenStream(cfg.vocab, TRAIN["seed"]).sample(
        np.random.default_rng(TRAIN["seed"]), bsz, seq)
    batch = {"tokens": torch.as_tensor(toks[:, :-1], device="cuda"),
             "labels": torch.as_tensor(toks[:, 1:], device="cuda")}
    gen = torch.Generator(device="cuda").manual_seed(TRAIN["seed"])
    state = adamw_init(init_params(cfg, gen, device="cuda"))
    step = make_train_step(cfg, lambda _: TRAIN["fixed_lr"])
    fixed, empty = [], []
    for i in range(TRAIN["fixed_steps"]):
        if i == 1:       # the second step under the profiler
            state, metrics = profile_train_step(step, state, batch, torch,
                                                card_line)
            fixed.append(float(metrics["loss"]))
            continue
        loss, metrics, grads = step.loss_and_grads(state, batch)
        if i == 0:
            leaves = tree_leaves(grads)
            ok = torch.stack([torch.isfinite(g).all() & (g.abs().amax() > 0)
                              for g in leaves]).cpu()
            empty = [j for j, o in enumerate(ok.tolist()) if not o]
            n_leaves = len(leaves)
            del leaves
        state, metrics = step.apply(state, grads, loss, metrics)
        del grads
        fixed.append(float(metrics["loss"]))
    # the loss after step 8 (its graph, which holds the masters, dropped)
    fixed.append(float(forward_train(state.params, batch, cfg)[0].detach()))
    del state, step, metrics
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "lm_train_fixed_batch", "nvidia_smi": card_line,
          "arch": cfg.name, "batch": [bsz, seq], "lr": TRAIN["fixed_lr"],
          "losses": fixed, "leaves": n_leaves,
          "leaves_without_finite_nonzero_grad": empty})
    if empty or not _finite(fixed) or not fixed[-1] < fixed[0]:
        raise AssertionError(f"fixed-batch run: losses {fixed}, leaves "
                             f"without a finite nonzero gradient {empty}")

    # ---- (c) the smoke families' f32 step, card against CPU ---------------
    smoke_card_vs_cpu(torch, TRAIN["smoke_archs"], card_line)

    # ---- (c) the driver failed and resumed, against the uninterrupted run
    rs = TRAIN["resume"]
    flags = ["--arch", TRAIN["arch"], "--steps", str(rs["steps"]),
             "--batch", str(rs["batch"]), "--seq", str(rs["seq"]),
             "--ckpt-every", str(rs["every"]), "--log-every", "10",
             "--device", "cuda"]
    whole, resumed = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        train_mod.main(flags + ["--ckpt-dir", os.path.join(tmp, "whole")],
                       stats=whole)
        ck = os.path.join(tmp, "ck")
        try:
            train_mod.main(flags + ["--ckpt-dir", ck, "--fail-at-step",
                                    str(rs["fail"])])
            raise AssertionError("--fail-at-step did not fail")
        except RuntimeError as exc:
            if "injected node failure" not in str(exc):
                raise
        train_mod.main(flags + ["--ckpt-dir", ck, "--restore"],
                       stats=resumed)
    start = (rs["fail"] // rs["every"]) * rs["every"]
    want = whole["loss"][start:]
    got = resumed["loss"]
    worst = max(abs(a - b) / abs(b) for a, b in zip(got, want)) \
        if len(got) == len(want) else float("inf")
    launches = {"flash_attention": fa_ops.SM90_LAUNCHES,
                "flash_attention_f32": fa_ops.LAUNCHES - fa_ops.SM90_LAUNCHES}
    emit({"phase": "lm_train_resume", "nvidia_smi": card_line,
          "arch": get_config(TRAIN["arch"], smoke=True).name,
          "steps": rs["steps"], "failed_at": rs["fail"],
          "restored_step": start, "resumed_steps": resumed["step"],
          "max_rel_loss_diff": worst, "limit": TRAIN["resume_rtol"],
          "bitwise": got == want, "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    if resumed["step"] != list(range(start + 1, rs["steps"] + 1)) or \
            not worst <= TRAIN["resume_rtol"]:
        raise AssertionError(f"the resumed run's losses {got} against the "
                             f"uninterrupted run's {want}")
    if launches != {"flash_attention": 0, "flash_attention_f32": 0}:
        raise AssertionError(f"flash kernel launches in the training phase "
                             f"{launches}: a training forward takes the "
                             f"plain attention")
    return launches


def smoke_card_vs_cpu(torch, archs, card_line: str,
                      phase: str = "lm_train_smoke_card_vs_cpu") -> None:
    """Each smoke family's f32 train step on the card against the same
    step on the CPU (the same f32 draw, ``TRAIN["smoke_batch"]``): an
    MoE's routes (every layer's top-k experts, forward and recomputation)
    equal, the loss, grad norm and parameters within the CPU tests'
    limits, each gradient leaf within ``grad_limit`` of its largest
    |grad| (gemma3: ``grad_limit_gemma3``, its f32 order's spread).
    Raises on any miss."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import make_train_step
    from repro_torch.launch.train import random_stub_inputs
    from repro_torch.models import init_params
    from repro_torch.models import layers as lm_layers
    from repro_torch.optim import adamw_init, cosine_schedule, tree_leaves, \
        tree_map
    sb, ss = TRAIN["smoke_batch"]
    dispatch = lm_layers.moe_dispatch
    rows = []
    for arch in archs:
        scfg = dataclasses.replace(get_config(arch, smoke=True),
                                   dtype="float32")
        rng = np.random.default_rng(1)
        sbatch = {"tokens": rng.integers(0, scfg.vocab, (sb, ss)),
                  "labels": rng.integers(0, scfg.vocab, (sb, ss))}
        sbatch["labels"][0, :5] = -1
        sbatch["labels"][1, -3:] = -1
        sbatch.update(random_stub_inputs(scfg, sb, rng))
        runs = {}
        for dev in ("cpu", "cuda"):
            routes = []

            def spy(topi, cap):
                routes.append(topi.cpu())
                return dispatch(topi, cap)
            params = init_params(scfg, torch.Generator().manual_seed(7))
            st = adamw_init(tree_map(lambda t: t.to(dev), params))
            sstep = make_train_step(scfg, cosine_schedule(TRAIN["smoke_lr"],
                                                          0, 10))
            lm_layers.moe_dispatch = spy
            try:
                loss, metrics, grads = sstep.loss_and_grads(st, sbatch)
            finally:
                lm_layers.moe_dispatch = dispatch
            g = [t.detach().cpu().clone() for t in tree_leaves(grads)]
            st, m = sstep.apply(st, grads, loss, metrics)
            runs[dev] = (float(m["loss"]), float(m["grad_norm"]), g,
                         [t.detach().cpu() for t in tree_leaves(st.params)],
                         routes)
        (l0, n0, g0, p0, r0), (l1, n1, g1, p1, r1) = runs["cpu"], runs["cuda"]
        limit = TRAIN["grad_limit_gemma3"] if arch == "gemma3-12b" \
            else TRAIN["grad_limit"]
        row = {"arch": arch, "loss_rel": abs(l1 - l0) / abs(l0),
               "grad_norm_rel": abs(n1 - n0) / n0,
               "grad_err_over_leaf_max": max(
                   float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(g1, g0)),
               "grad_limit": limit,
               "param_max_abs_diff": max(float((a - b).abs().max())
                                         for a, b in zip(p1, p0)),
               "moe_route_calls": len(r1),
               "routes_equal": len(r0) == len(r1) and all(
                   torch.equal(a, b) for a, b in zip(r0, r1))}
        row["ok"] = (row["loss_rel"] <= TRAIN["loss_rtol"]
                     and row["grad_norm_rel"] <= TRAIN["gnorm_rtol"]
                     and row["grad_err_over_leaf_max"] <= limit
                     and row["param_max_abs_diff"] <= 2 * TRAIN["smoke_lr"]
                     and row["routes_equal"])
        rows.append(row)
    emit({"phase": phase, "nvidia_smi": card_line,
          "batch": [sb, ss], "lr": TRAIN["smoke_lr"],
          "limits": {k: TRAIN[k] for k in ("loss_rtol", "gnorm_rtol",
                                           "grad_limit",
                                           "grad_limit_gemma3")},
          "rows": rows})
    if not all(r["ok"] for r in rows):
        raise AssertionError(f"smoke train steps, card against CPU: {rows}")


def _moe_routes_of(lm_layers, params, xt, m):
    """One MoE layer's routes for tokens ``xt`` (T, d): the sorted
    probabilities, the top-k experts, each (token, slot)'s clipped rank
    (cap = dropped), and the capacity."""
    import torch
    _, probs, _, topi = lm_layers.moe_router(params["router"], xt, m.top_k)
    cap = lm_layers.moe_capacity(xt.shape[0], m)
    sort_idx, _, rank_c = lm_layers.moe_dispatch(topi, cap)
    rank = torch.empty_like(rank_c)
    rank[sort_idx] = rank_c
    return (torch.sort(probs, dim=-1, descending=True).values, topi,
            rank.reshape(topi.shape), cap)


def _moe_f64(lm_layers, params, xt, topi, m):
    """The MoE layer's output (T, d) in f64 on the routes ``topi``: the
    router's f64 softmax read at ``topi``, the same capacity routes, the
    experts and the shared experts in f64."""
    import torch

    def f64(t):
        return ({n: f64(v) for n, v in t.items()} if isinstance(t, dict)
                else t.to(torch.float64))
    p = f64(dict(params))
    x = xt.to(torch.float64)
    probs = torch.softmax(x @ p["router"], dim=-1)
    topv = torch.gather(probs, 1, topi)
    topw = topv / torch.clamp(topv.sum(dim=-1, keepdim=True), min=1e-9)
    cap = lm_layers.moe_capacity(x.shape[0], m)
    out = lm_layers.moe_experts(p, x, topw, lm_layers.moe_dispatch(topi, cap),
                                cap)
    if "shared" in p:
        out = out + lm_layers.mlp_apply(p["shared"], x[None])[0]
    return out


@contextlib.contextmanager
def _einsum_tap(mod):
    """Within, ``mod``'s ``torch.einsum`` and ``torch.matmul`` calls are
    recorded as (equation, operands) into the list it yields, a matmul's
    equation being ``"matmul"`` (``_product`` computes either again)."""
    import torch
    calls = []

    class Tap:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def einsum(eq, *ops):
            calls.append((eq, ops))
            return torch.einsum(eq, *ops)

        @staticmethod
        def matmul(a, b):
            calls.append(("matmul", (a, b)))
            return torch.matmul(a, b)
    mod.torch = Tap()
    try:
        yield calls
    finally:
        mod.torch = torch


def _product(eq, ops):
    """A product ``_einsum_tap`` recorded, computed again on ``ops``."""
    import torch
    return torch.matmul(*ops) if eq == "matmul" else torch.einsum(eq, *ops)


def _products_yardstick(products) -> list:
    """Each recorded f32 product on its card operands, on the card and on
    the CPU, against the same product in f64: the two devices' own f32
    error on the layer's products."""
    rows = []
    for eq, ops in products:
        p64 = _product(eq, [o.double() for o in ops])
        e_c = float((_product(eq, ops).double() - p64).abs().max())
        e_h = float((_product(eq, [o.cpu() for o in ops]).double()
                     - p64.cpu()).abs().max())
        rows.append({"product": eq, "shape": [list(o.shape) for o in ops],
                     "card_err_vs_f64": e_c, "cpu_err_vs_f64": e_h,
                     "card_over_cpu": e_c / e_h if e_h else
                     (float("inf") if e_c else 1.0)})
        del p64
    return rows


@contextlib.contextmanager
def _spied(mod, name, on_call):
    """``mod.name`` calls ``on_call(args, out)`` after each call."""
    fn = getattr(mod, name)

    def spy(*args, **kw):
        out = fn(*args, **kw)
        on_call(args, out)
        return out
    setattr(mod, name, spy)
    try:
        yield
    finally:
        setattr(mod, name, fn)


def lm_moe_serve_path(torch, card_line: str) -> dict:
    """Phase 26: deepseek-moe-16b at full width (``MOE_SERVE``): the MoE
    layer in f32 card against CPU, then ``ServeEngine`` in bf16, a profile,
    both attention routes on the 4 x 512 batch and row 4 on layer 0's own
    q, k, v.  Every check raises.  Returns the flash kernels' launches in
    the serve run."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    from repro_torch.models import layers as lm_layers

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg16 = get_config(MOE_SERVE["arch"])
    m = cfg16.moe
    rng = np.random.default_rng(MOE_SERVE["seed"])
    bsz, blen = MOE_SERVE["batch"]
    batch = {"tokens": rng.integers(0, cfg16.vocab, (bsz, blen))}

    # ---- (a) the MoE layer in f32 at full width, card against CPU ---------
    cfg32 = dataclasses.replace(cfg16, dtype="float32",
                                n_layers=MOE_SERVE["f32_layers"])
    model = Transformer(cfg32, device="cuda", seed=MOE_SERVE["seed"])
    inputs = []
    with _spied(lm_layers, "moe_apply",
                lambda args, out: inputs.append((args[0], args[1]))):
        model.prefill(batch, blen)
    torch.cuda.synchronize()
    rows = []
    for i, (params, x) in enumerate(inputs):
        xt = x.reshape(-1, x.shape[-1])
        cpu = {n: ({a: b.cpu() for a, b in t.items()}
                   if isinstance(t, dict) else t.cpu())
               for n, t in params.items()}
        t0 = time.perf_counter()
        out_c = lm_layers.moe_apply(params, x, m)[0].reshape(xt.shape)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        with _einsum_tap(lm_layers) as products:
            lm_layers.moe_apply(params, x, m)
        t0 = time.perf_counter()
        out_h = lm_layers.moe_apply(cpu, x.cpu(), m)[0].reshape(xt.shape)
        cpu_s = time.perf_counter() - t0
        sp_c, ti_c, rk_c, cap = _moe_routes_of(lm_layers, params, xt, m)
        sp_h, ti_h, rk_h, _ = _moe_routes_of(lm_layers, cpu, xt.cpu(), m)
        k = m.top_k
        gap = (sp_h[:, k - 1] - sp_h[:, k]).abs() / sp_h[:, k - 1]
        near = gap <= MOE_SERVE["near_tie"]
        diff = (ti_c.cpu() != ti_h).any(dim=1)
        same = ~diff & (rk_c.cpu() == rk_h).all(dim=1)
        exact = _moe_f64(lm_layers, params, xt, ti_c, m).cpu()
        err_c = float((out_c.cpu().double() - exact)[same].abs().max())
        err_h = float((out_h.double() - exact)[same].abs().max())
        # the yardstick of the two devices' f32 products: each of the
        # layer's own products (the router's, the experts' three batched
        # ones, the shared experts' three) on its card operands, on each
        # device against f64
        gemm = _products_yardstick(products)
        gemm_ratio = max(g["card_over_cpu"] for g in gemm)
        del products
        row = {"layer": i, "tokens": xt.shape[0], "cap": cap,
               "dropped": int((rk_c == cap).sum()),
               "near_ties": int(near.sum()),
               "route_diffs": int(diff.sum()),
               "route_diffs_off_near_tie": int((diff & ~near).sum()),
               "tokens_compared": int(same.sum()),
               "card_err_vs_f64": err_c, "cpu_err_vs_f64": err_h,
               "card_over_cpu": err_c / err_h,
               "products": gemm, "products_card_over_cpu": gemm_ratio,
               "max_abs_f64": float(exact.abs().max()),
               "card_s": card_s, "cpu_s": cpu_s}
        row["ok"] = (row["route_diffs_off_near_tie"] == 0
                     and err_c <= MOE_SERVE["f32_ratio"] * err_h
                     * max(1.0, gemm_ratio)
                     and bool(torch.isfinite(out_c).all()))
        rows.append(row)
        del cpu, out_h, exact
    emit({"phase": "lm_moe_f32_layers", "nvidia_smi": card_line,
          "arch": cfg32.name, "layers": cfg32.n_layers,
          "batch": [bsz, blen], "near_tie_rel": MOE_SERVE["near_tie"],
          "limit_card_over_cpu": MOE_SERVE["f32_ratio"], "rows": rows})
    if len(rows) != cfg32.n_layers or not all(r["ok"] for r in rows):
        raise AssertionError(f"MoE layers at full width, card against CPU: "
                             f"{rows}")
    del model, inputs, params, x
    torch.cuda.empty_cache()

    # ---- (b) bf16: the serve run -------------------------------------------
    drops = []          # (tokens, cap, dropped entries on the device)

    def count_drops(args, out):
        topi, cap = args
        if topi.shape[0] > MOE_SERVE["slots"]:              # a prefill
            drops.append((topi.shape[0], cap, (out[2] == cap).sum()))

    def drop_fields(fields):
        n = cfg16.n_layers
        return {"prefill_tokens": [t for t, _, _ in drops[::n]],
                "capacity": [c for _, c, _ in drops[::n]],
                "dropped_slots_per_prefill_layer": [
                    [int(d) for _, _, d in drops[j:j + n]]
                    for j in range(0, len(drops), n)]}
    engine, run = serve_run(
        torch, cfg16, MOE_SERVE, rng, batch,
        {"phase": "lm_moe_serve_path", "nvidia_smi": card_line,
         "arch": cfg16.name, "dtype": cfg16.dtype, "layers": cfg16.n_layers,
         "d_model": cfg16.d_model, "experts": m.n_experts, "top_k": m.top_k,
         "shared": m.n_shared, "vocab": cfg16.vocab},
        spy=lambda: _spied(lm_layers, "moe_dispatch", count_drops),
        more=drop_fields)
    model = engine.model
    launches, n_pre = run["launches"], run["prefill_calls"]
    if len(drops) != cfg16.n_layers * n_pre or launches != {
            "flash_attention": cfg16.n_layers * n_pre,
            "flash_attention_f32": 0}:
        raise AssertionError(f"flash kernel launches in the MoE serve run "
                             f"{launches} over {n_pre} prefills "
                             f"({len(drops)} MoE prefill layers), want "
                             f"{cfg16.n_layers} a prefill on the tensor-core "
                             f"kernel")

    profile_lm(model, batch, blen, torch, card_line,
               n_decode=MOE_SERVE["n_decode_prof"],
               out_name="profile_lm_moe.txt")
    profile_moe_ops(model, batch, torch, card_line)

    # ---- (c) the two attention routes on the 4 x 512 batch; row 4 on
    # layer 0's own q, k, v ---------------------------------------------------
    captured = {}

    def capture(i, q, k, v, kw, out):
        if i == 0:
            captured[i] = (q, k, v, kw)
    model.use_kernel = True
    with _attention_spy(lm_layers, capture):
        lk, _ = model.prefill(batch, blen)
    model.use_kernel = False
    lp, _ = model.prefill(batch, blen)
    model.use_kernel = True
    torch.cuda.synchronize()
    lk, lp = lk[:, -1].float(), lp[:, -1].float()
    emit({"phase": "lm_moe_kernel_vs_plain", "nvidia_smi": card_line,
          "layers": cfg16.n_layers, "batch": [bsz, blen],
          "rms_kernel_minus_plain_over_rms": _rms(lk - lp) / _rms(lp),
          "argmax_agree": float((lk.argmax(-1) == lp.argmax(-1))
                                .float().mean())})
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        raise AssertionError("MoE prefill logits not finite")
    q, k, v, kw = captured[0]
    err, times = row4_check_and_time(torch, q, k, v, kw, "moe_lm_layer_0",
                                     card_line)
    emit({"phase": "lm_moe_serve_path_seconds",
          "seconds": time.perf_counter() - t_phase,
          "row4_max_abs_err": err, "row4": times})
    del engine, model, captured
    torch.cuda.empty_cache()
    return launches


def profile_moe_ops(model, batch, torch, card_line: str, reps: int = 3,
                    pad: int = 16, out_name: str = "profile_moe.txt") -> None:
    """One MoE layer's three parts (``moe_router``, ``moe_dispatch``,
    ``moe_experts``) and the shared experts, each under torch.profiler on
    layer 0's own input at the prefill shape and at the decode shape (the
    first ``slots`` tokens): kernel launches and device ms a call of each
    part, over ``reps`` calls.  A profile late in the script drops the
    records of its first kernels (``device_ms``), so the calls sit
    between ``pad`` launches of ``torch.cuda._sleep``'s ``spin_kernel`` on
    each side, left out of the sums; ``launch_calls`` counts the host's
    launch calls as a check on dropped device records."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import layers as lm_layers
    inputs = []
    with _spied(lm_layers, "moe_apply",
                lambda args, out: inputs.append(args)):
        model.prefill({"tokens": batch["tokens"]}, batch["tokens"].shape[1])
    params, x, m = inputs[0]
    rows = {}
    with open(os.path.join(OUT_DIR, out_name), "w") as f:
        for shape, xt in (("prefill", x.reshape(-1, x.shape[-1])),
                          ("decode", x.reshape(-1, x.shape[-1])
                           [:MOE_SERVE["slots"]])):
            _, probs, topv, topi = lm_layers.moe_router(params["router"], xt,
                                                        m.top_k)
            topw = topv / topv.sum(dim=-1, keepdim=True)
            cap = lm_layers.moe_capacity(xt.shape[0], m)
            routes = lm_layers.moe_dispatch(topi, cap)
            parts = {
                "router": lambda: lm_layers.moe_router(params["router"], xt,
                                                       m.top_k),
                "dispatch": lambda: lm_layers.moe_dispatch(topi, cap),
                "experts": lambda: lm_layers.moe_experts(params, xt, topw,
                                                         routes, cap)}
            if "shared" in params:
                parts["shared"] = lambda: lm_layers.mlp_apply(
                    params["shared"], xt[None])
            rows[shape] = {"tokens": xt.shape[0], "cap": cap}
            for name, fn in parts.items():
                fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(pad):
                        torch.cuda._sleep(100)
                    torch.cuda.synchronize()
                    time.sleep(0.02)
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3 / reps
                    for _ in range(pad):
                        torch.cuda._sleep(100)
                    torch.cuda.synchronize()
                evs = prof.key_averages()
                f.write(f"== {shape} {name} ({card_line})\n")
                f.write(evs.table(sort_by="self_device_time_total"
                                  if hasattr(evs[0], "self_device_time_total")
                                  else "self_cuda_time_total", row_limit=15))
                kernels = [e for e in evs
                           if str(e.device_type).endswith("CUDA")
                           and not e.key.startswith("Memcpy")
                           and "spin_kernel" not in e.key]
                launches = sum(e.count for e in evs
                               if not str(e.device_type).endswith("CUDA")
                               and e.key.startswith(("cudaLaunchKernel",
                                                     "cuLaunchKernel")))
                rows[shape][name] = {
                    "wall_ms": wall,
                    "device_ms": sum(_dev_ms(e) for e in kernels) / reps,
                    "kernel_launches": sum(e.count for e in kernels) / reps,
                    "launch_calls": (launches - 2 * pad) / reps}
    emit({"phase": "profile_moe", "file": out_name, "nvidia_smi": card_line,
          **rows})


def lm_moe_train_path(torch, card_line: str) -> dict:
    """Phase 27: qwen3-moe-30b-a3b at full width cut to 4 layers
    (``MOE_TRAIN``): the driver's run, one step's gradients against its
    routes, and both MoE smoke families' f32 step card against CPU.  Every
    check raises.  Returns the flash kernels' launches in the phase,
    asserted 0."""
    import dataclasses
    import gc
    import math

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import MarkovTokenStream
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import make_train_step
    from repro_torch.launch import train as train_mod
    from repro_torch.models import init_params
    from repro_torch.models import layers as lm_layers
    from repro_torch.optim import TrainState, cosine_schedule, tree_leaves

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    fa_ops.LAUNCHES = 0
    fa_ops.SM90_LAUNCHES = 0
    cfg = dataclasses.replace(get_config(MOE_TRAIN["arch"]),
                              n_layers=MOE_TRAIN["n_layers"])
    bsz, seq = MOE_TRAIN["batch"], MOE_TRAIN["seq"]
    ln_v = math.log(cfg.vocab)

    # ---- (a) the driver at full width, 4 layers ----------------------------
    stats = {}
    t0 = time.perf_counter()
    losses = train_mod.main(
        ["--arch", MOE_TRAIN["arch"], "--full", "--n-layers",
         str(MOE_TRAIN["n_layers"]), "--steps", str(MOE_TRAIN["steps"]),
         "--batch", str(bsz), "--seq", str(seq), "--log-every", "1",
         "--seed", str(MOE_TRAIN["seed"]), "--device", "cuda"], stats=stats)
    run_s = time.perf_counter() - t0
    emit({"phase": "lm_moe_train_driver", "nvidia_smi": card_line,
          "arch": cfg.name, "layers": cfg.n_layers,
          "layers_full": get_config(MOE_TRAIN["arch"]).n_layers,
          "d_model": cfg.d_model, "experts": cfg.moe.n_experts,
          "top_k": cfg.moe.top_k, "vocab": cfg.vocab,
          "params": stats["params"], "state_bytes": 16 * stats["params"],
          "batch": [bsz, seq], "tokens_per_step": stats["tokens_per_step"],
          "steps": stats["step"], "losses": stats["loss"],
          "ln_vocab": ln_v, "moe_lb": stats.get("moe_lb"),
          "moe_z": stats.get("moe_z"), "grad_norms": stats["grad_norm"],
          "fwd_bwd_ms": stats["fwd_bwd_ms"], "opt_ms": stats["opt_ms"],
          "median_step_ms": stats["median_step_ms"],
          "median_fwd_bwd_ms": stats["median_fwd_bwd_ms"],
          "median_opt_ms": stats["median_opt_ms"],
          "tokens_per_sec": stats["tokens_per_sec"],
          "peak_mem_bytes": stats["peak_mem_bytes"], "seconds": run_s})
    aux = (stats.get("moe_lb") or []) + (stats.get("moe_z") or [])
    if len(stats["loss"]) != MOE_TRAIN["steps"] \
            or len(losses) != MOE_TRAIN["steps"] \
            or len(aux) != 2 * MOE_TRAIN["steps"] \
            or not _finite(stats["loss"] + stats["grad_norm"] + aux) \
            or not all(abs(v - ln_v) <= MOE_TRAIN["loss_band"]
                       for v in stats["loss"]):
        raise AssertionError(f"the MoE driver's run: {stats}")
    del stats
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) one step's gradients against its routes ----------------------
    toks = MarkovTokenStream(cfg.vocab, MOE_TRAIN["seed"]).sample(
        np.random.default_rng(MOE_TRAIN["seed"]), bsz, seq)
    batch = {"tokens": torch.as_tensor(toks[:, :-1], device="cuda"),
             "labels": torch.as_tensor(toks[:, 1:], device="cuda")}
    gen = torch.Generator(device="cuda").manual_seed(MOE_TRAIN["seed"])
    params = init_params(cfg, gen, device="cuda")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    routed = []
    step = make_train_step(cfg, cosine_schedule(1e-4, 0, 10))
    with _spied(lm_layers, "moe_dispatch",
                lambda args, out: routed.append(
                    torch.bincount(args[0].reshape(-1),
                                   minlength=cfg.moe.n_experts))):
        loss, metrics, grads = step.loss_and_grads(
            TrainState(params=params, m={}, v={}, step=0), batch)
    # with recomputation the forward runs twice a layer, on the same
    # routes: the backward recomputes the layers last to first
    n = cfg.n_layers
    same_twice = len(routed) == 2 * n and all(
        torch.equal(routed[i], routed[2 * n - 1 - i]) for i in range(n))
    finite = all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
    zero_grad, unrouted = [], []
    for i, layer in enumerate(grads["layers"]):
        moe = layer["moe"]
        z = ((moe["wi"].abs().amax(dim=(1, 2)) == 0)
             & (moe["wg"].abs().amax(dim=(1, 2)) == 0)
             & (moe["wo"].abs().amax(dim=(1, 2)) == 0))
        zero_grad.append(int(z.sum()))
        unrouted.append(int((routed[i] == 0).sum()))
        if not torch.equal(z.cpu(), (routed[i] == 0).cpu()):
            zero_grad[-1] = -1
    emit({"phase": "lm_moe_train_grads", "nvidia_smi": card_line,
          "arch": cfg.name, "layers": n, "batch": [bsz, seq],
          "loss": float(loss), "moe_lb": float(metrics["moe_lb"]),
          "moe_z": float(metrics["moe_z"]), "all_finite": finite,
          "routes_same_in_recomputation": same_twice,
          "experts_zero_grad_per_layer": zero_grad,
          "experts_unrouted_per_layer": unrouted})
    if not (finite and same_twice and zero_grad == unrouted
            and math.isfinite(float(loss))):
        raise AssertionError(f"MoE step gradients: finite {finite}, routes "
                             f"kept in recomputation {same_twice}, zero-grad "
                             f"experts {zero_grad} against unrouted "
                             f"{unrouted}")
    del params, grads, loss, metrics, step
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) both MoE smoke families' f32 step, card against CPU ----------
    smoke_card_vs_cpu(torch, MOE_TRAIN["smoke_archs"], card_line,
                      phase="lm_moe_train_smoke_card_vs_cpu")
    launches = {"flash_attention": fa_ops.SM90_LAUNCHES,
                "flash_attention_f32": fa_ops.LAUNCHES - fa_ops.SM90_LAUNCHES}
    emit({"phase": "lm_moe_train_path_seconds",
          "seconds": time.perf_counter() - t_phase, "launches": launches})
    if launches != {"flash_attention": 0, "flash_attention_f32": 0}:
        raise AssertionError(f"flash kernel launches in the MoE training "
                             f"phase {launches}: a training forward takes "
                             f"the plain attention")
    return launches


def _f64_tree(t):
    """A parameter tree (nested dicts of tensors) in f64 on the CPU."""
    import torch
    return ({n: _f64_tree(v) for n, v in t.items()} if isinstance(t, dict)
            else t.detach().to("cpu", torch.float64))


def _mamba_runs(lm_layers, params, x, cfg, dtype, device):
    """The Mamba mixer ``params`` on ``x`` (B, S, d) as a prefill with a
    zero cache in ``dtype`` on ``device``, then one decode step on x's
    last token: both outputs, the cache after them, and the products the
    runs computed."""
    import dataclasses

    import torch
    from repro_torch.models import init_cache

    def moved(t):
        return ({n: moved(v) for n, v in t.items()} if isinstance(t, dict)
                else t.detach().to(device, dtype))
    p = moved(params)
    cache = init_cache(dataclasses.replace(cfg, n_layers=1), x.shape[0],
                       x.shape[1], dtype=dtype, device=device)["layers"][0]
    cache["ssm"] = cache["ssm"].to(torch.promote_types(dtype, torch.float32))
    xd = x.detach().to(device, dtype)
    with _einsum_tap(lm_layers) as products:
        pre, _ = lm_layers.mamba_apply(p, xd, cfg, cache=cache)
        dec, _ = lm_layers.mamba_apply(p, xd[:, -1:], cfg, cache=cache)
    return torch.cat([pre, dec], dim=1), cache, products


def lm_ssm_serve_path(torch, card_line: str) -> dict:
    """Phase 28: mamba2-780m at full width (``SSM_SERVE``): the Mamba mixer
    in f32 card against CPU and f64, the chunked SSD's carry and the decode
    states at full depth in f32, ``ServeEngine`` in bf16 with a profile,
    and jamba smoke's serve run (f32 card against CPU; bf16 with its row-4
    launches), with row 4 on the hybrid's own prefill q, k, v against its
    plain version.  Every check raises.  Returns the flash kernels'
    launches in the serve runs."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import Transformer, init_params
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import transformer as lm_tf
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.serving.__main__ import PROMPTS

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg16 = get_config(SSM_SERVE["arch"])
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    rng = np.random.default_rng(SSM_SERVE["seed"])
    bsz, blen = SSM_SERVE["batch"]
    batch = {"tokens": rng.integers(0, cfg16.vocab, (bsz, blen))}
    launches = {"flash_attention": 0, "flash_attention_f32": 0}

    def count_launches():
        for name, n in (("flash_attention", fa_ops.SM90_LAUNCHES),
                        ("flash_attention_f32",
                         fa_ops.LAUNCHES - fa_ops.SM90_LAUNCHES)):
            launches[name] += n
        fa_ops.LAUNCHES = 0
        fa_ops.SM90_LAUNCHES = 0

    # ---- (a) the Mamba mixer in f32 at full width, card against CPU -------
    t0 = time.perf_counter()
    cfg_l = dataclasses.replace(cfg32, n_layers=SSM_SERVE["f32_layers"])
    model = Transformer(cfg_l, device="cuda", seed=SSM_SERVE["seed"])
    inputs = []
    with _spied(lm_layers, "mamba_apply",
                lambda args, out: inputs.append((args[0], args[1]))):
        model.prefill(batch, blen)
    torch.cuda.synchronize()
    rows = []
    for i, (params, x) in enumerate(inputs):
        t1 = time.perf_counter()
        out_c, cache_c, products = _mamba_runs(lm_layers, params, x, cfg32,
                                               torch.float32, "cuda")
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t1
        gemm = _products_yardstick(products)
        gemm_ratio = max(g["card_over_cpu"] for g in gemm)
        del products
        t1 = time.perf_counter()
        out_h, cache_h, _ = _mamba_runs(lm_layers, params, x, cfg32,
                                        torch.float32, "cpu")
        cpu_s = time.perf_counter() - t1
        exact, cache_x, _ = _mamba_runs(lm_layers, _f64_tree(params), x,
                                        cfg32, torch.float64, "cpu")
        err_c = float((out_c.cpu().double() - exact).abs().max())
        err_h = float((out_h.double() - exact).abs().max())
        st_c = float((cache_c["ssm"].cpu().double()
                      - cache_x["ssm"]).abs().max())
        st_h = float((cache_h["ssm"].double() - cache_x["ssm"]).abs().max())
        row = {"layer": i, "tokens": list(x.shape[:2]), "chunk":
               cfg32.ssm.chunk, "card_err_vs_f64": err_c,
               "cpu_err_vs_f64": err_h, "card_over_cpu": err_c / err_h,
               "ssm_state_card_err_vs_f64": st_c,
               "ssm_state_cpu_err_vs_f64": st_h,
               "products": gemm, "products_card_over_cpu": gemm_ratio,
               "max_abs_f64": float(exact.abs().max()),
               "card_s": card_s, "cpu_s": cpu_s}
        limit = SSM_SERVE["f32_ratio"] * max(1.0, gemm_ratio)
        row["ok"] = (err_c <= limit * err_h and st_c <= limit * st_h
                     and bool(torch.isfinite(out_c).all()))
        rows.append(row)
        del out_c, out_h, exact, cache_c, cache_h, cache_x
    emit({"phase": "lm_ssm_f32_layers", "nvidia_smi": card_line,
          "arch": cfg32.name, "layers": cfg_l.n_layers,
          "batch": [bsz, blen], "limit_card_over_cpu": SSM_SERVE["f32_ratio"],
          "rows": rows, "seconds": time.perf_counter() - t0})
    if len(rows) != cfg_l.n_layers or not all(r["ok"] for r in rows):
        raise AssertionError(f"Mamba mixers at full width, card against "
                             f"CPU: {rows}")
    del model, inputs, params, x
    torch.cuda.empty_cache()

    # ---- (b) f32 at full depth: the chunks' carry and the decode states ---
    t0 = time.perf_counter()
    model = Transformer(cfg32, device="cuda", seed=SSM_SERVE["seed"])
    # the residual stream after some layers, for the bf16 run in (c)
    depths = sorted({0, 5, 11, 23, 35, cfg32.n_layers - 1})
    resid32 = []

    def keep_resid(store):
        seen = [0]

        def on_call(args, out):
            if seen[0] in depths:
                store.append(out[0].detach())
            seen[0] += 1
        return on_call
    with torch.no_grad(), _spied(lm_tf, "_apply_position",
                                 keep_resid(resid32)):
        full = model(batch)                                 # chunks of 256
    with torch.no_grad():
        model.cfg = dataclasses.replace(cfg32, ssm=dataclasses.replace(
            cfg32.ssm, chunk=blen))
        one = model(batch)                                  # one chunk
        model.cfg = cfg32
    p, n_dec = SSM_SERVE["prompt_decode"], SSM_SERVE["decode"]
    _, cache = model.prefill({"tokens": batch["tokens"][:, :p]}, blen)
    dec_err, dec_ok = 0.0, True
    for t in range(p, p + n_dec):
        got, cache = model.decode_step(cache, batch["tokens"][:, t:t + 1])
        want = full[:, t:t + 1]
        dec_err = max(dec_err, float((got - want).abs().max()))
        dec_ok &= bool(torch.allclose(got, want, rtol=SSM_SERVE["rtol"],
                                      atol=SSM_SERVE["atol"]))
    torch.cuda.synchronize()
    chunk_err = float((full - one).abs().max())
    chunk_ok = bool(torch.allclose(full, one, rtol=SSM_SERVE["rtol"],
                                   atol=SSM_SERVE["atol"]))
    l32 = full[:, -1].float().cpu()
    emit({"phase": "lm_ssm_f32_full_depth", "nvidia_smi": card_line,
          "arch": cfg32.name, "layers": cfg32.n_layers,
          "params": model.n_params(), "batch": [bsz, blen],
          "chunks": [cfg32.ssm.chunk, blen],
          "chunks_max_abs_diff": chunk_err,
          "prompt": p, "decode": n_dec, "decode_max_abs_diff": dec_err,
          "max_abs_logit": float(full.abs().max()),
          "rtol": SSM_SERVE["rtol"], "atol": SSM_SERVE["atol"],
          "chunks_ok": chunk_ok, "decode_ok": dec_ok,
          "finite": bool(torch.isfinite(full).all()),
          "seconds": time.perf_counter() - t0})
    if not (chunk_ok and dec_ok and torch.isfinite(full).all()):
        raise AssertionError(f"mamba2 f32 at full depth: chunks of "
                             f"{cfg32.ssm.chunk} against one chunk max |diff| "
                             f"{chunk_err}, decode against the forward "
                             f"{dec_err}")
    del model, full, one, cache, got, want
    torch.cuda.empty_cache()

    # ---- (c) bf16: the serve run -------------------------------------------
    chunk = cfg16.ssm.chunk
    engine, run = serve_run(
        torch, cfg16, SSM_SERVE, rng, batch,
        {"phase": "lm_ssm_serve_path", "nvidia_smi": card_line,
         "arch": cfg16.name, "dtype": cfg16.dtype, "layers": cfg16.n_layers,
         "d_model": cfg16.d_model, "ssm": dataclasses.asdict(cfg16.ssm),
         "vocab": cfg16.vocab},
        more=lambda f: {"one_chunk_fallback": [
            n % chunk != 0 and n > chunk for n in f["prefill_lengths"]]})
    model = engine.model
    count_launches()
    if any(run["launches"].values()) or not any(
            n % chunk for n in run["prefill_lengths"]):
        raise AssertionError(f"the Mamba serve run launched flash kernels "
                             f"{run['launches']} (want none), prefill "
                             f"lengths {run['prefill_lengths']} (want one "
                             f"that is not a multiple of {chunk})")
    profile_lm(model, batch, blen, torch, card_line,
               n_decode=SSM_SERVE["n_decode_prof"],
               out_name="profile_ssm.txt")
    resid16 = []
    with _spied(lm_tf, "_apply_position", keep_resid(resid16)):
        lk, _ = model.prefill(batch, blen)                  # two chunks
    lk = lk[:, -1].float().cpu()
    emit({"phase": "lm_ssm_bf16_vs_f32", "nvidia_smi": card_line,
          "layers": cfg16.n_layers, "batch": [bsz, blen],
          "rms_bf16_minus_f32_over_rms_after_layer": {
              str(d + 1): _rms(a.float() - b) / _rms(b)
              for d, a, b in zip(depths, resid16, resid32)},
          "rms_bf16_minus_f32_over_rms": _rms(lk - l32) / _rms(l32),
          "argmax_agree": float((lk.argmax(-1) == l32.argmax(-1))
                                .float().mean()),
          "finite": bool(torch.isfinite(lk).all())})
    if not torch.isfinite(lk).all():
        raise AssertionError("mamba2 bf16 prefill logits not finite")
    del engine, model, resid16, resid32
    torch.cuda.empty_cache()

    # ---- (d) the jamba hybrid at smoke size: f32 card against CPU, bf16 ---
    hybrid = {}
    for dtype in ("float32", "bfloat16"):
        hcfg = dataclasses.replace(get_config(SSM_SERVE["hybrid"],
                                              smoke=True), dtype=dtype)
        # one f32 draw on the CPU for both devices (a generator on the card
        # draws other numbers)
        hparams = init_params(hcfg, torch.Generator().manual_seed(
            SSM_SERVE["seed"]))
        runs = {}
        for dev in ("cpu", "cuda"):
            eng = ServeEngine(hparams, hcfg, batch_slots=4, max_seq=96,
                              device=dev)
            n_pre = []
            eng.model.prefill = (lambda fn: lambda *a: n_pre.append(1)
                                 or fn(*a))(eng.model.prefill)
            for i, prompt in enumerate(PROMPTS):
                eng.submit(Request(rid=i, prompt=prompt, max_new_tokens=
                                   SSM_SERVE["hybrid_new_tokens"]))
            fa_ops.LAUNCHES = 0
            fa_ops.SM90_LAUNCHES = 0
            done = eng.run()
            if dev == "cuda":
                torch.cuda.synchronize()
                got = (fa_ops.SM90_LAUNCHES,
                       fa_ops.LAUNCHES - fa_ops.SM90_LAUNCHES)
                count_launches()
            runs[dev] = ([(r.rid, r.generated) for r in done], len(n_pre))
        # the first batch's prefill logits on both devices, the card's on
        # both attention routes; on the kernel route the attention layer's
        # q, k, v and output
        first = np.zeros((4, 4), np.int64)
        for i, prompt in enumerate(PROMPTS[:4]):
            first[i, 4 - len(prompt):] = prompt
        logits, seen = {}, []
        for dev, route in (("cpu", False), ("cuda", True), ("cuda", False)):
            m = Transformer(hcfg, hparams, device=dev, use_kernel=route)
            with (_attention_spy(lm_layers, lambda i, *a: seen.append(a))
                  if route else contextlib.nullcontext()):
                logits[(dev, route)] = m.prefill({"tokens": first},
                                                 96)[0].cpu()
        attn = sum(k != "mamba" for k in hcfg.pattern) * hcfg.n_blocks
        if len(seen) != attn:
            raise AssertionError(f"jamba smoke prefill in {dtype}: "
                                 f"{len(seen)} attention calls, want {attn}")
        # row 4 against its plain version on those q, k, v: f32 within its
        # tolerance, bf16 through row4_check_and_time (which raises)
        q, k, v, kw, out = seen[0]
        if dtype == "float32":
            err = float((out - flash_attention_ref(q, k, v, **kw))
                        .abs().max())
            row4 = {"max_abs_err": err, **ATTENTION_TOL["float32"],
                    "ok": err <= ATTENTION_TOL["float32"]["atol"]}
        else:
            err, times = row4_check_and_time(
                torch, q, k, v, kw, "jamba_smoke_prefill", card_line)
            row4 = {"max_abs_err": err, **times, "ok": True}
        row4 = {"shape": list(q.shape), "kv_shape": list(k.shape), **kw,
                **row4}
        fa_ops.LAUNCHES = 0                     # checks, not the serve run
        fa_ops.SM90_LAUNCHES = 0
        del seen, q, k, v, out
        n_pre = runs["cuda"][1]
        same = runs["cuda"][0] == runs["cpu"][0]
        agree = float(np.mean([a == b for (_, ga), (_, gb) in
                               zip(runs["cuda"][0], runs["cpu"][0])
                               for a, b in zip(ga, gb)]))
        ref = logits[("cpu", False)]
        hybrid[dtype] = {"prefills": n_pre, "attention_layers": attn,
                         "launches_sm90_f32": list(got),
                         "tokens_equal_cpu": same,
                         "token_agreement_cpu": agree,
                         "first_prefill_max_abs_logit": float(
                             ref.abs().max()),
                         "first_prefill_kernel_minus_cpu": float(
                             (logits[("cuda", True)] - ref).abs().max()),
                         "first_prefill_plain_minus_cpu": float(
                             (logits[("cuda", False)] - ref).abs().max()),
                         "row4": row4}
    emit({"phase": "lm_ssm_hybrid_serve", "nvidia_smi": card_line,
          "arch": SSM_SERVE["hybrid"], "smoke": True, "requests": len(PROMPTS),
          **hybrid})
    for dtype, h in hybrid.items():
        attn, n_pre = h["attention_layers"], h["prefills"]
        want = [attn * n_pre, 0] if dtype == "bfloat16" else [0, attn * n_pre]
        if h["launches_sm90_f32"] != want or not h["row4"]["ok"] or (
                dtype == "float32" and not h["tokens_equal_cpu"]):
            raise AssertionError(f"jamba smoke serve run in {dtype}: row-4 "
                                 f"launches {h['launches_sm90_f32']} (want "
                                 f"{want}), row 4 against its plain version "
                                 f"{h['row4']}, tokens equal to the CPU's: "
                                 f"{h['tokens_equal_cpu']}")
    emit({"phase": "lm_ssm_serve_path_seconds",
          "seconds": time.perf_counter() - t_phase, "launches": launches})
    return launches


def lm_ssm_train_path(torch, card_line: str) -> dict:
    """Phase 29: mamba2-780m at full width through the driver
    (``SSM_TRAIN``), and both Mamba smoke families' f32 step card against
    CPU.  Every check raises.  Returns the flash kernels' launches in the
    phase, asserted 0."""
    import gc
    import math

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train as train_mod

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    fa_ops.LAUNCHES = 0
    fa_ops.SM90_LAUNCHES = 0
    cfg = get_config(SSM_TRAIN["arch"])
    bsz, seq = SSM_TRAIN["batch"], SSM_TRAIN["seq"]
    ln_v = math.log(cfg.vocab)

    # ---- (a) the driver at full width -------------------------------------
    stats = {}
    t0 = time.perf_counter()
    losses = train_mod.main(
        ["--arch", SSM_TRAIN["arch"], "--full", "--steps",
         str(SSM_TRAIN["steps"]), "--batch", str(bsz), "--seq", str(seq),
         "--log-every", "1", "--seed", str(SSM_TRAIN["seed"]),
         "--device", "cuda"], stats=stats)
    run_s = time.perf_counter() - t0
    emit({"phase": "lm_ssm_train_driver", "nvidia_smi": card_line,
          "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
          "ssm": {"heads": cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim,
                  "head_dim": cfg.ssm.head_dim, "d_state": cfg.ssm.d_state,
                  "chunk": cfg.ssm.chunk},
          "vocab": cfg.vocab, "params": stats["params"],
          "state_bytes": 16 * stats["params"], "batch": [bsz, seq],
          "tokens_per_step": stats["tokens_per_step"],
          "steps": stats["step"], "losses": stats["loss"], "ln_vocab": ln_v,
          "grad_norms": stats["grad_norm"],
          "fwd_bwd_ms": stats["fwd_bwd_ms"], "opt_ms": stats["opt_ms"],
          "median_step_ms": stats["median_step_ms"],
          "median_fwd_bwd_ms": stats["median_fwd_bwd_ms"],
          "median_opt_ms": stats["median_opt_ms"],
          "tokens_per_sec": stats["tokens_per_sec"],
          "peak_mem_bytes": stats["peak_mem_bytes"], "seconds": run_s})
    if len(stats["loss"]) != SSM_TRAIN["steps"] \
            or len(losses) != SSM_TRAIN["steps"] \
            or not _finite(stats["loss"] + stats["grad_norm"]) \
            or not all(abs(v - ln_v) <= SSM_TRAIN["loss_band"]
                       for v in stats["loss"]):
        raise AssertionError(f"the Mamba driver's run: {stats}")
    del stats
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) both Mamba smoke families' f32 step, card against CPU --------
    smoke_card_vs_cpu(torch, SSM_TRAIN["smoke_archs"], card_line,
                      phase="lm_ssm_train_smoke_card_vs_cpu")
    launches = {"flash_attention": fa_ops.SM90_LAUNCHES,
                "flash_attention_f32": fa_ops.LAUNCHES - fa_ops.SM90_LAUNCHES}
    emit({"phase": "lm_ssm_train_path_seconds",
          "seconds": time.perf_counter() - t_phase, "launches": launches})
    if launches != {"flash_attention": 0, "flash_attention_f32": 0}:
        raise AssertionError(f"flash kernel launches in the Mamba training "
                             f"phase {launches}: a training forward takes "
                             f"the plain attention")
    return launches


def _row4_sites(cfg) -> list:
    """Which flash-kernel call of a prefill serves which site: whisper's
    encoder layers (not causal), then in each decoder layer its
    self-attention (causal) and its cross-attention onto the encoder's
    output (not causal); one self-attention a layer elsewhere."""
    if cfg.encoder is None:
        return ["self"] * cfg.n_layers
    return ["encoder"] * cfg.encoder.n_layers + ["self", "cross"] * cfg.n_layers


def stub_serve_path(torch, settings: dict, phase: str, results,
                    card_line: str) -> dict:
    """Phases 30 and 31: a modality-stub family at full width in bf16
    through ``launch.make_prefill`` and ``make_decode_step``
    (``settings``: ``ENC_SERVE`` or ``VLM_SERVE``): one prefill of the
    seeded batch and its stub inputs, then greedy decode steps, inside the
    flash kernels' counts at 0 (row 4 on every prefill attention: the
    encoder's, cross-attention's and the decoder's own); a profile; row 4
    on the model's own q, k, v at the settings' calls, against its plain
    version and timed (into ``results["flash_attention"]["shapes"]``);
    then the f32 model at reduced depth, card against CPU and decode
    against the forward.  Every check raises.  Returns the serve run's
    flash launches by site."""
    import dataclasses
    import gc

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import make_decode_step, make_prefill
    from repro_torch.launch.train import random_stub_inputs
    from repro_torch.models import Transformer, init_params
    from repro_torch.models import layers as lm_layers

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(settings["arch"])
    bsz, plen, new = (settings["batch"], settings["prompt"],
                      settings["new_tokens"])
    max_seq = settings["max_seq"]
    rng = np.random.default_rng(settings["seed"])
    stub = {k: torch.as_tensor(v, device="cuda")
            for k, v in random_stub_inputs(cfg, bsz, rng).items()}
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (bsz, plen)), device="cuda"), **stub}
    n_pre = cfg.n_patches if cfg.frontend == "vision_stub" else 0

    # ---- (a) bf16 at full width: prefill and greedy decode -----------------
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda", seed=settings["seed"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prefill, decode = make_prefill(cfg, max_seq), make_decode_step(cfg)
    _, warm = prefill(model, {**batch, "tokens": batch["tokens"][:, :16]})
    decode(model, warm, {"tokens": batch["tokens"][:, :1]})
    del warm
    sites = _row4_sites(cfg)
    by_site = {}

    def count(i, q, k, v, kw, out):
        by_site[sites[i]] = by_site.get(sites[i], 0) + 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.LAUNCHES = 0
    fa_ops.SM90_LAUNCHES = 0
    with _attention_spy(lm_layers, count):
        t0 = time.perf_counter()
        logits, cache = prefill(model, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        finite = [bool(torch.isfinite(logits).all())]
        toks, dec_s = [], []
        for _ in range(new):
            nxt = logits[:, -1].argmax(-1, keepdim=True)
            toks.append(nxt)
            t0 = time.perf_counter()
            logits, cache = decode(model, cache, {"tokens": nxt})
            torch.cuda.synchronize()
            dec_s.append(time.perf_counter() - t0)
            finite.append(bool(torch.isfinite(logits).all()))
    launches = {"flash_attention": fa_ops.SM90_LAUNCHES,
                "flash_attention_f32": fa_ops.LAUNCHES - fa_ops.SM90_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    toks = torch.cat(toks, 1).cpu()
    want_sites = {}
    for name in sites:
        want_sites[name] = want_sites.get(name, 0) + 1
    fields = {"phase": phase, "nvidia_smi": card_line, "arch": cfg.name,
              "dtype": cfg.dtype, "layers": cfg.n_layers,
              "encoder_layers": (cfg.encoder.n_layers if cfg.encoder
                                 else 0),
              "d_model": cfg.d_model, "vocab": cfg.vocab,
              "params": model.n_params(), "param_count": cfg.param_count(),
              "init_seconds": init_s, "batch": [bsz, plen],
              "stub_inputs": {k: list(v.shape) for k, v in stub.items()},
              "prefill_len": n_pre + plen, "new_tokens": new,
              "prefill_ms": 1e3 * prefill_s,
              "decode_ms_per_step": 1e3 * statistics.median(dec_s),
              "decode_ms_mean": 1e3 * statistics.mean(dec_s),
              "tokens_per_sec": bsz * new / (prefill_s + sum(dec_s)),
              "peak_mem_bytes": peak, "cache_len": cache["len"],
              "launches": launches, "launches_by_site": by_site,
              "launches_by_site_want": want_sites,
              "finite": all(finite),
              "tokens_in_vocab": bool(((toks >= 0) & (toks < cfg.vocab))
                                      .all())}
    emit(fields)
    if not (all(finite) and fields["tokens_in_vocab"]
            and cache["len"] == n_pre + plen + new
            and by_site == want_sites
            and launches == {"flash_attention": len(sites),
                             "flash_attention_f32": 0}):
        raise AssertionError(f"{phase}: the serve run {fields}")
    del cache, logits

    profile_lm(model, batch, max_seq, torch, card_line,
               out_name=settings["out"])

    # ---- (b) row 4 on the model's own q, k, v at the prefill shapes -------
    captured = {}
    calls = {i: name for name, i in settings["row4_calls"].items()}

    def capture(i, q, k, v, kw, out):
        if i in calls:
            captured[calls[i]] = (q, k, v, kw)
    with _attention_spy(lm_layers, capture):
        model.prefill(batch, max_seq)
    torch.cuda.synchronize()
    shapes = results["flash_attention"].setdefault("shapes", {})
    for name, (q, k, v, kw) in captured.items():
        err, line = row4_check_and_time(torch, q, k, v, kw, name, card_line)
        shapes[name] = {"shape": [*q.shape[:2], k.shape[1], q.shape[2],
                                  k.shape[2], q.shape[3]],
                        "causal": kw["causal"], "max_abs_err": err, **line}
    if sorted(captured) != sorted(settings["row4_calls"]):
        raise AssertionError(f"{phase}: row 4's calls {sorted(captured)}")
    fa_ops.LAUNCHES = 0                         # checks, not the serve run
    fa_ops.SM90_LAUNCHES = 0
    del model, captured, batch, stub
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) f32 at reduced depth: card against CPU, decode against the
    # forward
    t0 = time.perf_counter()
    nl = settings["f32_layers"]
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=nl)
    if cfg.encoder is not None:
        cfg32 = dataclasses.replace(cfg32, encoder=dataclasses.replace(
            cfg.encoder, n_layers=nl))
    params = init_params(cfg32, torch.Generator().manual_seed(
        settings["seed"]))
    fb, fp, fd = (settings["f32_batch"], settings["f32_prompt"],
                  settings["f32_decode"])
    frng = np.random.default_rng(settings["seed"] + 1)
    fbatch = {"tokens": frng.integers(0, cfg.vocab, (fb, fp)),
              **random_stub_inputs(cfg32, fb, frng)}
    prefill, decode = (make_prefill(cfg32, n_pre + fp + fd),
                       make_decode_step(cfg32))
    runs = {}
    for dev in ("cpu", "cuda"):
        m = Transformer(cfg32, params, device=dev)
        t1 = time.perf_counter()
        lg, c = prefill(m, fbatch)
        out, seq = [lg[:, -1].float().cpu()], []
        for _ in range(fd):
            nxt = lg[:, -1].argmax(-1, keepdim=True)
            seq.append(nxt.cpu())
            lg, c = decode(m, c, {"tokens": nxt})
            out.append(lg[:, -1].float().cpu())
        runs[dev] = (torch.cat(seq, 1), torch.stack(out, 1), m,
                     time.perf_counter() - t1)
    (t_h, l_h, m_h, cpu_s), (t_c, l_c, m, card_s) = (runs["cpu"],
                                                     runs["cuda"])
    # the yardstick: how far the CPU's last prefill logits move when the
    # stub's inputs move by one f32 step
    name = "encoder_embeds" if cfg.encoder is not None else "patch_embeds"
    with torch.no_grad():
        moved = prefill(m_h, {**fbatch, name: fbatch[name]
                              * np.float32(1 + 2 ** -23)})[0][:, -1]
    one_step = float((moved.float() - l_h[:, 0]).abs().max())
    del m_h, moved
    # the card's decode against its own forward over prompt and tokens
    full = m({**fbatch, "tokens": np.concatenate(
        [fbatch["tokens"], t_c.numpy()], 1)})[:, fp - 1:].float().cpu()
    row = {"phase": f"{phase}_f32", "nvidia_smi": card_line,
           "layers": nl, "batch": [fb, fp], "decode": fd,
           "tokens_equal_cpu": bool(torch.equal(t_c, t_h)),
           "card_minus_cpu_max_abs": float((l_c - l_h).abs().max()),
           "decode_minus_forward_max_abs": float((l_c - full).abs().max()),
           "max_abs_logit": float(l_h.abs().max()),
           "cpu_logits_move_at_one_f32_step_of_inputs": one_step,
           "rtol": settings["rtol"], "atol": settings["atol"],
           "card_s": card_s, "cpu_s": cpu_s,
           "seconds": time.perf_counter() - t0}
    row["ok"] = (row["tokens_equal_cpu"]
                 and bool(torch.allclose(l_c, l_h, rtol=settings["rtol"],
                                         atol=settings["atol"]))
                 and bool(torch.allclose(l_c, full, rtol=settings["rtol"],
                                         atol=settings["atol"])))
    emit(row)
    fa_ops.LAUNCHES = 0                         # checks, not the serve run
    fa_ops.SM90_LAUNCHES = 0
    if not row["ok"]:
        raise AssertionError(f"{phase}: the f32 model at {nl} layers: {row}")
    del runs, m, params
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": f"{phase}_seconds",
          "seconds": time.perf_counter() - t_phase, "launches": launches,
          "launches_by_site": by_site})
    return {"flash_attention": {f"{phase}/{k}": n for k, n in by_site.items()},
            "flash_attention_f32": {phase: 0}}


def stub_train_path(torch, settings: dict, phase: str,
                    card_line: str) -> dict:
    """Phases 32 and 33: a modality-stub family at full width through the
    driver (``settings``: ``ENC_TRAIN`` or ``VLM_TRAIN``; the driver's
    zero stub inputs, as the reference's, on which both packages' grad
    norms are NaN at this depth), the train step at full width on a fixed
    batch with seeded normal stub inputs (its first update held against
    AdamW recomputed on a sample of every leaf), and its smoke family's
    f32 step
    on the card against the CPU on seeded normal stub inputs.  Every check
    raises.  Returns the flash kernels' launches in the phase, asserted
    0."""
    import gc
    import math

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import make_train_step
    from repro_torch.launch import train as train_mod
    from repro_torch.models import forward_train, init_params
    from repro_torch.optim import adamw_init

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    fa_ops.LAUNCHES = 0
    fa_ops.SM90_LAUNCHES = 0
    cfg = get_config(settings["arch"])
    bsz, seq = settings["batch"], settings["seq"]
    ln_v = math.log(cfg.vocab)
    stats = {}
    t0 = time.perf_counter()
    losses = train_mod.main(
        ["--arch", settings["arch"], "--full", "--steps",
         str(settings["steps"]), "--batch", str(bsz), "--seq", str(seq),
         "--log-every", "1", "--seed", str(settings["seed"]),
         "--device", "cuda"], stats=stats)
    run_s = time.perf_counter() - t0
    emit({"phase": f"{phase}_driver", "nvidia_smi": card_line,
          "arch": cfg.name, "layers": cfg.n_layers,
          "encoder_layers": cfg.encoder.n_layers if cfg.encoder else 0,
          "d_model": cfg.d_model, "vocab": cfg.vocab,
          "stub_extras": {k: list(v[0]) for k, v in
                          train_mod.stub_extras(cfg).items()},
          "params": stats["params"], "state_bytes": 16 * stats["params"],
          "batch": [bsz, seq], "tokens_per_step": stats["tokens_per_step"],
          "steps": stats["step"], "losses": stats["loss"], "ln_vocab": ln_v,
          "grad_norms": stats["grad_norm"],
          "fwd_bwd_ms": stats["fwd_bwd_ms"], "opt_ms": stats["opt_ms"],
          "median_step_ms": stats["median_step_ms"],
          "median_fwd_bwd_ms": stats["median_fwd_bwd_ms"],
          "median_opt_ms": stats["median_opt_ms"],
          "tokens_per_sec": stats["tokens_per_sec"],
          "peak_mem_bytes": stats["peak_mem_bytes"], "seconds": run_s})
    if len(stats["loss"]) != settings["steps"] \
            or len(losses) != settings["steps"] \
            or not abs(stats["loss"][0] - ln_v) <= settings["loss_band"] \
            or any(math.isfinite(g) for g in stats["grad_norm"]):
        raise AssertionError(f"{phase}: the driver's run on zero stub "
                             f"inputs, want the first loss near ln(vocab) "
                             f"and NaN grad norms (note o): {stats}")
    del stats
    gc.collect()
    torch.cuda.empty_cache()

    # ---- one fixed batch with seeded normal stub inputs ------------------
    rng = np.random.default_rng(settings["seed"])
    toks = rng.integers(0, cfg.vocab, (bsz, seq + 1))
    batch = {"tokens": torch.as_tensor(toks[:, :-1], device="cuda"),
             "labels": torch.as_tensor(toks[:, 1:], device="cuda"),
             **{k: torch.as_tensor(v, device="cuda")
                for k, v in train_mod.random_stub_inputs(
                    cfg, bsz, rng).items()}}
    gen = torch.Generator(device="cuda").manual_seed(settings["seed"])
    state = adamw_init(init_params(cfg, gen, device="cuda"))
    step = make_train_step(cfg, lambda _: settings["fixed_lr"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fixed, step_ms = [], []
    for i in range(settings["fixed_steps"]):
        t0 = time.perf_counter()
        if i:
            state, m = step(state, batch)
        else:
            loss, metrics, grads = step.loss_and_grads(state, batch)
            before = _update_sample(state.params, grads)
            state, m = step.apply(state, grads, loss, metrics)
            del grads
        fixed.append((float(m["loss"]), float(m["grad_norm"])))
        step_ms.append(1e3 * (time.perf_counter() - t0))
        if not i:
            update = _check_first_update(before, state.params, m["grad_norm"],
                                         settings["fixed_lr"])
            del before
    # an evaluation, not a training step: off autograd it may take the
    # flash kernels, which the phase's count leaves out
    counts = (fa_ops.LAUNCHES, fa_ops.SM90_LAUNCHES)
    with torch.no_grad():
        after = float(forward_train(state.params, batch, cfg,
                                    remat=False)[0])
    fa_ops.LAUNCHES, fa_ops.SM90_LAUNCHES = counts
    line = {"phase": f"{phase}_fixed_batch", "nvidia_smi": card_line,
            "lr": settings["fixed_lr"],
            "stub_inputs": {k: list(v.shape) for k, v in batch.items()
                            if k not in ("tokens", "labels")},
            "losses": [a for a, _ in fixed], "loss_after": after,
            "grad_norms": [b for _, b in fixed], "step_ms": step_ms,
            "first_update": update,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    emit(line)
    if not update["ok"] \
            or not _finite(line["losses"] + line["grad_norms"] + [after]) \
            or not all(abs(v - ln_v) <= settings["loss_band"]
                       for v in line["losses"] + [after]):
        raise AssertionError(f"{phase}: the fixed batch at full width: "
                             f"{line}")
    del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    smoke_card_vs_cpu(torch, (settings["arch"],), card_line,
                      phase=f"{phase}_smoke_card_vs_cpu")
    launches = {"flash_attention": fa_ops.SM90_LAUNCHES,
                "flash_attention_f32": fa_ops.LAUNCHES - fa_ops.SM90_LAUNCHES}
    emit({"phase": f"{phase}_seconds",
          "seconds": time.perf_counter() - t_phase, "launches": launches})
    if launches != {"flash_attention": 0, "flash_attention_f32": 0}:
        raise AssertionError(f"flash kernel launches in {phase} {launches}: "
                             f"a training forward takes the plain "
                             f"attention")
    return launches


def lm_pod_train_path(torch, card_line: str) -> dict:
    """Phase 34: the paper's cross-pod gradient exchange (``POD_TRAIN``):
    (a) the driver with ``--pods 2 --edge-exchange`` on starcoder2-3b at
    full width cut to 12 layers; (b) two exchanged smoke steps (full sync,
    then the controller's plan) on the card against the CPU; (c) the same
    steps on two gloo ranks sharing the card, bitwise (b)'s card steps.
    Every check raises.  Returns the flash kernels' launches in the
    phase, asserted 0."""
    import gc
    import math
    import tempfile

    import numpy as np
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import (EdgeGradController, ExchangePlan,
                                   full_sync_plan, stream_sizes,
                                   synced_bytes)

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    fa_ops.LAUNCHES = 0
    fa_ops.SM90_LAUNCHES = 0
    s = POD_TRAIN

    # ---- (a) the driver at full width, 12 layers --------------------------
    stats = {}
    t0 = time.perf_counter()
    losses = train_mod.main(
        ["--arch", s["arch"], "--full", "--n-layers", str(s["n_layers"]),
         "--pods", str(s["pods"]), "--edge-exchange", "--dcn-budget",
         str(s["dcn_budget"]), "--exchange-window", str(s["window"]),
         "--steps", str(s["steps"]), "--batch", str(s["batch"]), "--seq",
         str(s["seq"]), "--lr", str(s["lr"]), "--log-every", "5", "--seed",
         str(s["seed"]), "--device", "cuda"], stats=stats)
    run_s = time.perf_counter() - t0
    full_bytes = 4 * stats["params"]
    emit({"phase": "lm_pod_train_driver", "nvidia_smi": card_line,
          "arch": stats["arch"], "layers": s["n_layers"],
          "d_model": get_config(s["arch"]).d_model, "params": stats["params"],
          "pods": s["pods"], "batch": [s["batch"], s["seq"]],
          "pod_batch": [s["batch"] // s["pods"], s["seq"]],
          "dcn_budget": s["dcn_budget"], "window": s["window"],
          "steps": stats["step"], "losses": stats["loss"],
          "grad_norms": stats["grad_norm"],
          "fwd_bwd_ms": stats["fwd_bwd_ms"],
          "exchange_ms": stats["exchange_ms"], "opt_ms": stats["opt_ms"],
          "median_step_ms": stats["median_step_ms"],
          "median_pods_fwd_bwd_ms": stats["median_fwd_bwd_ms"],
          "median_exchange_ms": stats["median_exchange_ms"],
          "median_opt_ms": stats["median_opt_ms"],
          "tokens_per_sec": stats["tokens_per_sec"],
          "peak_mem_bytes": stats["peak_mem_bytes"],
          "sync_fraction_per_window": stats["sync_fraction"],
          "replanned_at": stats["replanned_at"],
          "allreduce_bytes_per_step_full_sync": full_bytes,
          "allreduce_bytes_per_step_per_window": [
              f * full_bytes for f in stats["sync_fraction"]],
          "seconds": run_s})
    if len(stats["loss"]) != s["steps"] or not stats["replanned_at"] \
            or not _finite(stats["loss"] + losses + stats["exchange_ms"]):
        raise AssertionError(f"the exchanged driver run: losses "
                             f"{stats['loss']}, replanned at "
                             f"{stats['replanned_at']}")
    del stats
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) two exchanged smoke steps, card against CPU -------------------
    t0 = time.perf_counter()
    cfg, cpu1 = _pod_smoke_run(torch, "cpu", [None])
    tree = cpu1[0]["before"].params
    sizes = stream_sizes(tree, cfg)
    full = full_sync_plan(tree, cfg)
    ctl = EdgeGradController(sizes=sizes,
                             dcn_budget_fraction=s["smoke_budget"],
                             n_pods=s["pods"], window=1)
    ctl.observe({k: cpu1[0][k] for k in ("pod_disagreement",
                                         "pod_magnitude")})
    plan = ctl.replan(full)
    skipped = [k for k, v in plan.sync.items() if not v]
    if not skipped:
        raise AssertionError(f"the controller synced every smoke stream at "
                             f"budget {s['smoke_budget']}: nothing to impute")
    plans = [full, plan]
    # each step from the CPU's state before it on both devices (two f32
    # orders part ways after a step: a sign flip on a near-zero gradient
    # moves a parameter by 2 lr)
    _, cpu = _pod_smoke_run(torch, "cpu", plans)
    starts = [step["before"] for step in cpu]
    _, card = _pod_smoke_run(torch, "cuda", plans, starts=starts)
    rows = []
    for i, (a, b) in enumerate(zip(card, cpu)):
        row = {"step": i + 1, "loss_rel": abs(a["loss"] - b["loss"])
               / abs(b["loss"]),
               "grad_norm_rel": abs(a["grad_norm"] - b["grad_norm"])
               / b["grad_norm"],
               "telemetry_rel": max(
                   float(np.max(np.abs(a[k] - b[k])
                                / np.maximum(np.abs(b[k]), 1e-30)))
                   for k in ("pod_disagreement", "pod_magnitude")),
               "grad_err_over_leaf_max": max(
                   float((x - y).abs().max() / y.abs().max())
                   for x, y in zip(a["grads"], b["grads"])
                   if float(y.abs().max()) > 0),
               "param_max_abs_diff": max(
                   float((x - y).abs().max())
                   for x, y in zip(a["params"], b["params"])),
               "skipped_streams": a["skipped"],
               "skipped_equal_momentum": a["skipped_is_momentum"]}
        row["ok"] = (row["loss_rel"] <= TRAIN["loss_rtol"]
                     and row["grad_norm_rel"] <= TRAIN["gnorm_rtol"]
                     and row["telemetry_rel"] <= 2 * TRAIN["gnorm_rtol"]
                     and row["grad_err_over_leaf_max"] <= TRAIN["grad_limit"]
                     and row["param_max_abs_diff"] <= 2 * TRAIN["smoke_lr"]
                     and a["skipped_is_momentum"] and b["skipped_is_momentum"])
        rows.append(row)
    sent, total = synced_bytes(plan, tree, cfg)
    emit({"phase": "lm_pod_train_card_vs_cpu", "nvidia_smi": card_line,
          "arch": cfg.name, "batch": list(s["smoke_batch"]),
          "pods": s["pods"], "budget": s["smoke_budget"],
          "streams": len(sizes), "skipped": skipped,
          "sync_fraction": plan.fraction_synced(sizes),
          "limits": {"loss_rtol": TRAIN["loss_rtol"],
                     "gnorm_rtol": TRAIN["gnorm_rtol"],
                     "telemetry_rtol": 2 * TRAIN["gnorm_rtol"],
                     "grad_limit": TRAIN["grad_limit"]},
          "rows": rows, "seconds": time.perf_counter() - t0})
    if not all(r["ok"] for r in rows):
        raise AssertionError(f"the exchanged smoke steps, card against CPU: "
                             f"{rows}")

    # ---- (c) the rank route: two gloo ranks share the card ----------------
    world = s["pods"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(_pod_rank,
                                 args=(world, tmp, plans, starts),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > s["timeout_s"]:
                    raise AssertionError(f"the {world} pod ranks did not "
                                         f"finish in {s['timeout_s']} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=30)
        ranks_s = time.perf_counter() - t0
        per_rank = []
        for r in range(world):
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as data:
                got = dict(data)
            same = {f"step{i + 1}/param{j}": np.array_equal(
                        got[f"step{i + 1}/param{j}"], p.numpy())
                    for i, step in enumerate(card)
                    for j, p in enumerate(step["params"])}
            tel = max(float(np.max(np.abs(got[f"step{i + 1}/{k}"]
                                          - step[k])
                                   / np.maximum(np.abs(step[k]), 1e-30)))
                      for i, step in enumerate(card)
                      for k in ("pod_disagreement", "pod_magnitude"))
            per_rank.append({"rank": r, "bitwise_params": all(same.values()),
                             "differs": [k for k, v in same.items()
                                         if not v][:10],
                             "telemetry_rel": tel})
    emit({"phase": "lm_pod_train_ranks", "nvidia_smi": card_line,
          "world": world, "backend": "gloo", "per_rank": per_rank,
          "allreduce_bytes_per_step": {"full_sync": total,
                                       "replanned": sent},
          "ranks_seconds": ranks_s})
    if not all(r["bitwise_params"] and r["telemetry_rel"] <= 1e-6
               for r in per_rank):
        raise AssertionError(f"the rank route against the stacked steps: "
                             f"{per_rank}")

    launches = {"flash_attention": fa_ops.SM90_LAUNCHES,
                "flash_attention_f32": fa_ops.LAUNCHES - fa_ops.SM90_LAUNCHES}
    emit({"phase": "lm_pod_train_path", "nvidia_smi": card_line,
          "launches": launches, "seconds": time.perf_counter() - t_phase})
    if launches != {"flash_attention": 0, "flash_attention_f32": 0}:
        raise AssertionError(f"flash kernel launches in the exchanged "
                             f"training phase {launches}")
    return launches


def _pod_smoke_run(torch, dev: str, plans, rank=None, starts=None):
    """starcoder2 smoke in f32 on ``dev``, one exchanged step a plan
    (None: full sync) on seeded batches of ``POD_TRAIN["smoke_batch"]``:
    stacked over both pods, or (``rank``) as that gloo rank's pod on its
    half of each batch.  The steps run on from the seeded parameters, or
    each from its own state of ``starts`` (host ``TrainState``s), as the
    CPU tests take each step from the reference's state before it.
    Returns (the config, per step: the state before it (host), the loss,
    grad norm and telemetry, the exchanged gradients and the parameters
    after it as CPU tensors, the skipped streams and whether each one's
    gradient is the step's momentum bitwise on ``dev``)."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import (TrainState, adamw_init, cosine_schedule,
                                   full_sync_plan, make_grad_exchange,
                                   make_stacked_exchange, stream_leaves,
                                   tree_leaves, tree_map)
    s = POD_TRAIN
    cfg = dataclasses.replace(get_config(s["arch"], smoke=True),
                              dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(s["seed"]))
    state = adamw_init(tree_map(lambda t: t.to(dev), params))
    rng = np.random.default_rng(s["seed"])
    rows, cols = s["smoke_batch"]
    lr = cosine_schedule(TRAIN["smoke_lr"], 0, 10)

    def moved(st, to):
        # a copy: the step updates the state in place
        return TrainState(**{f: tree_map(
            lambda t: t.detach().to(to, copy=True), getattr(st, f))
            for f in ("params", "m", "v")}, step=st.step)
    out = []
    for i, plan in enumerate(plans):
        if starts is not None:
            state = moved(starts[i], dev)
        before = moved(state, "cpu")
        plan = plan or full_sync_plan(state.params, cfg)
        batch = {"tokens": rng.integers(0, cfg.vocab, (rows, cols)),
                 "labels": rng.integers(0, cfg.vocab, (rows, cols))}
        batch["labels"][0, :5] = -1
        if rank is None:
            ex, n_pods = make_stacked_exchange(plan, cfg=cfg), s["pods"]
        else:
            part = rows // s["pods"]
            batch = {k: v[rank * part:(rank + 1) * part]
                     for k, v in batch.items()}
            ex, n_pods = make_grad_exchange(plan, cfg=cfg), 1
        step = make_train_step(cfg, lr, grad_exchange=ex, n_pods=n_pods)
        loss, metrics, grads = step.loss_and_grads(state, batch)
        g, m = tree_leaves(grads), tree_leaves(state.m)
        skipped = [k for k, v in plan.sync.items() if not v]
        streams = stream_leaves(grads, cfg)
        is_m = all(torch.equal(g[j], m[j]) for k in skipped
                   for j in streams[k])
        host_g = [t.detach().cpu().clone() for t in g]
        state, metrics = step.apply(state, grads, loss, metrics)
        del grads, g
        out.append({"before": before, "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    **{k: metrics[k].cpu().numpy()
                       for k in ("pod_disagreement", "pod_magnitude")},
                    "grads": host_g,
                    "params": [t.detach().cpu().clone()
                               for t in tree_leaves(state.params)],
                    "skipped": skipped, "skipped_is_momentum": is_m})
    return cfg, out


def _pod_rank(rank: int, world: int, tmp: str, plans, starts) -> None:
    """One rank of phase 34 (c) (spawned): its pod's half of the smoke
    batches on the shared card over gloo, each step from its state of
    ``starts``; its parameters and telemetry after each step to
    ``rank<r>.npz``."""
    import datetime
    sys.path.insert(0, os.path.join(HERE, "src"))
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=POD_TRAIN["timeout_s"]))
    try:
        _, steps = _pod_smoke_run(torch, "cuda", plans, rank=rank,
                                  starts=starts)
        arrays = {}
        for i, step in enumerate(steps):
            for j, p in enumerate(step["params"]):
                arrays[f"step{i + 1}/param{j}"] = p.numpy()
            for k in ("pod_disagreement", "pod_magnitude"):
                arrays[f"step{i + 1}/{k}"] = step[k]
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **arrays)
    finally:
        dist.destroy_process_group()


def lm_mesh_path(torch, card_line: str, settings: dict = MESH) -> dict:
    """Phase 35: LM sharding's mesh half (``MESH``).  The unsplit gemma3
    prefills run here first (f32, then bf16), then two ranks are spawned
    once for the three sharded runs (:func:`_mesh_rank`).  Every check
    raises.  Returns row 4's launches summed over the ranks (the f32 flash
    kernel's asserted 0)."""
    import dataclasses
    import gc
    import pickle
    import tempfile

    import torch.multiprocessing as mp
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer

    t_phase = time.perf_counter()
    s = settings
    dev_type = "cuda" if torch.cuda.is_available() else "cpu"
    n_dev = torch.cuda.device_count() if dev_type == "cuda" else 0
    backend = "nccl" if n_dev >= s["world"] else "gloo"
    smoke = s["smoke"]

    # ---- the unsplit gemma3 prefills: the f32 yardstick and bf16 ----------
    gc.collect()
    if dev_type == "cuda":
        torch.cuda.empty_cache()
    cfg16 = get_config(s["prefill_arch"], smoke=smoke)
    tokens = _mesh_tokens(cfg16, s)
    unsplit = {}
    t0 = time.perf_counter()
    for dt in ("float32", "bfloat16"):
        # the f32 yardstick on the plain route, bf16 on row 4 as the ranks
        model = Transformer(dataclasses.replace(cfg16, dtype=dt),
                            device=dev_type, seed=s["seed"],
                            use_kernel=dt == "bfloat16")
        with torch.no_grad():
            logits, _ = model.prefill({"tokens": tokens}, tokens.shape[1])
        unsplit[dt] = logits[:, -1].float().cpu()
        del model, logits
        gc.collect()
        if dev_type == "cuda":
            torch.cuda.empty_cache()
    unsplit_s = time.perf_counter() - t0

    # ---- the ranks ----------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(_mesh_rank,
                                 args=(s["world"], tmp, backend, s,
                                       card_line),
                                 nprocs=s["world"], join=False,
                                 start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > s["timeout_s"]:
                    raise AssertionError(f"the mesh ranks did not finish in "
                                         f"{s['timeout_s']} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=30)
        ranks_s = time.perf_counter() - t0
        ranks = []
        for r in range(s["world"]):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))

    # ---- (a) tensor-parallel training --------------------------------------
    tr = [r["train"] for r in ranks]
    held = tr[0]["held"]
    limits = {"loss_rel": s["f64_limit"], "grad_norm_rel": s["f64_limit"],
              "grad_err_over_leaf_max": s["f64_limit"]}
    emit({"phase": "lm_mesh_train", "nvidia_smi": card_line,
          "backend": backend, "arch": tr[0]["arch"],
          "layers": tr[0]["layers"], "params": tr[0]["params"],
          "mesh": tr[0]["mesh"], "batch": list(s["batch"]),
          "losses": tr[0]["losses"], "grad_norms": tr[0]["grad_norms"],
          "held_layers": tr[0]["held_layers"], "held_first_step_f64": held[
              "f64"], "limits_f64": limits, "first_step_f32_spread": held[
              "f32"],
          "per_rank": [{"rank": i, "step_ms": t["step_ms"],
                        "median_step_ms": t["median_step_ms"],
                        "tokens_per_sec": t["tokens_per_sec"],
                        "peak_mem_bytes": t["peak_mem_bytes"],
                        "flash_launches": t["flash_launches"],
                        "held_seconds": {k: v["seconds"]
                                         for k, v in t["held"].items()}}
                       for i, t in enumerate(tr)]})
    ok = (all(held["f64"][k] <= lim for k, lim in limits.items())
          and all(_finite(t["losses"] + t["grad_norms"]) for t in tr)
          and len(tr[0]["losses"]) == s["steps"]
          and all(t["flash_launches"] == 0 for t in tr))
    if not ok:
        raise AssertionError(f"the tensor-parallel step against the unsplit "
                             f"one: {held}, losses {tr[0]['losses']}")

    # ---- (b) FSDP and the grouped dispatch ----------------------------------
    moe = [r["moe"] for r in ranks]
    rows = _mesh_route_check(torch, moe, s)
    emit({"phase": "lm_mesh_moe", "nvidia_smi": card_line,
          "backend": backend, "arch": moe[0]["arch"],
          "layers": moe[0]["layers"], "params": moe[0]["params"],
          "mesh": moe[0]["mesh"], "groups": moe[0]["groups"],
          "tokens_per_group": moe[0]["tokens_per_group"],
          "loss": moe[0]["loss"], "grad_norm": moe[0]["grad_norm"],
          "moe_lb": moe[0]["moe_lb"], "moe_z": moe[0]["moe_z"],
          "per_layer": rows,
          "per_rank": [{"rank": i, "step_ms": m["step_ms"],
                        "peak_mem_bytes": m["peak_mem_bytes"]}
                       for i, m in enumerate(moe)]})
    if not (all(r["routes_equal_or_near_tie"] for r in rows)
            and _finite([moe[0]["loss"], moe[0]["grad_norm"]])):
        raise AssertionError(f"the data-parallel MoE step's routes against "
                             f"the one-process grouped dispatch: {rows}")

    # ---- (c) the tensor-parallel prefill -----------------------------------
    pre = [r["prefill"] for r in ranks]
    tp = torch.from_numpy(pre[0]["last_logits"])
    f32, u16 = unsplit["float32"], unsplit["bfloat16"]
    d_tp, d_u = _rms(tp - f32), _rms(u16 - f32)
    launches = [p["sm90_launches"] for p in pre]
    n_layers = cfg16.n_layers
    emit({"phase": "lm_mesh_prefill", "nvidia_smi": card_line,
          "backend": backend, "arch": cfg16.name, "layers": n_layers,
          "batch": list(tokens.shape), "mesh": pre[0]["mesh"],
          "local_heads": pre[0]["local_heads"],
          "rms_tp_minus_f32": d_tp, "rms_unsplit_minus_f32": d_u,
          "rms_f32": _rms(f32), "ratio": d_tp / d_u,
          "limit": LM["kernel_over_plain"],
          "argmax_agree_tp_unsplit": float(
              (tp.argmax(-1) == u16.argmax(-1)).float().mean()),
          "row4_launches_per_rank": launches,
          "f32_launches_per_rank": [p["f32_launches"] for p in pre],
          "prefill_ms_per_rank": [p["prefill_ms"] for p in pre],
          "row4_check": pre[0]["row4"]})
    if not (d_tp <= LM["kernel_over_plain"] * d_u
            and launches == [n_layers] * s["world"]
            and all(p["f32_launches"] == 0 for p in pre)):
        raise AssertionError(f"the tensor-parallel prefill: distance from "
                             f"f32 {d_tp} against the unsplit {d_u}, row 4 "
                             f"launches {launches}")
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "lm_mesh_path", "nvidia_smi": card_line,
          "backend": backend, "world": s["world"], "devices": n_dev,
          "unsplit_prefills_seconds": unsplit_s, "ranks_seconds": ranks_s,
          "rank_seconds": [{k: r[k]["seconds"]
                            for k in ("train", "moe", "prefill")}
                           for r in ranks],
          "seconds": phase_s})
    return {"flash_attention": sum(launches),
            "flash_attention_f32": sum(p["f32_launches"] for p in pre)}


def _mesh_tokens(cfg, s: dict):
    import numpy as np
    rows, cols = (2, 24) if s["smoke"] else s["batch"]
    return np.random.default_rng(s["seed"]).integers(0, cfg.vocab,
                                                     (rows, cols))


def _mesh_rank(rank: int, world: int, tmp: str, backend: str, s: dict,
               card_line: str) -> None:
    """One rank of phase 35 (spawned): the three sharded runs in turn, its
    results to ``rank<r>.pkl``."""
    import datetime
    import pickle
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch
    import torch.distributed as dist
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{tmp}/rendezvous", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=s["timeout_s"]))
    try:
        out = {}
        for name, run in (("train", lambda: _mesh_train(torch, s)),
                          ("moe", lambda: _mesh_moe(torch, s)),
                          ("prefill",
                           lambda: _mesh_prefill(torch, s, card_line))):
            t0 = time.perf_counter()
            out[name] = run()
            out[name]["seconds"] = time.perf_counter() - t0
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _mesh_dev(torch):
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _mesh_sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mesh_batch(cfg, s: dict, step: int) -> dict:
    import numpy as np
    rows, cols = (2, 24) if s["smoke"] else s["batch"]
    rng = np.random.default_rng(s["seed"] + 1 + step)
    batch = {"tokens": rng.integers(0, cfg.vocab, (rows, cols)),
             "labels": rng.integers(0, cfg.vocab, (rows, cols))}
    batch["labels"][0, :5] = -1
    return batch


def _widened():
    """``scripts/lm_grad_probe.py``'s ``widened(True)``: every f32 of the
    port's LM stack read as f64 inside."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "lm_grad_probe", os.path.join(HERE, "scripts", "lm_grad_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return probe.widened(True)


def _mesh_train(torch, s: dict) -> dict:
    """(a): starcoder2-3b under model = 2.  The first step at
    ``held_layers`` layers against the unsplit one in f64 (held) and in
    f32 (printed; :func:`_mesh_held_step`), then ``steps`` timed f32
    steps at ``train_layers``."""
    import dataclasses
    import gc
    import statistics

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import make_train_step
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.parallel.sharding import lm_shards, mesh_context
    dev = _mesh_dev(torch)
    full = get_config(s["train_arch"], smoke=s["smoke"])
    cfg = dataclasses.replace(full, dtype="float32",
                              n_layers=full.n_layers if s["smoke"]
                              else s["train_layers"])
    mesh = make_local_mesh(model_parallel=s["world"])
    lr = cosine_schedule(s["lr"], 0, 10)

    # ---- the held first step: f64, then f32 -------------------------------
    held_cfg = dataclasses.replace(cfg, n_layers=s["held_layers"])
    held = {}
    for prec in ("f64", "f32"):
        t0 = time.perf_counter()
        with (_widened() if prec == "f64" else contextlib.nullcontext()):
            held[prec] = _mesh_held_step(torch, held_cfg, mesh, s, lr, dev)
        held[prec]["seconds"] = time.perf_counter() - t0

    # ---- the timed steps, in f32 -----------------------------------------
    shards = lm_shards(cfg, mesh)
    state = adamw_init(_mesh_params(torch, cfg, s, dev, shards))
    step_fn = make_train_step(cfg, lr)
    fa_ops.LAUNCHES = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, gnorms, step_ms = [], [], []
    with mesh_context(mesh):
        for i in range(s["steps"]):
            batch = _mesh_batch_on(torch, cfg, s, i, dev)
            _mesh_sync(torch, dev)
            t_a = time.perf_counter()
            state, metrics = step_fn(state, batch)
            _mesh_sync(torch, dev)
            step_ms.append(1e3 * (time.perf_counter() - t_a))
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["grad_norm"]))
    med = statistics.median(step_ms)
    rows, cols = (2, 24) if s["smoke"] else s["batch"]
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "params": cfg.param_count(), "mesh": mesh.shape,
           "losses": losses, "grad_norms": gnorms, "step_ms": step_ms,
           "median_step_ms": med, "tokens_per_sec": rows * cols / med * 1e3,
           "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
           "flash_launches": fa_ops.LAUNCHES, "held_layers": held_cfg.n_layers,
           "held": held}
    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _mesh_params(torch, cfg, s: dict, dev, shards=None):
    """The seeded parameters, whole or (``shards``) this rank's."""
    from repro_torch.models import init_params
    gen = torch.Generator(device=dev).manual_seed(s["seed"])
    place = None if shards is None else (
        lambda path, t: shards.at(path).shard(t))
    return init_params(cfg, gen, device=dev, place=place)


def _mesh_batch_on(torch, cfg, s: dict, step: int, dev) -> dict:
    return {k: torch.as_tensor(v).to(dev)
            for k, v in _mesh_batch(cfg, s, step).items()}


def _mesh_held_step(torch, cfg, mesh, s: dict, lr, dev) -> dict:
    """One step's loss and gradients from the seeded state on batch 0,
    unsplit and then split, on every rank; each rank holds its gradient
    shards against its slices of the unsplit gradients, and every rank
    gets all the ranks' errors: the loss's, the grad norm's and each
    leaf's largest over the whole leaf's largest, the worst first."""
    import gc

    import torch.distributed as dist
    from repro_torch.launch import make_train_step
    from repro_torch.models.transformer import forward_train
    from repro_torch.optim import TrainState, global_norm, tree_leaves
    from repro_torch.parallel.sharding import (leaf_paths, lm_shards,
                                               mesh_context)
    batch = _mesh_batch_on(torch, cfg, s, 0, dev)
    params = _mesh_params(torch, cfg, s, dev)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = forward_train(params, batch, cfg)
    want = list(torch.autograd.grad(loss, leaves))
    want_loss, want_norm = float(loss.detach()), float(global_norm(want))
    del params, leaves, loss
    gc.collect()
    shards = lm_shards(cfg, mesh)
    # parameters only: this step's moments are not taken
    state = TrainState(params=_mesh_params(torch, cfg, s, dev, shards),
                       m={}, v={}, step=0)
    with mesh_context(mesh):
        loss, _, grads = make_train_step(cfg, lr).loss_and_grads(state,
                                                                 batch)
        gnorm = float(global_norm(grads, shards))
    errs = []
    for (path, _), g, w in zip(leaf_paths(state.params), tree_leaves(grads),
                               want):
        scale = float(w.abs().max())
        d = float((g - shards.at(path).shard(w)).abs().max())
        errs.append((d / scale if scale > 0 else d, path))
    del state, grads, want
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, errs)
    errs = sorted((e for r in every for e in r), reverse=True)
    return {"loss_rel": abs(float(loss) - want_loss) / abs(want_loss),
            "grad_norm_rel": abs(gnorm - want_norm) / want_norm,
            "grad_err_over_leaf_max": errs[0][0],
            "leaves": len(errs) // len(every),
            "worst_leaves": errs[:4], "want_loss": want_loss,
            "want_grad_norm": want_norm}


def _mesh_moe(torch, s: dict) -> dict:
    """(b): qwen3-moe under data = 2, one step; each layer's first
    ``moe_apply`` (the forward's; the backward recomputes it) recorded:
    its input rows on this rank, the gathered router, the routes and the
    capacity."""
    import dataclasses
    import gc

    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import make_train_step
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import init_params
    from repro_torch.models import layers as lm_layers
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.parallel.sharding import lm_shards, mesh_context
    dev = _mesh_dev(torch)
    cfg = get_config(s["moe_arch"], smoke=s["smoke"])
    if not s["smoke"]:
        cfg = dataclasses.replace(cfg, n_layers=s["moe_layers"])
    mesh = make_local_mesh()
    shards = lm_shards(cfg, mesh)
    gen = torch.Generator(device=dev).manual_seed(s["seed"])
    state = adamw_init(init_params(
        cfg, gen, device=dev, place=lambda path, t: shards.at(path).shard(t)))
    step_fn = make_train_step(cfg, cosine_schedule(s["lr"], 0, 10),
                              cast_params_bf16=True)
    batch = shards.local_batch(_mesh_batch(cfg, s, 0))
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    calls = []
    apply, router, dispatch = (lm_layers.moe_apply, lm_layers.moe_router,
                               lm_layers.moe_dispatch)

    def spy_apply(params, x, m):
        if len(calls) < cfg.n_layers:
            calls.append({"x": x.detach().float().cpu().numpy()})
        return apply(params, x, m)

    def spy_router(r, xt, k):
        out = router(r, xt, k)
        if len(calls) <= cfg.n_layers and "router" not in calls[-1]:
            calls[-1]["router"] = r.detach().float().cpu().numpy()
            calls[-1]["topi"] = out[3].cpu().numpy()
        return out

    def spy_dispatch(topi, cap):
        out = dispatch(topi, cap)
        if len(calls) <= cfg.n_layers and "rank_c" not in calls[-1]:
            calls[-1]["rank_c"] = out[2].cpu().numpy()
            calls[-1]["sort_idx"] = out[0].cpu().numpy()
            calls[-1]["cap"] = cap
        return out
    lm_layers.moe_apply, lm_layers.moe_router, lm_layers.moe_dispatch = (
        spy_apply, spy_router, spy_dispatch)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        with mesh_context(mesh):
            _mesh_sync(torch, dev)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            _mesh_sync(torch, dev)
            ms = 1e3 * (time.perf_counter() - t0)
    finally:
        lm_layers.moe_apply, lm_layers.moe_router, lm_layers.moe_dispatch = (
            apply, router, dispatch)
    t_local = batch["tokens"].numel()
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "params": cfg.param_count(), "mesh": mesh.shape,
           "groups": mesh.size("data"), "tokens_per_group": t_local,
           "loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]),
           "moe_lb": float(metrics["moe_lb"]),
           "moe_z": float(metrics["moe_z"]), "step_ms": ms,
           "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
           "calls": calls, "top_k": cfg.moe.top_k}
    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def _mesh_route_check(torch, moe: list, s: dict) -> list:
    """Each layer's routes on the data ranks against the one-process
    grouped dispatch (``moe_apply``'s router and dispatch under
    ``dispatch_groups(2)``) on the ranks' own inputs, concatenated in
    rank order.  The router's product is taken a group at a time, at the
    ranks' shape, so that both sides run the same GEMM (a token's gates
    do not depend on the others')."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import layers as lm_layers
    cfg = get_config(s["moe_arch"], smoke=s["smoke"])
    m, k = cfg.moe, cfg.moe.top_k
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    groups = len(moe)
    rows = []
    for layer in range(moe[0]["layers"]):
        per = [r["calls"][layer] for r in moe]
        x = np.concatenate([c["x"].reshape(-1, c["x"].shape[-1])
                            for c in per])
        router = torch.as_tensor(per[0]["router"], device=dev)
        xt = torch.as_tensor(x, device=dev).to(cfg.activation_dtype)
        tg = xt.shape[0] // groups
        routed = [lm_layers.moe_router(router, xt[g * tg:(g + 1) * tg], k)
                  for g in range(groups)]
        probs = torch.cat([r[1] for r in routed])
        topi = torch.cat([r[3] for r in routed])
        cap = lm_layers.moe_capacity(tg, m)
        equal, near, drops = True, True, []
        p_sorted = torch.sort(probs, dim=-1, descending=True).values
        gap = ((p_sorted[:, k - 1] - p_sorted[:, k])
               / p_sorted[:, k - 1]).cpu().numpy()
        for g, c in enumerate(per):
            ti = topi[g * tg:(g + 1) * tg]
            sort_idx, _, rank_c = lm_layers.moe_dispatch(ti, cap)
            same = (np.array_equal(ti.cpu().numpy(), c["topi"])
                    and np.array_equal(sort_idx.cpu().numpy(), c["sort_idx"])
                    and np.array_equal(rank_c.cpu().numpy(), c["rank_c"])
                    and c["cap"] == cap)
            if not same:
                differ = np.any(ti.cpu().numpy() != c["topi"], axis=1)
                near = near and bool(
                    (gap[g * tg:(g + 1) * tg][differ] <= s["near_tie"]).all())
            equal = equal and same
            drops.append(int((c["rank_c"] == c["cap"]).sum()))
        rows.append({"layer": layer, "tokens_per_group": tg, "capacity": cap,
                     "routes_bitwise": equal,
                     "routes_equal_or_near_tie": equal or near,
                     "dropped_entries_per_group": drops})
    return rows


def _mesh_prefill(torch, s: dict, card_line: str) -> dict:
    """(c): gemma3-12b's bf16 prefill under model = 2; rank 0 holds row 4
    against its plain version on one layer's local q, k, v."""
    import gc

    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import make_prefill
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import Transformer
    from repro_torch.models import layers as lm_layers
    dev = _mesh_dev(torch)
    rank = dist.get_rank()
    cfg = get_config(s["prefill_arch"], smoke=s["smoke"])
    mesh = make_local_mesh(model_parallel=s["world"])
    model = Transformer(cfg, device=dev, seed=s["seed"], mesh=mesh)
    tokens = _mesh_tokens(cfg, s)
    prefill = make_prefill(cfg, tokens.shape[1])
    captured = {}

    def capture(i, q, k, v, kw, out):
        if i == s["prefill_layer"]:
            captured["qkv"] = (q, k, v, kw)
    fa_ops.LAUNCHES = fa_ops.SM90_LAUNCHES = 0
    _mesh_sync(torch, dev)
    t0 = time.perf_counter()
    with torch.no_grad(), _attention_spy(lm_layers, capture):
        logits, cache = prefill(model, {"tokens": tokens})
    _mesh_sync(torch, dev)
    ms = 1e3 * (time.perf_counter() - t0)
    sm90 = fa_ops.SM90_LAUNCHES
    f32 = fa_ops.LAUNCHES - sm90
    row4 = None
    if rank == 0 and dev.type == "cuda":
        q, k, v, kw = captured["qkv"]
        err, line = row4_check_and_time(torch, q, k, v, kw,
                                        "lm_mesh_prefill_rank0", card_line)
        row4 = {"shape": list(q.shape), "kv_shape": list(k.shape),
                "max_abs_err": err, **line}
    out = {"mesh": mesh.shape, "last_logits": logits[:, -1].float().cpu()
           .numpy(), "sm90_launches": sm90, "f32_launches": f32,
           "prefill_ms": ms, "row4": row4,
           "local_heads": [int(model.layers[0].mixer["wq"].shape[1]),
                           int(cache["layers"][0]["k"].shape[2])]}
    del model, cache, captured
    gc.collect()
    return out


def _update_sample(params, grads, n: int = 4096) -> list:
    """About ``n`` evenly spaced elements of every parameter leaf and of
    its gradient, before the update (the update scales the gradients in
    place): (index, params, grads) a leaf."""
    import torch
    from repro_torch.optim import tree_leaves
    out = []
    for p, g in zip(tree_leaves(params), tree_leaves(grads)):
        idx = torch.arange(0, p.numel(), max(1, p.numel() // n),
                           device=p.device)
        out.append((idx, p.detach().reshape(-1)[idx].clone(),
                    g.reshape(-1)[idx].float()))
    return out


def _check_first_update(before, params, grad_norm, lr: float,
                        b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                        clip_norm=1.0) -> dict:
    """Every leaf's sampled elements after the first AdamW step against
    that step recomputed from the sample (``_update_sample``): the clip
    scale from the step's grad norm, zero moments, the bias corrections
    of step 1, the decoupled decay, the same f32 operations as
    ``optim.adamw_update``; within 2 f32 steps of the parameter, and some
    leaf moving by more.  A step that left a leaf as it was, or gave it
    another leaf's gradient, or none, misses by up to ~lr an element (the
    decay alone moves one by ``lr * weight_decay`` of itself, ~80 f32
    steps at lr 1e-4)."""
    import numpy as np
    import torch
    from repro_torch.optim import tree_leaves
    scale = torch.clamp(clip_norm / torch.clamp(grad_norm, min=1e-9),
                        max=1.0)
    bc1 = float(np.float32(1.0) - np.float32(b1))
    bc2 = float(np.float32(1.0) - np.float32(b2))
    lr = float(np.float32(lr))
    worst, moved, leaves = 0.0, 0, 0
    for (idx, p0, g), p in zip(before, tree_leaves(params)):
        g = g * scale
        m = torch.zeros_like(g).mul_(b1).add_(g, alpha=1 - b1)
        v = torch.zeros_like(g).mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = torch.div(m, bc1).div_(torch.div(v, bc2).sqrt_().add_(eps))
        want = p0 - delta.add_(p0, alpha=weight_decay).mul_(lr)
        got = p.detach().reshape(-1)[idx]
        ulp = torch.finfo(torch.float32).eps * torch.maximum(p0.abs(),
                                                             want.abs())
        worst = max(worst, float(((got - want).abs() / (2 * ulp)
                                  .clamp(min=1e-45)).max()))
        moved += bool(((want - p0).abs() > 2 * ulp).any())
        leaves += 1
    return {"leaves": leaves, "leaves_that_move": moved,
            "worst_err_over_2_f32_steps": worst,
            "ok": worst <= 1.0 and moved > 0}


def profile_train_step(step, state, batch, torch, card_line: str,
                       out_name: str = "profile_train.txt"):
    """One train step under torch.profiler (table in chiprun_out/<out_name>):
    its wall ms (inflated by the profiler: compare the device time with
    the driver's unprofiled step ms), the device time of its kernels and
    their launches, each half's (``train_step/grads``: forward,
    recomputation and backward; ``train_step/update``: AdamW) wall ms and
    span on the device, and the ten largest kernels.  Returns the step's
    (state, metrics)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function("train_step/grads"):
            loss, metrics, grads = step.loss_and_grads(state, batch)
            torch.cuda.synchronize()
        with record_function("train_step/update"):
            state, metrics = step.apply(state, grads, loss, metrics)
            del grads
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = prof.key_averages()
    with open(os.path.join(OUT_DIR, out_name), "w") as f:
        f.write(f"== one train step ({card_line})\n")
        f.write(evs.table(sort_by="self_device_time_total"
                          if hasattr(evs[0], "self_device_time_total")
                          else "self_cuda_time_total", row_limit=40))
    on_dev = [e for e in evs if str(e.device_type).endswith("CUDA")]
    # a range shows twice: on the host (its wall time) and as an
    # annotation on the device timeline (its span there, not a kernel)
    kernels = [e for e in on_dev if not e.key.startswith(("Memcpy",
                                                          "train_step/"))]
    dev = sum(_dev_ms(e) for e in kernels)
    halves = {}
    for e in evs:
        if e.key.startswith("train_step/"):
            side = ("device_span_ms" if str(e.device_type).endswith("CUDA")
                    else "wall_ms")
            ms = _dev_ms(e) if side == "device_span_ms" \
                else e.cpu_time_total / 1e3
            halves.setdefault(e.key.split("/", 1)[1], {})[side] = ms
    top = sorted(kernels, key=lambda e: -_dev_ms(e))[:10]
    emit({"phase": "profile_train", "file": out_name, "nvidia_smi": card_line,
          "batch": list(batch["tokens"].shape), "profiled_wall_ms": wall,
          "kernel_device_ms": dev, "kernel_launches":
              sum(e.count for e in kernels), "halves": halves,
          "top": [{"name": e.key[:70], "count": e.count, "ms": _dev_ms(e)}
                  for e in top]})
    return state, metrics


def profile_lm(model, batch, max_seq: int, torch, card_line: str,
               n_decode: int = 3, out_name: str = "profile_lm.txt") -> None:
    """Where a prefill batch and a decode step spend their time: one
    prefill of ``batch`` and ``n_decode`` decode steps under torch.profiler
    (tables in chiprun_out/<out_name>), each with its wall ms, the device
    time of its kernels and their ten largest."""
    from torch.profiler import ProfilerActivity, profile
    tokens = batch["tokens"]
    rows = {}
    with open(os.path.join(OUT_DIR, out_name), "w") as f:
        for name in ("prefill", "decode"):
            cache = None
            if name == "decode":
                _, cache = model.prefill(batch, max_seq)
                torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if name == "prefill":
                    model.prefill(batch, max_seq)
                else:
                    for i in range(n_decode):
                        model.decode_step(cache, tokens[:, i:i + 1])
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            evs = prof.key_averages()
            f.write(f"== {name} ({card_line})\n")
            f.write(evs.table(sort_by="self_device_time_total"
                              if hasattr(evs[0], "self_device_time_total")
                              else "self_cuda_time_total", row_limit=40))
            kernels = [e for e in evs if str(e.device_type).endswith("CUDA")
                       and not e.key.startswith("Memcpy")]
            dev = sum(_dev_ms(e) for e in kernels)
            calls = 1 if name == "prefill" else n_decode
            top = sorted(kernels, key=lambda e: -_dev_ms(e))[:10]
            rows[name] = {"wall_ms": wall / calls, "device_ms": dev / calls,
                          "busy_share": dev / wall,
                          "kernel_launches": sum(e.count for e in kernels)
                          // calls,
                          "top": [{"name": e.key[:70], "count": e.count,
                                   "ms": _dev_ms(e) / calls} for e in top]}
            del cache
    emit({"phase": "profile_lm", "file": out_name, "nvidia_smi": card_line,
          "batch": list(tokens.shape), **rows})


@contextlib.contextmanager
def _attention_spy(layers_mod, on_call):
    """Route the LM layers' flash-attention calls through the kernel and
    then ``on_call(i, q, k, v, kwargs, out)``, i counting the calls."""
    kernel_fn = layers_mod.flash_attention
    calls = [0]

    def spy(q, k, v, **kw):
        out = kernel_fn(q, k, v, **kw)
        on_call(calls[0], q, k, v, kw, out)
        calls[0] += 1
        return out
    layers_mod.flash_attention = spy
    try:
        yield
    finally:
        layers_mod.flash_attention = kernel_fn


def scenario_dict(name: str, **change) -> dict:
    with open(os.path.join(HERE, f"tests/goldens/scenarios/{name}.json")) as f:
        return dict(json.load(f)["scenario"], **change)


def single_edge_phases(torch, dev) -> None:
    """Phases 9-11: the single-edge goldens, one edge gateway at full
    width, and fleet_scan under the mean and multi families.  Every check
    raises."""
    import numpy as np
    from repro_torch.api.experiment import Experiment
    from repro_torch.api.scenario import ScenarioConfig
    from repro_torch.core.stats import rank_transform
    from repro_torch.kernels.polyfit import ops as poly_ops
    from repro_torch.kernels.polyfit.ref import polyfit_ref
    from repro_torch.kernels.stream_stats import ops as ss_ops
    from repro_torch.kernels.stream_stats.ref import fleet_stats_ref
    from repro_torch.runtime.step import sample_fleet

    def counted(run):
        ss_ops.LAUNCHES = 0
        poly_ops.LAUNCHES = 0
        out = run()
        torch.cuda.synchronize()
        return out, {"stream_stats_fleet": ss_ops.LAUNCHES,
                     "polyfit": poly_ops.LAUNCHES}

    def same_samples(seed, windows):
        """The one-site sampler on the card against the same code on the
        CPU, every window, bitwise (stream i keeps (i + 1) N / (k + 1)
        tuples)."""
        k_, n_ = windows[0].k, windows[0].n_max
        nr = ((np.arange(k_) + 1) * n_ // (k_ + 1))[None].astype(np.int32)
        for wid, w in enumerate(windows):
            v = np.ascontiguousarray(w.values[None])
            on_card = sample_fleet(seed, wid, torch.as_tensor(v, device=dev),
                                   torch.as_tensor(nr, device=dev)).cpu()
            on_cpu = sample_fleet(seed, wid, torch.as_tensor(v),
                                  torch.as_tensor(nr))
            if not torch.equal(on_card.view(torch.int32),
                               on_cpu.view(torch.int32)):
                raise AssertionError(f"one-site samples of window {wid} "
                                     f"differ between the card and the CPU")
        return len(windows)

    # ---- 9. the single-edge goldens, payload replay -----------------------
    t0 = time.perf_counter()
    for name, want in SINGLE_REF_WAN_BYTES.items():
        sc = ScenarioConfig.from_dict(scenario_dict(name))
        for uk in (True, False):
            ex = Experiment.from_scenario(sc, use_kernel=uk,
                                          collect="payloads", device="cuda")
            windows = ex.make_windows()
            rep, launches = counted(lambda: ex.run(windows))
            T = len(windows)
            expect = ({"stream_stats_fleet": 2 * T, "polyfit": T} if uk
                      else {"stream_stats_fleet": 0, "polyfit": 0})
            n_same = same_samples(sc.planner.seed, windows)
            emit({"phase": "golden_single_scan", "scenario": name,
                  "use_kernel": uk, "windows": T, "wan_bytes": rep.wan_bytes,
                  "reference_wan_bytes_cpu": want, "nrmse": rep.nrmse,
                  "launches": launches, "launches_expected": expect,
                  "sample_sets_equal_cpu": n_same})
            if rep.wan_bytes != want or launches != expect:
                raise AssertionError(f"{name} use_kernel={uk}: WAN bytes "
                                     f"{rep.wan_bytes} (want {want}), "
                                     f"launches {launches} (want {expect})")
    emit({"phase": "golden_single_scan_seconds",
          "seconds": time.perf_counter() - t0})

    # ---- 10. one edge gateway at full width -------------------------------
    t0 = time.perf_counter()
    k, N = SINGLE["k"], SINGLE["window"]
    d = scenario_dict("single_scan_steps", runtime="scan",
                      queries=["AVG", "VAR", "MIN", "MAX"])
    d["data"] = dict(d["data"], n_points=SINGLE["pool"] * N,
                     window=N, options={"k": k})
    sc = ScenarioConfig.from_dict(d)
    ex = Experiment.from_scenario(sc, use_kernel=True, collect="estimates",
                                  device="cuda")
    windows = ex.make_windows()
    ex.run(windows, n_windows=2)                 # warm-up
    T = SINGLE["T"]
    torch.cuda.reset_peak_memory_stats()
    rep, launches = counted(lambda: ex.run(windows, n_windows=T))
    n_same = same_samples(sc.planner.seed, windows)
    emit({"phase": "single_edge_path", "dataset": "turbine", "k": k, "N": N,
          "T": T, "windows_per_sec": rep.raw["windows_per_sec"],
          "scan_seconds": rep.raw["scan_seconds"], "nrmse": rep.nrmse,
          "wan_bytes": rep.wan_bytes, "full_bytes": rep.full_bytes,
          "wan_fraction": rep.wan_fraction, "launches": launches,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "sample_sets_equal_cpu": n_same})
    if launches != {"stream_stats_fleet": 2 * T, "polyfit": T}:
        raise AssertionError(f"kernel launches on the single-edge path: "
                             f"{launches}, want stream_stats_fleet {2 * T},"
                             f" polyfit {T}")
    if (not all(np.isfinite(v) for v in rep.nrmse.values())
            or not 0 < rep.wan_bytes < rep.full_bytes):
        raise AssertionError(f"single-edge output out of range: nrmse "
                             f"{rep.nrmse}, wan {rep.wan_bytes} of "
                             f"{rep.full_bytes}")
    for q in rep.nrmse_per_stream.values():
        if q.shape != (k,) or not np.isfinite(q).all():
            raise AssertionError("single-edge per-stream NRMSE malformed")
    profile_main_path(ex, windows, torch, out_name="profile_single_edge.txt")

    T2 = SINGLE["T_plain"]
    rk = Experiment.from_scenario(sc, use_kernel=True, collect="estimates",
                                  device="cuda").run(windows, n_windows=T2)
    rp = Experiment.from_scenario(sc, use_kernel=False, collect="estimates",
                                  device="cuda").run(windows, n_windows=T2)
    d_avg = abs(rk.nrmse["AVG"] - rp.nrmse["AVG"]) / abs(rp.nrmse["AVG"])
    emit({"phase": "single_edge_plain_vs_kernel", "T": T2,
          "nrmse_kernel": rk.nrmse, "nrmse_plain": rp.nrmse,
          "wan_kernel": rk.wan_bytes, "wan_plain": rp.wan_bytes,
          "avg_rel_diff": d_avg,
          "windows_per_sec_kernel": rk.raw["windows_per_sec"],
          "windows_per_sec_plain": rp.raw["windows_per_sec"]})
    if rk.wan_bytes != rp.wan_bytes or d_avg > 0.01:
        raise AssertionError(f"single edge: kernel and plain paths disagree:"
                             f" WAN {rk.wan_bytes} against {rp.wan_bytes}, "
                             f"AVG NRMSE rel {d_avg}")

    # both kernels at E = 1 against their plain versions, and timed: this
    # path's window and single_scan's, on the scenarios' own data
    small = ScenarioConfig.from_dict(scenario_dict("single_scan"))
    small_w = Experiment.from_scenario(small, device="cuda").make_windows()
    for label, w in (("single_edge_path", windows[0]),
                     ("single_scan", small_w[0])):
        x = torch.as_tensor(np.ascontiguousarray(w.values[None]),
                            device=dev)
        e_, k_, n_ = x.shape
        counts = torch.full((1, k_), n_, dtype=torch.int32, device=dev)
        ranks = rank_transform(x, counts).contiguous()
        for inp_label, inp in (("values", x), ("ranks", ranks)):
            got = ss_ops.stream_stats_fleet_cuda(inp)
            torch.cuda.synchronize()
            mom, xxt = fleet_stats_ref(inp)
            err = float((got[1] - xxt).abs().max())
            ok = torch.equal(got[0], mom) and torch.equal(got[1], xxt)
            emit({"phase": "kernel_check", "kernel": "stream_stats_fleet",
                  "case": f"{label}/{inp_label}", "shape": list(inp.shape),
                  "max_abs_err": err, "bitwise": [True, True],
                  "rtol": 0.0, "atol": 0.0, "ok": ok})
            if not ok:
                raise AssertionError(f"stream_stats_fleet disagrees with its "
                                     f"plain version at {label}/{inp_label}")
        fleet_kernel_time(
            torch, "stream_stats_fleet", label, list(x.shape),
            lambda: ss_ops.stream_stats_fleet_cuda(x),
            lambda: fleet_stats_ref(x), "stream_stats_fleet_kernel",
            x.numel() * 4 + e_ * k_ * (4 + k_) * 4,
            e_ * (2 * k_ * k_ * n_ + 7 * k_ * n_), 50,
            note="no single PyTorch call computes it: torch.bmm gives only "
                 "the Gram part")
        # polyfit's rows as the fused fit feeds them: (y, u) with u a
        # standardized predictor stream (full windows: w = 1)
        y = x[0]
        xp = torch.roll(y, 1, dims=0)
        u = ((xp - xp.mean(-1, keepdim=True))
             / xp.std(-1, keepdim=True)).contiguous()
        got = poly_ops.polyfit_cuda(y, u)
        torch.cuda.synchronize()
        want = polyfit_ref(y, u)
        want[0][:, 0] = float(n_)
        ok = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        emit({"phase": "kernel_check", "kernel": "polyfit", "case": label,
              "shape": list(y.shape), "bitwise": [True, True],
              "max_abs_err": max(float((g - w_).abs().max())
                                 for g, w_ in zip(got, want)), "ok": ok})
        if not ok:
            raise AssertionError(f"polyfit disagrees with its plain version "
                                 f"at {label}")
        fleet_kernel_time(
            torch, "polyfit", label, list(y.shape),
            lambda: poly_ops.polyfit_cuda(y, u), lambda: polyfit_ref(y, u),
            "polyfit_kernel", 2 * y.numel() * 4 + y.shape[0] * 11 * 4,
            y.numel() * 18, 50,
            note="no single PyTorch call computes the 11 power sums")
    emit({"phase": "single_edge_path_seconds",
          "seconds": time.perf_counter() - t0})

    # ---- 11. fleet_scan under the mean and multi families ----------------
    t0 = time.perf_counter()
    for model, want in FAMILY_REF_WAN_BYTES.items():
        d = scenario_dict("fleet_scan")
        d["planner"] = dict(d["planner"], model=model)
        ex = Experiment.from_scenario(ScenarioConfig.from_dict(d),
                                      use_kernel=True, collect="payloads",
                                      device="cuda")
        windows = ex.make_windows()
        rep, launches = counted(lambda: ex.run(windows))
        T = len(windows)
        expect = {"stream_stats_fleet": 2 * T, "polyfit": 0}
        emit({"phase": "fleet_model_families", "model": model,
              "wan_bytes": rep.wan_bytes, "reference_wan_bytes_cpu": want,
              "nrmse": rep.nrmse, "launches": launches,
              "launches_expected": expect})
        if rep.wan_bytes != want or launches != expect:
            raise AssertionError(f"fleet_scan model={model}: WAN bytes "
                                 f"{rep.wan_bytes} (want {want}), launches "
                                 f"{launches} (want {expect})")
    emit({"phase": "fleet_model_families_seconds",
          "seconds": time.perf_counter() - t0})


def golden_sweep_phase(torch) -> None:
    """Phase 12: the port's sweep on the card over all twenty-one goldens
    (eight scan, six fleet event, seven single-edge event), with the
    kernels (each golden of
    the runner's ``KERNEL_CLASS_GAPS`` held to its recorded f32 class) and
    with the plain versions (every golden in its own class), against the
    committed port-owned reports.  Any drift raises."""
    from repro_torch.kernels.polyfit import ops as poly_ops
    from repro_torch.kernels.stream_stats import ops as ss_ops
    from repro_torch.sweep import diff, runner
    t0 = time.perf_counter()
    scen = [s for s in runner.load_scenarios()
            if runner.not_ported(s) is None]
    skipped = {s.name: runner.not_ported(s) for s in runner.load_scenarios()
               if runner.not_ported(s) is not None}
    bad = []
    for uk in (True, False):
        gaps = runner.KERNEL_CLASS_GAPS if uk else {}
        for s in scen:
            golden = json.loads(
                runner.golden_report_path(s, use_kernel=uk).read_text())
            ss_ops.LAUNCHES = 0
            poly_ops.LAUNCHES = 0
            cur = runner.run_scenario(s, device="cuda", use_kernel=uk)
            torch.cuda.synchronize()
            n_launch = {"stream_stats_fleet": ss_ops.LAUNCHES,
                        "polyfit": poly_ops.LAUNCHES}
            held = (gaps[s.name].meets if s.name in gaps
                    else golden["tolerance"])
            drifts = diff.diff_reports(dict(golden, tolerance=held), cur)
            emit({"phase": "golden_sweep", "scenario": s.name,
                  "use_kernel": uk, "golden_class": golden["tolerance"],
                  "held_class": held, "drifts": len(drifts),
                  "counter_drifts": sum(d.field.startswith("counters:")
                                        for d in drifts),
                  "max_rel_float_gap": _max_rel_gap(golden, cur),
                  "wan_bytes": cur["counters"]["wan_bytes"],
                  "launches": n_launch})
            if drifts:
                print(diff.format_drift_table(drifts), flush=True)
                bad.append((s.name, uk))
            if s.name in CHAOS_REF:
                want = ((uk and CHAOS_REF_KERNEL_PATH.get(s.name))
                        or CHAOS_REF[s.name])
                got = {f: cur["counters"][f] for f in want}
                emit({"phase": "golden_chaos", "scenario": s.name,
                      "use_kernel": uk, "got": got, "reference_cpu": want,
                      "reference_path": "kernel" if
                      want is not CHAOS_REF[s.name] else "cpu"})
                if got != want:
                    bad.append((s.name, uk))
            if s.name in EVENT_REF:
                want = EVENT_REF[s.name]
                got = {f: cur["counters"][f] for f in want}
                emit({"phase": "golden_event", "scenario": s.name,
                      "use_kernel": uk, "got": got, "reference_cpu": want})
                if got != want:
                    bad.append((s.name, uk))
    emit({"phase": "golden_sweep_seconds",
          "seconds": time.perf_counter() - t0, "checked": len(scen),
          "not_ported": skipped})
    if len(scen) != 21 or skipped or bad:
        raise AssertionError(f"golden sweep on the card: {len(scen)} "
                             f"scenarios checked, drifts in {bad}")


def _max_rel_gap(golden: dict, cur: dict) -> float:
    """The largest relative gap between two reports' floats and stream
    summaries (0.0 when every float is equal)."""
    pairs = [(v, cur["floats"].get(k)) for k, v in golden["floats"].items()]
    for k, g in golden["streams"].items():
        if g["kind"] == "float":
            pairs += [(g[st], cur["streams"][k][st])
                      for st in ("mean", "min", "max")]
    gaps = [abs(a - b) / max(abs(a), abs(b))
            for a, b in pairs if isinstance(a, float)
            and isinstance(b, float) and a != b]
    return max(gaps, default=0.0)


def adaptive_path(torch) -> dict:
    """Phase 13: adaptive re-planning at the main path's width.  Returns
    the launches of rows 1 and 2 in the adaptive run.  Every check
    raises."""
    import numpy as np
    from repro_torch.api.experiment import Experiment
    from repro_torch.api.scenario import ScenarioConfig
    from repro_torch.data.streams import fleet_like, fleet_windows
    from repro_torch.kernels.polyfit import ops as poly_ops
    from repro_torch.kernels.stream_stats import ops as ss_ops
    t0 = time.perf_counter()
    a = ADAPTIVE
    E, k, N, T = (a["n_regions"] * a["sites_per_region"], a["k"],
                  a["window"], a["T"])
    schedule = [(0, a["strength"]), (T // 2, a["strength"][::-1])]
    d = scenario_dict("fleet_scan_adaptive_ph")
    d["data"] = dict(d["data"], n_points=T * N, window=N,
                     options={"k": k, "strength_schedule": schedule})
    d["topology"] = dict(d["topology"], n_regions=a["n_regions"],
                         sites_per_region=a["sites_per_region"])
    sc = ScenarioConfig.from_dict(d)
    vals, _ = fleet_like(n_sites=E, n_regions=a["n_regions"], k=k,
                         n_points=T * N, seed=d["data"]["seed"], window=N,
                         strength_schedule=schedule)
    windows = fleet_windows(vals, N)
    emit({"phase": "adaptive_data", "seconds": time.perf_counter() - t0,
          "shape": list(vals.shape), "schedule": schedule})

    def counted(ex):
        ex.run(windows, n_windows=2)             # warm-up
        ss_ops.LAUNCHES = 0
        poly_ops.LAUNCHES = 0
        rep = ex.run(windows)
        torch.cuda.synchronize()
        return rep, {"stream_stats_fleet": ss_ops.LAUNCHES,
                     "polyfit": poly_ops.LAUNCHES}

    ex = Experiment.from_scenario(sc, use_kernel=True, collect="estimates",
                                  device="cuda")
    rep, launches = counted(ex)
    raw = rep.raw
    replans = raw["planner_invocations"]
    expect = {"stream_stats_fleet": T + replans, "polyfit": replans}
    gate = {f: raw[f] for f in ("planner_invocations", "plans_reused",
                                "drift_fires", "detection_lag_windows")}
    d_every = dict(d)
    del d_every["adaptive"]
    every, every_launches = counted(Experiment.from_scenario(
        ScenarioConfig.from_dict(d_every), use_kernel=True,
        collect="estimates", device="cuda"))
    emit({"phase": "adaptive_path", "E": E, "k": k, "N": N, "T": T,
          "gate": gate, "launches": launches, "launches_expected": expect,
          "windows_per_sec": raw["windows_per_sec"],
          "scan_seconds": raw["scan_seconds"], "wan_bytes": rep.wan_bytes,
          "full_bytes": rep.full_bytes, "nrmse": rep.nrmse,
          "plan_every_window": {
              "windows_per_sec": every.raw["windows_per_sec"],
              "wan_bytes": every.wan_bytes, "nrmse": every.nrmse,
              "launches": every_launches}})
    if launches != expect or not 1 <= replans <= T:
        raise AssertionError(f"adaptive path launches {launches}, want "
                             f"{expect}")
    if (not all(np.isfinite(v) for v in rep.nrmse.values())
            or not 0 < rep.wan_bytes < rep.full_bytes):
        raise AssertionError(f"adaptive path output out of range: nrmse "
                             f"{rep.nrmse}, wan {rep.wan_bytes}")
    profile_main_path(ex, windows, torch, n_prof=a["n_prof"],
                      out_name="profile_adaptive.txt")

    # the plain versions on the card: the gate's decisions do not depend
    # on the fit, so its counters are bitwise; the plans fit by the legacy
    # least squares instead of the fused moments (ROADMAP.md queue 3, note
    # e), so the bytes are held as the main path's plain check holds them
    plain = Experiment.from_scenario(sc, use_kernel=False,
                                     collect="estimates",
                                     device="cuda").run(windows)
    p_gate = {f: plain.raw[f] for f in gate}
    hist_k = np.asarray(raw["bytes_history"])
    hist_p = np.asarray(plain.raw["bytes_history"])
    d_wan = abs(rep.wan_bytes - plain.wan_bytes) / plain.wan_bytes
    emit({"phase": "adaptive_plain_vs_kernel", "gate_kernel": gate,
          "gate_plain": p_gate, "wan_kernel": rep.wan_bytes,
          "wan_plain": plain.wan_bytes, "wan_rel_diff": d_wan,
          "byte_history_bitwise": bool(np.array_equal(hist_k, hist_p)),
          "byte_history_cells_differing": int((hist_k != hist_p).sum()),
          "windows_differing": int((hist_k != hist_p).any(axis=1).sum()),
          "windows_per_sec_plain": plain.raw["windows_per_sec"]})
    if p_gate != gate or d_wan > 0.001:
        raise AssertionError(f"adaptive path: plain and kernel disagree: "
                             f"gate {p_gate} against {gate}, WAN rel "
                             f"{d_wan}")

    # the adaptive golden on the card against the live reference
    g = Experiment.from_scenario(
        ScenarioConfig.from_dict(scenario_dict("fleet_scan_adaptive_ph")),
        use_kernel=True, device="cuda").run()
    got = {"wan_bytes": g.wan_bytes,
           **{f: g.raw[f] for f in ADAPTIVE_REF if f != "wan_bytes"}}
    emit({"phase": "adaptive_golden", "got": got,
          "reference_cpu": ADAPTIVE_REF, "nrmse": g.nrmse})
    if got != ADAPTIVE_REF:
        raise AssertionError(f"fleet_scan_adaptive_ph on the card: {got}, "
                             f"live reference {ADAPTIVE_REF}")
    emit({"phase": "adaptive_path_seconds",
          "seconds": time.perf_counter() - t0})
    return launches


def chaos_phases(torch, windows, scenario: dict) -> dict:
    """Phases 14-15: chaos fault injection at the main path's width (the
    main path's fleet, planner and windows, ``CHAOS["spec"]``), then a
    checkpoint inside the outage restored into a fresh runtime.  Returns
    the launches of rows 1 and 2 in the chaos run.  Every check raises."""
    import tempfile
    import numpy as np
    from repro_torch.api.experiment import Experiment
    from repro_torch.api.scenario import ScenarioConfig
    from repro_torch.chaos import liveness_table, make_chaos_carry
    from repro_torch.ckpt import flatten, latest_step, restore, save
    from repro_torch.kernels.polyfit import ops as poly_ops
    from repro_torch.kernels.stream_stats import ops as ss_ops
    from repro_torch.runtime import scan as scan_mod
    from repro_torch.runtime import step as step_mod
    from repro_torch.runtime.state import ControllerState, init_state
    t0 = time.perf_counter()
    T, cut = CHAOS["T"], CHAOS["cut"]
    sc = ScenarioConfig.from_dict(dict(scenario, chaos=CHAOS["spec"]))

    def experiment():
        return Experiment.from_scenario(sc, use_kernel=True,
                                        collect="estimates", device="cuda")

    ex = experiment()
    ex.run(windows, n_windows=2)                 # warm-up
    ss_ops.LAUNCHES = 0
    poly_ops.LAUNCHES = 0
    rep = ex.run(windows, n_windows=T)
    torch.cuda.synchronize()
    launches = {"stream_stats_fleet": ss_ops.LAUNCHES,
                "polyfit": poly_ops.LAUNCHES}
    raw = rep.raw
    topo = ex.runtime.topology
    live = np.asarray(raw["liveness"]).astype(bool)
    cpu_tbl = liveness_table(sc.chaos, T, topo.n_sites, topo.region_of())
    budgets = np.asarray(raw["budget_history"])
    nbytes = np.asarray(raw["bytes_history"])
    emit({"phase": "chaos_path", "E": topo.n_sites, "k": topo.k, "T": T,
          "windows_per_sec": raw["windows_per_sec"],
          "scan_seconds": raw["scan_seconds"],
          "launches": launches,
          "launches_per_window": {n: v / T for n, v in launches.items()},
          "down_site_windows": raw["down_site_windows"],
          "gap_served_cells": raw["gap_served_cells"],
          "recovery_windows": raw["recovery_windows"],
          "availability_by_region": raw["availability_by_region"],
          "wan_bytes": rep.wan_bytes, "full_bytes": rep.full_bytes,
          "nrmse": rep.nrmse, "outage_nrmse": raw["outage_nrmse"],
          "steady_nrmse": raw["steady_nrmse"]})
    if launches != {"stream_stats_fleet": 2 * T, "polyfit": T}:
        raise AssertionError(f"chaos path launches {launches}, want "
                             f"{2 * T} and {T}")
    if not np.array_equal(live, cpu_tbl):
        raise AssertionError("chaos path: liveness table differs from the "
                             "CPU's")
    if (budgets[~live] != 0).any() or (nbytes[~live] != 0).any():
        raise AssertionError("chaos path: a dead site got a budget or "
                             "shipped bytes")
    if not (live.sum() < live.size and (nbytes[live] > 0).all()
            and 0 < rep.wan_bytes < rep.full_bytes):
        raise AssertionError("chaos path: output out of range")
    profile_main_path(ex, windows, torch, out_name="profile_chaos.txt")

    # the uninterrupted run again, each window's raw budgets beside the
    # same controller state's budgets computed on the CPU, and the served
    # tables kept; then the run split at ``cut`` through a checkpoint
    sums, stacked = [], []
    budgets_fn, stack_fn = step_mod.controller_budgets, scan_mod._stack_outputs

    def hooked(state, p, live=None, shard=None):
        out = budgets_fn(state, p, live=live, shard=shard)
        host = ControllerState(**{f: getattr(state, f).cpu() for f in
                                  ControllerState.__dataclass_fields__})
        cpu = budgets_fn(host, p, live=None if live is None else live.cpu())
        sums.append((float(out.sum()), float(cpu.sum())))
        return out

    step_mod.controller_budgets = hooked
    scan_mod._stack_outputs = lambda outs: stacked.append(stack_fn(outs)) \
        or stacked[-1]
    try:
        full = experiment().run(windows, n_windows=T)
        step_mod.controller_budgets = budgets_fn
        head = experiment().run(windows, n_windows=cut)
        with tempfile.TemporaryDirectory() as tmp:
            save(head.raw["final_state"], cut, tmp)
            E, k = topo.n_sites, topo.k
            template = init_state(E, k, 0.0, device="cuda")
            template.chaos = make_chaos_carry(E, k, sc.queries,
                                              device="cuda")
            state = restore(tmp, latest_step(tmp), template, device="cuda")
        tail = experiment().run(windows, n_windows=T - cut, state=state)
    finally:
        step_mod.controller_budgets = budgets_fn
        scan_mod._stack_outputs = stack_fn
    ys_full, ys_tail = stacked[0], stacked[2]
    rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in sums)
    same = {
        "bytes_history": np.array_equal(
            tail.raw["bytes_history"], full.raw["bytes_history"][cut:]),
        "budget_history": np.array_equal(
            tail.raw["budget_history"], full.raw["budget_history"][cut:]),
        "served": all(np.array_equal(ys_tail["est"][q],
                                     ys_full["est"][q][cut:], equal_nan=True)
                      for q in sc.queries),
        "final_state": _same_leaves(flatten(tail.raw["final_state"]),
                                    flatten(full.raw["final_state"])),
        "wan_bytes": head.wan_bytes + tail.wan_bytes == full.wan_bytes}
    emit({"phase": "chaos_resume", "cut": cut, "T": T, "bitwise": same,
          "budget_sum_max_rel_gap_cpu": rel, "windows_checked": len(sums),
          "seconds": time.perf_counter() - t0})
    if not all(same.values()) or rel > 1e-5 or len(sums) != T:
        raise AssertionError(f"chaos resume: {same}, budget sums rel {rel} "
                             f"over {len(sums)} windows")
    return launches


def _event_straggler(wid: int, site: int, stream: int) -> bool:
    """The fleet event path's fixed straggler rule (~1% of counts)."""
    return (wid * 131 + site * 8 + stream) % EVENT["straggle_mod"] == 0


class _InjectedPlans:
    """A plan engine serving the scan's own per-window plan arrays to the
    event loop (the injected-plans harness): given the same plans, every
    byte and estimate goes through the event loop's host code."""

    name = "injected"
    fields = ("r2", "objective", "n_real", "n_imputed", "predictor",
              "coeffs", "loc", "scale", "explained_var", "mean", "var")

    def __init__(self, ys):
        self.ys = ys

    def check(self, cfg):
        pass

    def plan_fleet(self, values, counts, budgets, cfg, *, window_id, **kw):
        import numpy as np
        return {f: np.asarray(self.ys[f][window_id]) for f in self.fields}


def event_phases(torch, windows, scenario: dict, card_line: str) -> dict:
    """Phases 16-18: the fleet event loop at the main path's width, then
    fed the scan's plans, then with the plain versions.  Returns the
    launches of rows 1 and 2 in phase 16's run.  Every check raises."""
    import numpy as np
    from repro_torch.api.experiment import Experiment
    from repro_torch.api.scenario import ScenarioConfig
    from repro_torch.kernels.polyfit import ops as poly_ops
    from repro_torch.kernels.stream_stats import ops as ss_ops
    t_all = time.perf_counter()
    T = EVENT["T"]
    d = dict(scenario, runtime="event",
             topology=dict(scenario["topology"], **EVENT["wan"]),
             transport=dict(scenario["transport"], **EVENT["transport"]),
             controller=dict(scenario["controller"], link_cost_aware=True))
    sc = ScenarioConfig.from_dict(d)

    def experiment(use_kernel=True):
        return Experiment.from_scenario(sc, use_kernel=use_kernel,
                                        straggler_drop=_event_straggler,
                                        device="cuda")

    experiment().run(windows, n_windows=1)       # warm-up
    ex = experiment()
    ss_ops.LAUNCHES = 0
    poly_ops.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    rep = ex.run(windows, n_windows=T)
    torch.cuda.synchronize()
    launches = {"stream_stats_fleet": ss_ops.LAUNCHES,
                "polyfit": poly_ops.LAUNCHES}
    raw = rep.raw
    E, k = ex.runtime.topology.n_sites, ex.runtime.topology.k
    straggled = sum(_event_straggler(w, s_, i) for w in range(T)
                    for s_ in range(E) for i in range(k))
    emit({"phase": "fleet_event_path", "card": card_line, "E": E, "k": k,
          "N": windows[0].shape[-1], "T": T,
          "windows_per_sec": raw["windows_per_sec"],
          "run_seconds": raw["run_seconds"],
          "plan_s_per_window": raw["plan_seconds"] / T,
          "site_loop_s_per_window": raw["site_seconds"] / T,
          "launches": launches,
          "launches_per_window": {n: v / T for n, v in launches.items()},
          "straggled_counts_share": straggled / (T * E * k),
          "gaps": rep.gaps, "revisions": rep.revisions,
          "late_drops": rep.late_drops, "duplicates": rep.duplicates,
          "retransmits": rep.retransmits, "freshness_ms": rep.freshness_ms,
          "wan_bytes": rep.wan_bytes, "full_bytes": rep.full_bytes,
          "wan_fraction": rep.wan_fraction, "nrmse": rep.nrmse,
          "nrmse_at_query": rep.nrmse_at_query,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    if launches != {"stream_stats_fleet": 2 * T, "polyfit": T}:
        raise AssertionError(f"event path launches {launches}, want "
                             f"stream_stats_fleet {2 * T}, polyfit {T}")
    finite = (all(np.isfinite(v) for v in rep.nrmse.values())
              and all(np.isfinite(t).all()
                      for t in rep.nrmse_per_stream.values()))
    if not finite or not 0 < rep.wan_bytes < rep.full_bytes:
        raise AssertionError(f"event path output out of range: nrmse "
                             f"{rep.nrmse}, wan {rep.wan_bytes} of "
                             f"{rep.full_bytes}")
    profile_event_path(experiment(), windows, torch, card_line)

    # ---- 17. the event loop fed the scan's plans --------------------------
    Tp = EVENT["T_parity"]
    dp = dict(scenario, runtime="scan",
              topology=dict(scenario["topology"], latency_scale=0.0),
              controller=dict(scenario["controller"], mode="static"))
    scan = Experiment.from_scenario(ScenarioConfig.from_dict(dp),
                                    use_kernel=True, collect="payloads",
                                    device="cuda")
    stash = {}
    replay = scan.runtime._replay

    def spy(ys, *a, **kw):
        stash["ys"] = ys
        return replay(ys, *a, **kw)

    scan.runtime._replay = spy
    t0 = time.perf_counter()
    rep_s = scan.run(windows, n_windows=Tp)
    scan_s = time.perf_counter() - t0
    ev = Experiment.from_scenario(ScenarioConfig.from_dict(
        dict(dp, runtime="event")), use_kernel=True, device="cuda")
    ev.runtime.sampling = "device"
    ev.runtime.engine = _InjectedPlans(stash["ys"])
    rep_e = ev.run(windows, n_windows=Tp)
    same = {"wan_bytes": rep_e.wan_bytes == rep_s.wan_bytes,
            "wan_cost": rep_e.wan_cost == rep_s.wan_cost,
            "budget_history": bool(np.array_equal(
                rep_e.raw["budget_history"], rep_s.raw["budget_history"])),
            **{f"nrmse_per_stream/{q}": bool(np.array_equal(
                rep_e.nrmse_per_stream[q], rep_s.nrmse_per_stream[q],
                equal_nan=True)) for q in rep_s.nrmse_per_stream}}
    emit({"phase": "event_scan_parity", "card": card_line, "E": E, "T": Tp,
          "wan_bytes_scan": rep_s.wan_bytes, "wan_bytes_event":
          rep_e.wan_bytes, "bitwise": same, "scan_seconds": scan_s,
          "event_run_seconds": rep_e.raw["run_seconds"]})
    if not all(same.values()):
        raise AssertionError(f"event loop fed the scan's plans differs from "
                             f"the scan: {same}")

    # ---- 18. the plain versions on the card -------------------------------
    T2 = EVENT["T_plain"]
    rk = experiment(True).run(windows, n_windows=T2)
    rp = experiment(False).run(windows, n_windows=T2)
    d_avg = abs(rk.nrmse["AVG"] - rp.nrmse["AVG"]) / abs(rp.nrmse["AVG"])
    d_wan = abs(rk.wan_bytes - rp.wan_bytes) / rp.wan_bytes
    emit({"phase": "event_plain_vs_kernel", "card": card_line, "T": T2,
          "nrmse_kernel": rk.nrmse, "nrmse_plain": rp.nrmse,
          "wan_kernel": rk.wan_bytes, "wan_plain": rp.wan_bytes,
          "avg_rel_diff": d_avg, "wan_rel_diff": d_wan,
          "windows_per_sec_kernel": rk.raw["windows_per_sec"],
          "windows_per_sec_plain": rp.raw["windows_per_sec"]})
    if d_avg > 0.01 or d_wan > 0.001:
        raise AssertionError(f"event path: kernel and plain disagree: AVG "
                             f"NRMSE rel {d_avg}, WAN bytes rel {d_wan}")
    emit({"phase": "event_phases_seconds", "card": card_line,
          "seconds": time.perf_counter() - t_all})
    return launches


def _single_straggler(wid: int, stream: int) -> bool:
    """The single-edge event path's fixed straggler rule (~8% of counts)."""
    return (wid * 5 + stream) % SINGLE_EVENT["straggle_mod"] == 0


def single_event_path(torch, card_line: str) -> dict:
    """Phase 19: one edge gateway on the host planner, on the card and
    then on the CPU.  Returns the launches of rows 1 and 2 in the card's
    run (both 0: the host planner's statistics and fit are the plain
    versions).  Every check raises."""
    import numpy as np
    from repro_torch.api.experiment import Experiment
    from repro_torch.api.scenario import ScenarioConfig
    from repro_torch.core import stats as stats_mod
    from repro_torch.kernels.polyfit import ops as poly_ops
    from repro_torch.kernels.stream_stats import ops as ss_ops
    t_all = time.perf_counter()
    T, N = SINGLE_EVENT["T"], SINGLE_EVENT["window"]
    d = dict(scenario_dict("single_event_cubic"),
             data={"dataset": "turbine", "n_points": T * N, "window": N,
                   "seed": SINGLE_EVENT["seed"],
                   "options": {"k": SINGLE_EVENT["k"]}},
             transport=scenario_dict("single_event_retransmit")["transport"])
    sc = ScenarioConfig.from_dict(d)

    def experiment(device):
        return Experiment.from_scenario(sc, straggler_drop=_single_straggler,
                                        device=device)

    t0 = time.perf_counter()
    windows = experiment("cpu").make_windows()
    data_s = time.perf_counter() - t0
    experiment("cuda").run(windows[:1])          # warm-up

    def run(device):
        """One run; its per-window allocations and where its statistics
        lay."""
        ex = experiment(device)
        allocs, where = [], set()
        plan = ex.runtime.edge.process_window

        def spy(batch):
            payload = plan(batch)
            allocs.append((payload.n_real.copy(), payload.n_imputed.copy()))
            return payload

        window_stats = stats_mod.window_stats

        def stats_spy(values, counts, dependence="pearson"):
            out = window_stats(values, counts, dependence)
            where.add(out.mean.device.type)
            return out

        ex.runtime.edge.process_window = spy
        stats_mod.window_stats = stats_spy
        try:
            rep = ex.run(windows)
        finally:
            stats_mod.window_stats = window_stats
        return rep, allocs, where

    ss_ops.LAUNCHES = 0
    poly_ops.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    rep, allocs, where = run("cuda")
    torch.cuda.synchronize()
    launches = {"stream_stats_fleet": ss_ops.LAUNCHES,
                "polyfit": poly_ops.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    raw = rep.raw
    k = SINGLE_EVENT["k"]
    straggled = sum(_single_straggler(w, i) for w in range(T)
                    for i in range(k))
    emit({"phase": "single_event_path", "card": card_line, "k": k, "N": N,
          "T": T, "data_seconds": data_s,
          "windows_per_sec": raw["windows_per_sec"],
          "run_seconds": raw["run_seconds"],
          "plan_s_per_window": raw["plan_seconds"] / T,
          "card_s_per_window": raw["device_seconds"] / T,
          "host_solve_s_per_window": raw["solve_seconds"] / T,
          "newton_steps_per_window": raw["newton_steps"] / T,
          "statistics_on": sorted(where), "launches": launches,
          "straggled_counts_share": straggled / (T * k),
          "wan_bytes": rep.wan_bytes, "full_bytes": rep.full_bytes,
          "wan_fraction": rep.wan_fraction, "gaps": rep.gaps,
          "revisions": rep.revisions, "late_drops": rep.late_drops,
          "duplicates": rep.duplicates, "retransmits": rep.retransmits,
          "freshness_ms": rep.freshness_ms, "nrmse": rep.nrmse,
          "nrmse_at_query": rep.nrmse_at_query, "peak_mem_bytes": peak})
    if launches != {"stream_stats_fleet": 0, "polyfit": 0}:
        raise AssertionError(f"single-edge event path launched {launches}; "
                             f"the host planner runs no kernel")
    if where != {"cuda"}:
        raise AssertionError(f"window statistics on {where}, want cuda")
    finite = (all(np.isfinite(v) for v in rep.nrmse.values())
              and all(np.isfinite(t).all()
                      for t in rep.nrmse_per_stream.values()))
    if not finite or not 0 < rep.wan_bytes < rep.full_bytes \
            or len(allocs) != T:
        raise AssertionError(f"single-edge event path output out of range: "
                             f"nrmse {rep.nrmse}, wan {rep.wan_bytes} of "
                             f"{rep.full_bytes}, {len(allocs)} plans")

    # the same run on the CPU: every allocation, counter and NRMSE
    rep_c, allocs_c, where_c = run("cpu")
    counters = ("wan_bytes", "full_bytes", "gaps", "revisions",
                "late_drops", "duplicates", "retransmits")
    same = {"allocations": len(allocs) == len(allocs_c) and all(
                np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                for a, b in zip(allocs, allocs_c)),
            "newton_steps": rep.raw["newton_steps"]
            == rep_c.raw["newton_steps"],
            **{c: rep.raw[c] == rep_c.raw[c] for c in counters},
            **{f"nrmse_per_stream/{q}": bool(np.array_equal(
                rep.nrmse_per_stream[q], rep_c.nrmse_per_stream[q],
                equal_nan=True)) for q in rep.nrmse_per_stream}}
    emit({"phase": "single_event_cpu_parity", "card": card_line, "T": T,
          "bitwise": same, "statistics_on_cpu_run": sorted(where_c),
          "cpu_windows_per_sec": rep_c.raw["windows_per_sec"],
          "cpu_plan_s_per_window": rep_c.raw["plan_seconds"] / T,
          "cpu_host_solve_s_per_window": rep_c.raw["solve_seconds"] / T,
          "seconds": time.perf_counter() - t_all})
    if not all(same.values()):
        raise AssertionError(f"single-edge event path: card and CPU differ: "
                             f"{same}")
    return launches


def _row_launches() -> dict:
    from repro_torch.kernels.polyfit import ops as poly_ops
    from repro_torch.kernels.stream_stats import ops as ss_ops
    return {"stream_stats_fleet": ss_ops.LAUNCHES,
            "polyfit": poly_ops.LAUNCHES}


def _zero_row_launches() -> None:
    from repro_torch.kernels.polyfit import ops as poly_ops
    from repro_torch.kernels.stream_stats import ops as ss_ops
    ss_ops.LAUNCHES = 0
    poly_ops.LAUNCHES = 0


def _same_runs(runs: dict) -> dict:
    """Which parts of the card's run equal the CPU's bit for bit: the
    per-plan records, every counter and every NRMSE table."""
    import numpy as np
    (rep, seen, _), (rep_c, seen_c, _) = runs["cuda"], runs["cpu"]
    counters = ("wan_bytes", "full_bytes", "gaps", "revisions",
                "late_drops", "duplicates", "retransmits")
    same = {"plans": len(seen) == len(seen_c) > 0 and all(
                all(np.array_equal(x, y) for x, y in zip(a, b))
                for a, b in zip(seen, seen_c)),
            "wan_cost": rep.wan_cost == rep_c.wan_cost,
            **{c: getattr(rep, c) == getattr(rep_c, c) for c in counters},
            **{f"nrmse_per_stream/{q}": bool(np.array_equal(
                rep.nrmse_per_stream[q], rep_c.nrmse_per_stream[q],
                equal_nan=True)) for q in rep.nrmse_per_stream}}
    return same


def _check_run(label: str, rep, launches: dict, same: dict) -> None:
    import numpy as np
    if launches != {"stream_stats_fleet": 0, "polyfit": 0}:
        raise AssertionError(f"{label} launched {launches}; the host "
                             f"planner and the baselines run no kernel")
    finite = (all(np.isfinite(v) for v in rep.nrmse.values())
              and all(np.isfinite(t).all()
                      for t in rep.nrmse_per_stream.values()))
    if not finite or not 0 < rep.wan_bytes < rep.full_bytes:
        raise AssertionError(f"{label} output out of range: nrmse "
                             f"{rep.nrmse}, wan {rep.wan_bytes} of "
                             f"{rep.full_bytes}")
    if not all(same.values()):
        raise AssertionError(f"{label}: card and CPU differ: {same}")


def _payload_record(payload):
    return (payload.n_real.copy(), payload.n_imputed.copy())


def baseline_path(torch, card_line: str) -> dict:
    """Phase 20: Fig. 5's comparison on one edge, on the card and then on
    the CPU: the planner (model, mean imputation) and three baselines at
    budget fraction ``BASELINE["budget_fraction"]``.  Per method: the WAN
    fraction, NRMSE per query, windows/sec and plan seconds a window; every
    allocation, counter and NRMSE bitwise between the two runs.  Returns
    the card's launches of rows 1 and 2 over all methods (0)."""
    from repro_torch.api.scenario import ScenarioConfig
    t_all = time.perf_counter()
    total = {"stream_stats_fleet": 0, "polyfit": 0}
    for method in BASELINE["methods"]:
        d = dict(scenario_dict("single_event_baseline_srs"),
                 data=BASELINE["data"], method=method,
                 budget_fraction=BASELINE["budget_fraction"],
                 queries=BASELINE["queries"], planner={})
        runs = _edge_runs(torch, ScenarioConfig.from_dict(d))
        rep, seen, launches = runs["cuda"]
        same = _same_runs(runs)
        T = len(seen)
        raw = rep.raw
        emit({"phase": "baseline_path", "card": card_line, "method": method,
              "budget_fraction": BASELINE["budget_fraction"], "T": T,
              "wan_fraction": rep.wan_fraction, "wan_bytes": rep.wan_bytes,
              "nrmse": rep.nrmse,
              "windows_per_sec": raw["windows_per_sec"],
              "plan_s_per_window": raw["plan_seconds"] / T,
              "cpu_windows_per_sec": runs["cpu"][0].raw["windows_per_sec"],
              "cpu_plan_s_per_window": runs["cpu"][0].raw["plan_seconds"]
              / T, "launches": launches, "bitwise": same})
        _check_run(f"baseline_path {method}", rep, launches, same)
        for n in total:
            total[n] += launches[n]
    emit({"phase": "baseline_path_seconds",
          "seconds": time.perf_counter() - t_all})
    return total


def _edge_runs(torch, sc, record=_payload_record) -> dict:
    """A single-edge scenario on the card and on the CPU, each window's
    payload recorded at the edge (``EdgeNode.process_window``)."""
    from repro_torch.api.experiment import Experiment
    out = {}
    for device in ("cuda", "cpu"):
        ex = Experiment.from_scenario(sc, device=device)
        seen = []
        plan = ex.runtime.edge.process_window

        def spy(batch, _plan=plan, _seen=seen):
            payload = _plan(batch)
            _seen.append(record(payload))
            return payload

        ex.runtime.edge.process_window = spy
        _zero_row_launches()
        rep = ex.run()
        if device == "cuda":
            torch.cuda.synchronize()
        out[device] = (rep, seen, _row_launches())
    return out


def iid_path(torch, card_line: str) -> dict:
    """Phase 21: Fig. 9's iid relaxations on one edge, on the card and
    then on the CPU: per mode the strides of every window (thinning), the
    AVG NRMSE and windows/sec; every allocation and stride, counter and
    NRMSE bitwise between the two runs.  Returns the card's launches of
    rows 1 and 2 over the three modes (0)."""
    import numpy as np
    from repro_torch.api.scenario import ScenarioConfig
    from repro_torch.core import planner as planner_mod
    t_all = time.perf_counter()
    total = {"stream_stats_fleet": 0, "polyfit": 0}
    real = planner_mod.plan_window
    for mode in IID["modes"]:
        d = {"data": IID["data"], "budget_fraction": IID["budget_fraction"],
             "queries": ["AVG"], "runtime": "event",
             "planner": {"iid_mode": mode, "m_lags": IID["m_lags"]}}
        strides = []

        def spy(*a, _strides=strides, **kw):
            payload, diag = real(*a, **kw)
            _strides.append(None if diag.strides is None
                            else diag.strides.copy())
            return payload, diag

        planner_mod.plan_window = spy
        try:
            runs = _edge_runs(torch, ScenarioConfig.from_dict(d))
        finally:
            planner_mod.plan_window = real
        rep, seen, launches = runs["cuda"]
        T = len(seen)
        card_s, cpu_s = strides[:T], strides[T:]
        same = dict(_same_runs(runs), strides=len(card_s) == len(cpu_s)
                    and all((a is None and b is None) or
                            np.array_equal(a, b)
                            for a, b in zip(card_s, cpu_s)))
        emit({"phase": "iid_path", "card": card_line, "mode": mode, "T": T,
              "strides": [None if x is None else x.tolist()
                          for x in card_s],
              "nrmse_avg": rep.nrmse["AVG"], "wan_fraction": rep.wan_fraction,
              "windows_per_sec": rep.raw["windows_per_sec"],
              "plan_s_per_window": rep.raw["plan_seconds"] / T,
              "cpu_windows_per_sec": runs["cpu"][0].raw["windows_per_sec"],
              "launches": launches, "bitwise": same})
        _check_run(f"iid_path {mode}", rep, launches, same)
        if (mode == "thinning") != all(x is not None for x in card_s):
            raise AssertionError(f"iid_path {mode}: strides {card_s}")
        for n in total:
            total[n] += launches[n]
    emit({"phase": "iid_path_seconds", "seconds": time.perf_counter() - t_all})
    return total


def host_engine_path(torch, card_line: str) -> dict:
    """Phase 22: the fleet host engine (the host planner at every site:
    fleet_event_host_engine's IPM, cubic, Spearman, k-SE planner and its
    rebalancing controller with the query split) on fleet_bench's fleet
    over ``HOST_ENGINE["T"]`` windows, on the card and then on the CPU:
    plan seconds a site, windows/sec and the WAN fraction; every site's
    allocation, each window's r2, every counter and NRMSE bitwise between
    the two runs.  Returns the card's launches of rows 1 and 2 (0)."""
    from repro_torch.api.scenario import ScenarioConfig
    t_all = time.perf_counter()
    T = HOST_ENGINE["T"]
    d = dict(scenario_dict("fleet_event_host_engine"),
             data=dict(HOST_ENGINE["data"],
                       n_points=T * HOST_ENGINE["data"]["window"]),
             topology=dict(scenario_dict("fleet_event_host_engine")
                           ["topology"], **HOST_ENGINE["topology"]))
    sc = ScenarioConfig.from_dict(d)
    E = sc.topology.n_sites

    def record(plan):
        return ([p.n_real.copy() for p in plan["payloads"]]
                + [p.n_imputed.copy() for p in plan["payloads"]]
                + [plan["r2"].copy()])

    runs = _fleet_runs(torch, sc, record)
    rep, seen, launches = runs["cuda"]
    same = _same_runs(runs)
    raw = rep.raw
    emit({"phase": "host_engine_path", "card": card_line, "E": E,
          "k": HOST_ENGINE["data"]["options"]["k"],
          "N": HOST_ENGINE["data"]["window"], "T": T,
          "engine": sc.planner.engine,
          "windows_per_sec": raw["windows_per_sec"],
          "plan_s_per_site": raw["plan_seconds"] / (T * E),
          "plan_s_per_window": raw["plan_seconds"] / T,
          "cpu_windows_per_sec": runs["cpu"][0].raw["windows_per_sec"],
          "cpu_plan_s_per_site": runs["cpu"][0].raw["plan_seconds"]
          / (T * E),
          "wan_fraction": rep.wan_fraction, "wan_bytes": rep.wan_bytes,
          "nrmse": rep.nrmse, "launches": launches, "bitwise": same,
          "seconds": time.perf_counter() - t_all})
    _check_run("host_engine_path", rep, launches, same)
    return launches


class _PlanSpy:
    """An engine that records each plan of the engine it wraps (the
    engines are shared objects, so the spy wraps, never patches)."""

    def __init__(self, engine, record, seen: list):
        self.engine, self.record, self.seen = engine, record, seen
        self.name = engine.name

    def plan_fleet(self, *a, **kw):
        plan = self.engine.plan_fleet(*a, **kw)
        self.seen.append(self.record(plan))
        return plan


def _fleet_runs(torch, sc, record) -> dict:
    """A fleet scenario on the card and on the CPU, each window's plan
    recorded at the engine (``plan_fleet``)."""
    from repro_torch.api.experiment import Experiment
    out = {}
    for device in ("cuda", "cpu"):
        ex = Experiment.from_scenario(sc, device=device)
        seen = []
        ex.runtime.engine = _PlanSpy(ex.runtime.engine, record, seen)
        _zero_row_launches()
        rep = ex.run()
        if device == "cuda":
            torch.cuda.synchronize()
        out[device] = (rep, seen, _row_launches())
    return out


def _run_arrays(rep, prefix: str = "") -> dict:
    """A fleet run's report as named host arrays: the counters, every
    NRMSE table, the byte and budget histories, the plan's per-window
    tables, the controller's demand and (a scan's) final state."""
    import numpy as np
    from repro_torch.ckpt import flatten
    raw = rep.raw
    out = {c: np.asarray(getattr(rep, c)) for c in (
        "wan_bytes", "wan_cost", "full_bytes", "gaps", "revisions",
        "late_drops", "duplicates", "retransmits")}
    for q, v in rep.nrmse_per_stream.items():
        out[f"nrmse_per_stream/{q}"] = np.asarray(v)
    out["budget_history"] = np.asarray(raw["budget_history"])
    for key in ("bytes_history", "controller_demand"):
        if key in raw:
            out[key] = np.asarray(raw[key])
    for key, v in raw.get("plan_raw", {}).items():
        out[f"plan_raw/{key}"] = np.asarray(v)
    if "final_state" in raw:
        out.update({f"final_state{path}": a
                    for path, a in flatten(raw["final_state"]).items()})
    return {prefix + key: v for key, v in out.items()}


def _sharded_experiment(scenario: dict, **change):
    from repro_torch.api.experiment import Experiment
    from repro_torch.api.scenario import ScenarioConfig
    return Experiment.from_scenario(
        ScenarioConfig.from_dict(dict(scenario, **change)), use_kernel=True,
        collect="estimates", device="cuda")


def _event_change(scenario: dict, engine: str) -> dict:
    return {"runtime": "event",
            "planner": dict(scenario["planner"], engine=engine)}


def _sharded_rank(rank: int, world: int, tmp: str, scenario: dict,
                  plan: dict) -> None:
    """One rank of phase 23 (spawned): its share of the fleet on the
    shared card, the sharded scan over ``plan["T_ranks"]`` windows and the
    event loop on the sharded engine over ``plan["T_event"]``; its report
    arrays to ``rank<r>.npz``, its launches and pace to ``rank<r>.json``.
    ``plan`` is the caller's ``SHARDED``."""
    import datetime
    sys.path.insert(0, os.path.join(HERE, "src"))
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=plan["timeout_s"]))
    try:
        windows = list(np.load(os.path.join(tmp, "windows.npy")))
        _sharded_experiment(scenario).run(windows, n_windows=2)  # warm-up
        ex = _sharded_experiment(scenario)
        _zero_row_launches()
        rep = ex.run(windows, n_windows=plan["T_ranks"])
        torch.cuda.synchronize()
        launches = _row_launches()
        ev_ex = _sharded_experiment(scenario,
                                    **_event_change(scenario, "sharded"))
        _zero_row_launches()
        ev = ev_ex.run(windows, n_windows=plan["T_event"])
        torch.cuda.synchronize()
        ev_launches = _row_launches()
        np.savez(os.path.join(tmp, f"rank{rank}.npz"),
                 **_run_arrays(rep, "scan/"), **_run_arrays(ev, "event/"))
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump({"rows": ex.runtime.shard.rows,
                       "offset": ex.runtime.shard.offset,
                       "launches": launches, "event_launches": ev_launches,
                       "windows_per_sec": rep.raw["windows_per_sec"],
                       "event_windows_per_sec": ev.raw["windows_per_sec"]},
                      f)
    finally:
        dist.destroy_process_group()


def _same_arrays(a: dict, b: dict) -> dict:
    """Per key, whether two runs' arrays are equal bit for bit (NaN where
    NaN); a key one run lacks is unequal."""
    import numpy as np
    return {key: (key in a and key in b and a[key].dtype == b[key].dtype
                  and np.array_equal(a[key], b[key],
                                     equal_nan=a[key].dtype.kind == "f"))
            for key in sorted(set(a) | set(b))}


def sharded_path(torch, windows, scenario: dict, card_line: str) -> dict:
    """Phase 23: site sharding at the main path's width.  In this process
    (world size 1), ``runtime="scan_sharded"`` against ``runtime="scan"``
    over ``SHARDED["T"]`` windows and ``engine="sharded"`` against
    ``"batched"`` on the fleet event loop; then ``SHARDED["world"]`` gloo
    ranks spawned on the one card, each over its half of the fleet, held
    bitwise against this process's runs of as many windows, with rows 1
    and 2 launched 2 and 1 times a planned window on every rank.  Returns
    the launches of rows 1 and 2: this process's sharded scan
    (``in_process``) and the ranks' scans summed (``ranks``)."""
    import tempfile
    import numpy as np
    import torch.multiprocessing as mp
    t_all = time.perf_counter()
    T, T_r, T_e, world = (SHARDED["T"], SHARDED["T_ranks"],
                          SHARDED["T_event"], SHARDED["world"])
    scenario = dict(scenario, runtime="scan_sharded")
    _sharded_experiment(scenario).run(windows, n_windows=2)      # warm-up
    ex = _sharded_experiment(scenario)
    _zero_row_launches()
    rep_s = ex.run(windows, n_windows=T)
    torch.cuda.synchronize()
    launches = _row_launches()
    rep_b = _sharded_experiment(scenario, runtime="scan").run(
        windows, n_windows=T)
    same_w1 = _same_arrays(_run_arrays(rep_s), _run_arrays(rep_b))
    want = {**_run_arrays(_sharded_experiment(scenario).run(
                windows, n_windows=T_r), "scan/"),
            **_run_arrays(_sharded_experiment(
                scenario, **_event_change(scenario, "batched")).run(
                windows, n_windows=T_e), "event/")}
    ev_s = _run_arrays(_sharded_experiment(
        scenario, **_event_change(scenario, "sharded")).run(
        windows, n_windows=T_e), "event/")
    same_event_w1 = _same_arrays(ev_s, {key: v for key, v in want.items()
                                        if key.startswith("event/")})
    emit({"phase": "sharded_path", "card": card_line, "world": 1,
          "E": ex.runtime.n_sites, "k": windows[0].shape[1],
          "N": windows[0].shape[-1], "T": T,
          "windows_per_sec": rep_s.raw["windows_per_sec"],
          "windows_per_sec_scan": rep_b.raw["windows_per_sec"],
          "wan_bytes": rep_s.wan_bytes, "nrmse": rep_s.nrmse,
          "launches": launches,
          "bitwise_scan": all(same_w1.values()),
          "bitwise_event_engine": all(same_event_w1.values()),
          "compared": len(same_w1) + len(same_event_w1)})
    if launches != {"stream_stats_fleet": 2 * T, "polyfit": T}:
        raise AssertionError(f"sharded path launches {launches}, want "
                             f"stream_stats_fleet {2 * T}, polyfit {T}")
    if not (all(same_w1.values()) and all(same_event_w1.values())):
        raise AssertionError(
            "sharded path at world size 1 differs: "
            f"{[k for k, v in {**same_w1, **same_event_w1}.items() if not v]}")
    if not all(np.isfinite(v) for v in rep_s.nrmse.values()):
        raise AssertionError(f"sharded path NRMSE {rep_s.nrmse}")

    # the ranks: the kernels are built already, so they only load them
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "windows.npy"), np.stack(windows))
        t0 = time.perf_counter()
        ctx = mp.start_processes(_sharded_rank,
                                 args=(world, tmp, scenario, dict(SHARDED)),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > SHARDED["timeout_s"]:
                    raise AssertionError(
                        f"the {world} sharded ranks did not finish in "
                        f"{SHARDED['timeout_s']} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=30)
        ranks_s = time.perf_counter() - t0
        per_rank = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                info = json.load(f)
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as data:
                same = _same_arrays(dict(data), want)
            info["bitwise"] = all(same.values())
            info["differs"] = [key for key, v in same.items() if not v][:20]
            per_rank.append(info)
    emit({"phase": "sharded_path", "card": card_line, "world": world,
          "E": ex.runtime.n_sites, "T": T_r, "T_event": T_e,
          "per_rank": per_rank, "ranks_seconds": ranks_s,
          "windows_per_sec": min(r["windows_per_sec"] for r in per_rank),
          "seconds": time.perf_counter() - t_all})
    for r, info in enumerate(per_rank):
        if info["launches"] != {"stream_stats_fleet": 2 * T_r,
                                "polyfit": T_r}:
            raise AssertionError(f"rank {r} launched {info['launches']}, "
                                 f"want {2 * T_r} and {T_r}")
        if info["event_launches"] != {"stream_stats_fleet": 2 * T_e,
                                      "polyfit": T_e}:
            raise AssertionError(f"rank {r}'s event loop launched "
                                 f"{info['event_launches']}")
        if not info["bitwise"]:
            raise AssertionError(f"rank {r} of {world} differs from the "
                                 f"unsharded run: {info['differs']}")
    return {"in_process": launches,
            "ranks": {n: sum(r["launches"][n] for r in per_rank)
                      for n in launches}}


def profile_event_path(ex, windows, torch, card_line: str) -> None:
    """Profile ``EVENT["n_prof"]`` windows of the event loop: the host time
    of its plan range and of its per-site loop, and the card's busy share
    (kernel device time over the loop's wall time); the table goes to
    chiprun_out/profile_event.txt."""
    from torch.profiler import ProfilerActivity, profile
    n_prof = EVENT["n_prof"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rep = ex.run(windows, n_windows=n_prof)
        torch.cuda.synchronize()
    evs = prof.key_averages()
    with open(os.path.join(OUT_DIR, "profile_event.txt"), "w") as f:
        f.write(evs.table(sort_by="cpu_time_total", row_limit=60))
    ranges = {e.key.split("/", 1)[1]: e.cpu_time_total / 1e3 / n_prof
              for e in evs if e.key.startswith("event_loop/")
              and not str(e.device_type).endswith("CUDA")}
    on_dev = [e for e in evs if str(e.device_type).endswith("CUDA")
              and not e.key.startswith("event_loop/")]
    kernels = [e for e in on_dev if not e.key.startswith("Memcpy")]
    kernel_ms = sum(_dev_ms(e) for e in kernels)
    loop_ms = rep.raw["run_seconds"] * 1e3
    emit({"phase": "profile_event", "card": card_line,
          "file": "profile_event.txt", "windows": n_prof,
          "range_host_ms_per_window": ranges,
          "site_loop_ms_per_window": rep.raw["site_seconds"] * 1e3 / n_prof,
          "loop_ms": loop_ms,
          "kernel_ms": kernel_ms,
          "memcpy_ms": sum(_dev_ms(e) for e in on_dev
                           if e.key.startswith("Memcpy")),
          "device_busy_share": kernel_ms / loop_ms,
          "kernel_launches_per_window":
              sum(e.count for e in kernels) / n_prof})
    if "plan" not in ranges:
        raise AssertionError(f"event profile lacks its plan range: {ranges}")


def _same_leaves(a: dict, b: dict) -> bool:
    import numpy as np
    return a.keys() == b.keys() and all(
        np.array_equal(a[key], b[key], equal_nan=a[key].dtype.kind == "f")
        for key in a)


def _head_dim(m) -> int:
    return int(m.group(1))


def _type_and_tile(m) -> str:
    return f"{'float32' if m.group(1) == 'f' else 'bfloat16'}/{m.group(2)}"


# kernel -> (library, the kernel's name as ptxas mangles it, the key of an
# instantiation from that match, the keys the library must have, SASS
# opcodes it must have, opcodes it must not have)
def _builds() -> dict:
    from repro_torch.kernels.flash_attention.ops import HEAD_DIMS
    return {
        "flash_attention": ("flash_attention_sm90", r"flash_fwd_sm90ILi(\d+)E",
                            _head_dim, HEAD_DIMS, ("HGMMA",), ()),
        # f32 on the CUDA cores: FFMA, and no tensor-core product (no TF32)
        "flash_attention_f32": ("flash_attention", r"flash_fwdILi(\d+)E",
                                _head_dim, HEAD_DIMS, ("FFMA",),
                                ("HMMA", "HGMMA")),
        # one window's statistics: f32 FFMA for both input types, one
        # instantiation per (input type, tile edge)
        "stream_stats": ("stream_stats",
                         r"stream_stats_windowI(f|13__nv_bfloat16)Li(\d+)E",
                         _type_and_tile,
                         tuple(f"{t}/{e}" for t in ("float32", "bfloat16")
                               for e in (8, 16, 32, 64)),
                         ("FFMA",), ("HMMA", "HGMMA")),
    }


def build_facts(kernel: str) -> dict:
    """A kernel as built: registers and spills of each instantiation from
    ``nvcc -Xptxas -v`` (flash: by head dim; stream_stats: by input type
    and tile edge), none of which may spill, and, where the toolkit has
    ``cuobjdump``, the count of each SASS opcode the kernel must or must
    not have in its library."""
    from repro_torch.kernels import build
    lib_name, pattern, key_of, keys, need, forbid = _builds()[kernel]
    lib = build.lib_path(lib_name)
    ptxas, key = {}, None
    for ln in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in ln:
            m = re.search(pattern, ln)
            key = None if m is None else key_of(m)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and key is not None:
            ptxas.setdefault(key, {}).update(spill_stores=int(m.group(1)),
                                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and key is not None:
            ptxas.setdefault(key, {})["registers"] = int(m.group(1))
    if any(len(ptxas.get(d, {})) != 3 for d in keys):
        raise AssertionError(f"ptxas -v of {kernel} lacks instantiations "
                             f"{keys}: {ptxas}")
    spills = {d: v for d, v in ptxas.items()
              if v["spill_stores"] or v["spill_loads"]}
    if spills:
        raise AssertionError(f"{kernel} spills registers: {spills}")
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


def _dev_ms(e, total=False) -> float:
    """A profiler row's device time (ms), self or with its children."""
    name = "device_time_total" if total else "self_device_time_total"
    old = "cuda_time_total" if total else "self_cuda_time_total"
    return getattr(e, name, getattr(e, old, 0)) / 1e3


def profile_main_path(ex, windows, torch, n_prof: int = 3,
                      out_name: str = "profile_main_path.txt") -> None:
    """Profile ``n_prof`` windows of a path with torch.profiler: the time
    of each stage range of ``runtime/step.py`` and the device's busy share
    (full table in chiprun_out/<out_name>)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.step import STAGES
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rep = ex.run(windows, n_windows=n_prof)
        torch.cuda.synchronize()
    evs = prof.key_averages()
    with open(os.path.join(OUT_DIR, out_name), "w") as f:
        f.write(evs.table(sort_by="cpu_time_total", row_limit=60))
    dev_ms = _dev_ms

    # the stage ranges as the host ran them (one CPU event per range name)
    ranges = {e.key.split("/", 1)[1]: e for e in evs
              if e.key.startswith("window_step/")
              and not str(e.device_type).endswith("CUDA")}
    stages = [s_ for s_ in STAGES
              if s_ != "gate" or ex.runtime.adaptive is not None]
    missing = [s_ for s_ in stages if s_ not in ranges]
    if missing:
        raise AssertionError(f"profile lacks the step's ranges {missing}")
    host = {s_: ranges[s_].cpu_time_total / 1e3 / n_prof for s_ in stages}
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
    emit({"phase": "profile", "file": out_name, "windows": n_prof,
          "stage_host_ms_per_window": host,
          "stage_share": {s_: v / total for s_, v in host.items()},
          "stage_device_ms_per_window": {
              s_: dev_ms(ranges[s_], total=True) / n_prof for s_ in stages},
          "loop_ms": loop_ms, "kernel_ms": kernel_ms,
          "memcpy_ms": memcpy_ms,
          "device_busy_share": kernel_ms / loop_ms,
          "kernel_launches": sum(e.count for e in kernels),
          "top_kernels": [{"name": e.key[:70], "count": e.count,
                           "ms": dev_ms(e)} for e in top]})


if __name__ == "__main__":
    sys.exit(main())
