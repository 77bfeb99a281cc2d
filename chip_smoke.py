#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--profile]

Phases, each printed on its own line:

1. The card's name and power limit (``nvidia-smi``), and the build of every
   hand-written kernel from the sources in ``src/repro_torch/kernels/csrc``;
   ``[fused_sass]``: the SASS instruction, FP32 and MUFU counts per element
   of the fused sweep's sample loops (``cuobjdump -sass`` of the built
   library); the FP32 and MUFU counts set the operation side of its bounds,
   and of the square kernel's (half of them per ordered pair);
   ``[pairwise_sass]``: the same counts of the square kernel's own sample
   loop (a diagnostic; it sets no bound); ``[fused_math_probe]``: the
   sample loop's device functions against float64 on 2,000,001 points
   (``expf`` and the polynomial ``log1p_unit`` within 2 ulp).
2. Kernel against plain, on the card: the fused triangular score kernel
   against its plain torch version at odd p, ragged n, dead rows holding
   NaN, and the full widths p=85/n=10000 and p=512/n=2000;
   ``[kernel_padding]``: a zero-padded launch with ``n_valid`` bit-identical
   to the unpadded one (max abs 0), on 16-byte aligned and unaligned rows.
   A case most of whose scores lie within their tolerance of 0 is refused.
3. ``repro_torch.fit`` on a small SEM against the float64 serial oracle, and
   at the E. coli core size (p=85, n=10000) with the kernel and with the
   plain square path: equal orders, equal B and noise variances, and one
   kernel launch per find-root.
4. ``fit`` at the iJR904 slice size (p=512, n=2000): the score vector of the
   fit's first iteration against the plain version, the kernel against plain
   at every smaller stage size on Gaussian rows under the fit's mask (the
   fit's own inputs there score ~0), the fit's wall time, and the kernel's
   time per launch at m=512, beside a no-math build's (the staging, sums and
   reduce alone).
5. The batched kernel (``fused_score_batch``) against its batched plain
   version: B=8 ragged E. coli-size datasets (p 70-85, n 8000-10000, dead
   rows holding NaN) in the (128, 16384) bucket and B=2 at (512, 2048), per
   dataset within ``score_tolerance`` and with the same root; row i of a
   batched launch bit-identical to ``fused_score_vector`` on dataset i;
   its time per call at B=8 (wrapper and kernel, the sweep's device time,
   a no-math build's time, tiles skipped and sample chunks swept against a
   padded sweep's), and the wrapper's mean time per call at each stage of
   one ``fit_batch`` dispatch of that bucket (m=128, 64, 32).
6. ``fit_batch`` on that E. coli bucket: ``hopper_fused`` and ``torch`` give
   equal orders, B and noise variances, and the batched kernel runs once per
   find-root (``p_pad - 1`` launches per dispatch).
7. The serving path: ``AsyncLingamEngine`` with real threads, two dispatcher
   replicas and both buckets pre-warmed serves 8 E. coli-size and 2
   iJR904-size requests from 3 submitter threads. Every ticket resolves,
   every result is bit-identical to a replay of its recorded dispatch
   through ``fit_batch``, the stats ledger balances, ``kernel_bypass`` and
   ``auto_downgrade`` are 0; requests/s, seconds per dispatch, and one
   ``fit`` per request for comparison are printed.
8. The square moments kernel (``pairwise_moments``, ``score_backend=
   "hopper"``) against its plain version, called as the pipeline calls it
   (live-row masks, valid counts; dead rows 0, samples past the valid count
   0): ragged p=13/n=700, a non-square block, masked p=37 with n_valid on a
   padded buffer, a masked non-square block, the E. coli fit's first stage
   (m=128, n=10000, the fit's mask), Gaussian m=512 n=2000; live
   off-diagonal sums within ``pairwise_score.sum_tolerance``, dead pairs
   exactly 0, entropies within 1e-5; zero-padding of n bit-exact, and a
   padded launch with ``n_valid`` (zeros or NaN past it) bit-identical to
   the unpadded launch; row b of a masked B=8 launch at the (128, 16384)
   bucket bit-identical to a one-dataset launch; times per launch (masked,
   unmasked, a no-math build) against the live work's bound, the padded
   buffer's beside it, with the lane count and resident blocks per SM.
9. ``fit(score_backend="hopper")`` at the E. coli core size (84 launches,
   the orders of ``hopper_fused`` and ``torch``), the host driver
   ``causal_order`` with both kernels (the order of ``fit``), and
   ``fit_batch(score_backend="hopper")`` on the E. coli bucket (127
   launches, the orders of phase 6). An order may depart from another only
   at an f32 near-tie of the dense scores (``fused_score.score_tolerance``).
10. The threshold mechanism: the E. coli example's configuration (p=85,
    n=10000, seed 7, chunk 16) through ``fit`` and the host driver, equal to
    each other and to the dense order, with comparisons, rounds and host
    reads; a p=8 threshold fit against the float64 oracle;
    ``fit_batch(threshold=True)`` on the E. coli bucket against each
    dataset's own ``fit_batch``; one served round of those requests through
    ``AsyncLingamEngine(ParaLiNGAMConfig(threshold=True))``, replayed.
11. The rank-1 update kernel (paper Algorithms 7 and 8). Its TPU mode
    (``update_data``, ``update_cov``) against its plain versions at the CPU
    tests' cases, p=85/n=10000 and p=512/n=2000, with times beside an empty
    kernel's on the same grid; then that mode's own path: 84 updates along
    the E. coli fit's order through ``kernels.ops``, each step held against
    the plain versions on the same inputs. (Run right after phase 3, whose
    order they take.) Its fit mode (``rank1_update``, one launch per scan
    iteration, on the path of every fit): ``[rank1_scale_probe]`` (its
    rsqrt against torch's, bit for bit), ``[rank1_update_vs_plain]`` on the
    inputs the fits give it (the E. coli dispatch's stages m=128, 64, 32,
    the E. coli and p=512 fits, |b| at and past 1): c' bit-equal, the
    scale within ``covupdate.SCALE_ULP_TOL`` ulp, padded columns +0, in
    place = out of place; ``[rank1_update_kernel_time]`` (device, event,
    out-of-place and empty-kernel ms beside the live bytes' bound and the
    plain composition). Every fit line, ``[fit_batch_ecoli]``, the host
    driver and ``[engine]`` count its launches (p - 1 per fit, 127 per
    E. coli dispatch).
12. The SSD decode kernel against its plain version at Mamba2-370M's decode
    shape (B=4, H=32, P=64, N=128) and at ragged head counts, P not a
    multiple of the P-slice and N not a multiple of 4, new state bit-equal;
    row b of a B=4 launch bit-identical to a one-row launch (also at N=37,
    whose row views are not 16-byte aligned), a launch on inputs at a 4-byte
    offset (the scalar path) bit-identical to the aligned one, with times
    (kernel, wrapper, device); then
    Mamba2-370M at full width and depth (48 layers, vocab 50280, ~420M
    float32 weights from a seeded generator) through ``Engine.generate``:
    4 prompts of 32 tokens, 16 new tokens, 768 decode-kernel launches,
    greedy tokens equal to a CPU run of the same weights (or departing only
    at a near-tie of the CPU's top-2 logits, ``GAP_TOL``), prefill and
    decode-step seconds; the kernel against plain on the inputs of layers 0
    and 47 of a real decode step.
13. With ``--profile``: where one fit's time goes (torch.profiler device
    time by kernel, and the device's busy share), at both fit sizes and for
    the threshold fit; the torch ops and device kernels of one dense
    find-root of the E. coli bucket, and of ``fused_layout``, the plain
    version's torch prologue that the kernels now do themselves; those of
    the bucket's first update and of its whole scan per iteration, with the
    plain updates and with the update kernel (``[profile_scan_iteration]``); the
    device's busy share while the engine serves the same requests again,
    and the same for one Mamba2 ``generate``.
14. The messaging ring (``dist/ring.py``, ``dist/ring_order.py``; one card
    hosts one shard). ``[ring_block_kernel]``: the square kernel against its
    plain version on the row blocks the ring passes it at R = 2, 4, 8 and
    (P, R) = (2, 2), own against visiting rows and the reverse direction,
    at the E. coli fit's m=128 stage under its mask and at the m=512,
    n=2000 stage shape, on full n and on the two sample shards of n/2
    (whose sums add up to the full-n sums). ``[ring_ecoli]``: the E. coli
    core through ``causal_order_ring`` under an NCCL process group of one
    rank, dense and with the threshold (chunk 16), under ``hopper_fused``:
    the order of the scan with the same kernel (``hopper``), the run
    without a process group bit-equal, 84 square launches per dense order,
    ``wire`` all zero; ``[ring_fit]``: ``fit(order_backend="ring")`` with
    the scan fit's B and noise variances; ``[ring_find_root]``: the
    degenerate one-shard ``ring_find_root`` through one square launch, at
    the dense root; wall times beside the scan's there and at the iJR904
    slice (``[ring_slice]``, orders not held; its threshold run only with
    ``--profile``).
15. The attention families and the hybrid (``models/attention.py``,
    ``models/lm.py``; no hand kernel on the attention paths, the reference
    has none there). ``[granite_serve]``: granite-3-2b at full width and
    depth (40 layers, ~2.53B float32 weights from a seeded generator)
    through ``Engine.generate`` at the Mamba2 phase's shape, no kernel
    launched, two generates equal, the first 8 layers' tokens equal to a
    CPU run (or departing at a near-tie); ``[granite_serve_bf16]``: the
    same weights rounded to bfloat16, prefill logits within ``BF16_SHARE``
    of the largest float32 logit; ``[granite_serve_int8]``: the int8 KV
    cache, a decode's logits within ``INT8_SHARE`` of the largest of
    ``forward``'s, and the smoke model within the reference test's 0.05;
    ``[granite_prefill_long]``: a 1024-token prompt, blocked attention in 2
    chunks against ``causal_attention`` on layer 0; ``[gemma3_window]``:
    gemma3-12b at full width cut to one group (5 windowed layers of 1024 +
    1 global), a 2048-token prompt, the windowed blocked path and a decode
    past the window against the masked full form; ``[zamba2_serve]``:
    zamba2-2.7b at full width and depth (54 Mamba2 layers, the shared
    attention block 9 times), 864 decode-kernel launches and nothing else,
    the first group's tokens against a CPU run. With ``--profile``, the
    device's busy share of one granite and one zamba2 ``generate``.
16. MLA and MoE (``models/attention.py``'s ``mla_block``,
    ``models/moe.py``; no hand kernel, the reference has none there).
    ``[deepseek_serve]``: deepseek-v2-lite-16b at full width and depth (1
    dense MLA prologue layer + 26 MLA+MoE layers, 64 experts top-6 + 2
    shared, kv_lora 512), 15.71B bfloat16 weights from a seeded generator,
    their count against ``param_count()``, through ``Engine.generate`` at
    the serving shape: no kernel launched, two generates equal, the
    capacity's drops at the prefill (T·k = 768 > 256); ``[deepseek_cut]``:
    the prologue and the first 2 MoE groups upcast to float32, their routing
    at the prefill held on the card against the CPU, then their tokens
    against a CPU run, a departure allowed at a logit near-tie or at a
    routing near-tie (``[routing_near_tie]``: the CPU's k-th and (k+1)-th
    probabilities within ``ROUTE_TOL``) that can reach the departing row (its
    own token at a decode step; at the prefill its own tokens, or any where
    capacity drops couple the rows); ``[llama4_serve]``:
    llama4-scout-17b-a16e at full width cut to 8 of its 48 layers (listed as
    ``reduced``), 19.69B bfloat16 weights, the same checks;
    ``[llama4_moe_hold]``: its first layer's ``moe_ffn`` on the card against
    the CPU on a decode step's hidden states, within ``MOE_BF16_ULPS`` bf16
    ulps, when the host's RAM allows. With ``--profile``, the device's busy
    share of one deepseek ``generate`` and the kernels of one decode step.
17. The baselines (``core/ica_lingam.py``, ``core/poly_scores.py``).
    ``[ica_lingam]``: FastICA on the card against the CPU from the same
    start, at the E. coli core size (no convergence in 500 iterations:
    printed, not held) and on the easy p=5 SEM of the reference's test (W
    and order held), with ``fit``'s time beside it; ``[poly_scores]``: the
    polynomial scorer's times against ``find_root_dense`` under
    ``hopper_fused`` at E. coli core and the iJR904 slice, the hybrid root
    equal to the dense root.
18. A ``{"kernels": [...]}`` line with each hand kernel's launches on its
    path (the square kernel's ring launches beside them, the decode
    kernel's zamba2 launches), its error against the plain version, its
    time, the plain version's time and its bound.

``fit_batch`` phases also hold each dataset's order, B and noise variances
bit for bit against its own one-dataset ``fit_batch``.

Every failed check raises, and the script exits non-zero without printing a
result. It needs a CUDA device (it exits non-zero without one) and imports
neither JAX nor the JAX package. The last line of its output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import ctypes
import functools
import json
import math
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import direct_lingam, sem  # noqa: E402
from repro_torch.core.covariance import cov_matrix, normalize  # noqa: E402
from repro_torch.core.pairwise import fused_layout  # noqa: E402
from repro_torch.core import paralingam  # noqa: E402
from repro_torch.core.paralingam import (  # noqa: E402
    ParaLiNGAMConfig,
    causal_order,
    fit,
    fit_batch,
)
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import covupdate as cu  # noqa: E402
from repro_torch.kernels import fused_score as fs  # noqa: E402
from repro_torch.kernels import pairwise_score as ps  # noqa: E402
from repro_torch.kernels import ssd_decode as sd  # noqa: E402
from repro_torch import configs, measure  # noqa: E402
from repro_torch.core import ica_lingam as ica  # noqa: E402
from repro_torch.core import poly_scores as poly  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import embed, rmsnorm  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AsyncLingamEngine,
    BatchingConfig,
    LingamServeConfig,
)
from repro_torch.serve.buckets import bucket_dim  # noqa: E402
from repro_torch.dist.ring_order import causal_order_ring  # noqa: E402
from repro_torch.serve.lingam_engine import pack_bucket  # noqa: E402

# Kernel against plain: the same root, and per live row the error bound of
# fused_score.score_tolerance — float32 rounding of each entropy carried
# through I and S = sum min(0, I)^2. Both sides take the same float32
# formulas and differ only in the order of the sample sums (per-thread chunk
# sums vs torch's tree reduction) and of the tile sums.
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3 bytes/s,
# FP32 FLOP/s outside the tensor cores, and special-function results/s
# (132 SMs x 16 per clock x 1.98 GHz: the transcendentals' pipe).
HBM_BPS, FP32_FLOPS, SFU_OPS = 3.35e12, 67e12, 132 * 16 * 1.98e9
# FP32 instructions per second: one FFMA, FMUL or FADD per FP32 lane per
# clock (132 SMs x 128 lanes x 1.98 GHz), the FP32 peak counting an FFMA as 2.
FP32_INSNS = FP32_FLOPS / 2
# SASS counts of the fused sweep, per (unordered pair, sample) of the tile
# loop and per sample of the row-entropy loop: (FP32, MUFU) instructions,
# from ``cuobjdump -sass`` of the built library in this run (phase_sass).
SWEEP_SASS = {}
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/fused_score.cu"
KERNEL_REPLACES = "src/repro/kernels/fused_score.py:70"
BATCH_REPLACES = "src/repro/kernels/fused_score.py:208"
# The serving buckets: E. coli core size (p=85, n=10000) and the iJR904
# slice (p=512, n=2000), under LingamServeConfig's pow-2 grid.
ECOLI_BUCKET, IJR_BUCKET = (128, 16384), (512, 2048)
# The E. coli core size and the iJR904 slice of bench_table2.py, (p, n).
ECOLI, SLICE = (85, 10_000), (512, 2000)


def say(tag: str, **kw):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def normalized(x, dev):
    xn = normalize(torch.as_tensor(x, dtype=torch.float32, device=dev))
    return xn, cov_matrix(xn)


def compare(name, xn, c, mask, **kw):
    """Kernel vs plain on the card; returns the max absolute difference."""
    s_k = fs.fused_score_vector(xn, c, mask, **kw)
    s_r = fs.fused_score_vector_ref(xn, c, mask, block=kw.get("block", 8),
                                    n_valid=kw.get("n_valid"))
    torch.cuda.synchronize()
    return hold(name, s_k, s_r, xn, c, mask, kw.get("n_valid"))


def hold(name, s_k, s_r, xn, c, mask, n_valid=None):
    """One dataset's kernel scores against its plain scores: dead rows +inf,
    every live row within ``score_tolerance``, the same root, and most rows
    farther than their tolerance from 0. Returns the max absolute error."""
    check(bool(torch.all(torch.isinf(s_k[~mask]))), f"{name}: dead rows not +inf")
    k, r = s_k[mask].double(), s_r[mask].double()
    check(bool(torch.all(torch.isfinite(k))), f"{name}: non-finite live scores")
    err = (k - r).abs()
    tol = fs.score_tolerance(s_r, xn, c, mask, n_valid=n_valid)[mask].double()
    # A row whose score is within its tolerance of 0 would pass a kernel that
    # wrote zeros there; a case tests the kernel only if most rows are not so.
    held = int(torch.sum(r.abs() > tol))
    ok = bool(torch.all(err <= tol)) and int(torch.argmin(s_k)) == int(torch.argmin(s_r))
    say("kernel_vs_plain", case=name, p=xn.shape[0], n=xn.shape[1],
        max_abs=f"{err.max().item():.3e}", max_abs_over_max_S=f"{err.max().item() / r.abs().max().item():.3e}",
        max_err_over_tol=f"{(err / tol).max().item():.3e}",
        rows_above_tol=f"{held}/{r.numel()}", ok=ok)
    check(2 * held > r.numel(),
          f"{name}: most live scores are within their tolerance of 0, so the case cannot fail")
    check(ok, f"{name}: kernel disagrees with plain")
    return err.max().item()


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_kernel(dev) -> float:
    errs = []
    # odd p, ragged n, dead rows holding NaN
    xn, c = normalized(np.random.default_rng(1).standard_normal((37, 1300)), dev)
    mask = torch.arange(37, device=dev) % 5 != 2
    xn = torch.where(mask[:, None], xn, torch.nan).contiguous()
    c = torch.where(mask[:, None] & mask[None, :], c, torch.nan).contiguous()
    errs.append(compare("odd_p_dead_nan", xn, c, mask))
    # n_valid padding: the kernels stop at the valid count, so a zero-padded
    # launch gives the bits of the unpadded one (n=700 rows 16-byte aligned,
    # n=1901 rows not: the 4-byte staging path)
    diffs = []
    for p, n, n_pad, seed in ((21, 700, 1024, 2), (19, 1901, 2048, 3)):
        xn, c = normalized(np.random.default_rng(seed).standard_normal((p, n)), dev)
        xp = torch.zeros((p, n_pad), device=dev)
        xp[:, :n] = xn
        mask = torch.ones(p, dtype=torch.bool, device=dev)
        nv = torch.tensor(n, device=dev)
        errs.append(compare(f"n_valid_pad_n{n}", xp, c, mask, n_valid=nv))
        s_pad = fs.fused_score_vector(xp, c, mask, n_valid=nv).double()
        s_exact = fs.fused_score_vector(xn, c, mask).double()
        diffs.append((s_pad - s_exact).abs().max().item())
    ok = max(diffs) == 0.0
    say("kernel_padding", cases="p21_n700_pad1024,p19_n1901_pad2048",
        padded_vs_unpadded_max_abs=f"{max(diffs):.3e}".replace("0.000e+00", "0"), ok=ok)
    check(ok, "n_valid padding changed the kernel's scores")
    # full widths: the fits' SEM data, and at p=512 well-conditioned Gaussian
    # data (the p=512 SEM holds near-collinear pairs whose scores are f32
    # noise). Gaussian data at n=10000 has scores ~1e-9, below the float32
    # rounding of the entropies they come from, so it cannot be held.
    for p, n, seed in ((85, 10_000, 0), (512, 2000, 1)):
        x = sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=seed))["x"]
        cases = [(f"sem_p{p}_n{n}", x)]
        if p == 512:
            cases.append((f"gauss_p{p}_n{n}", gauss_data(p, n, seed)))
        for name, data in cases:
            xn, c = normalized(data, dev)
            errs.append(compare(name, xn, c,
                                torch.ones(xn.shape[0], dtype=torch.bool, device=dev)))
    return max(errs)


def gauss_data(p, n, seed):
    return np.random.default_rng(seed).standard_normal((p, n))


def phase_sass():
    """The fused sweep's instruction counts from the SASS of its built
    library: the tile loop per (unordered pair, sample), both directions
    (4 libdevice ``expf`` = 4 MUFU.EX2 each), and the row-entropy loop per
    sample (2 EX2). Their FP32 arithmetic and MUFU counts set the operation
    side of the kernels' bounds (the square kernel's too, at half the tile
    loop's per ordered pair); loads, integer address arithmetic, moves and
    loop control are printed, not counted. Then the square kernel's own
    loop, per (ordered pair, sample)."""
    sass = measure.dump(_build.library_path("fused_score"))
    for key, kernel, ex2 in (("tiles", "fused_tri_tiles", 4), ("rows", "row_entropies", 2)):
        got = measure.sample_loop(sass, kernel, ex2)
        SWEEP_SASS[key] = (got.fp32, got.mufu)
        hist = ",".join(f"{k}:{v}" for k, v in got.loop.histogram().most_common())
        say("fused_sass", kernel=kernel, instructions_per_element=f"{got.instructions:g}",
            fp32_per_element=f"{got.fp32:g}", mufu_per_element=f"{got.mufu:g}",
            loop_instructions=len(got.loop.ops), ops=hist)
    # The square kernel's sample loop per (ordered pair, sample): one
    # direction of the fused loop's math (2 EX2). Printed, not counted.
    got = measure.sample_loop(measure.dump(_build.library_path("pairwise_moments")),
                              "pairwise_moments_tiles", 2)
    hist = ",".join(f"{k}:{v}" for k, v in got.loop.histogram().most_common())
    tf, tm = SWEEP_SASS["tiles"]
    say("pairwise_sass", kernel="pairwise_moments_tiles",
        instructions_per_element=f"{got.instructions:g}", fp32_per_element=f"{got.fp32:g}",
        mufu_per_element=f"{got.mufu:g}", loop_instructions=len(got.loop.ops), ops=hist,
        fused_fp32_per_direction=f"{tf / 2:g}", fused_mufu_per_direction=f"{tm / 2:g}")


def sweep_bound_ms(pair_samples: float, row_samples: float, bytes_moved: float):
    """(bound, bytes, FP32, SFU) ms of the fused sweep on this much work:
    the live (unordered pair, sample) elements of the tiles, the live (row,
    sample) elements of the row entropies, the bytes read once."""
    (tf, tm), (rf, rm) = SWEEP_SASS["tiles"], SWEEP_SASS["rows"]
    t_bytes = bytes_moved / HBM_BPS * 1e3
    t_fp32 = (tf * pair_samples + rf * row_samples) / FP32_INSNS * 1e3
    t_sfu = (tm * pair_samples + rm * row_samples) / SFU_OPS * 1e3
    return max(t_bytes, t_fp32, t_sfu), t_bytes, t_fp32, t_sfu


# The sample loop's share of a kernel's time, measured: a build of a kernel
# source whose log cosh and u exp(-u^2/2) return their argument, with a copy
# of the shared header edited by text substitution, both written into the
# git-ignored build directory (the sources have no such variant). What it
# leaves is the staging, residuals, sums and reduce.
NO_MATH = (("  return a + log1p_unit(expf(-2.f * a)) - kLn2;", "  return u;"),
           ("  return u * expf(-0.5f * (u * u));", "  return u;"))
MATH_HEADER = "lingam_math.cuh"


@functools.cache
def no_math_library(name: str):
    """The no-math build of ``csrc/<name>.cu``, loaded."""
    header = (_build.CSRC / MATH_HEADER).read_text()
    for old, new in NO_MATH:
        check(old in header, f"no-math build: {old!r} is not in {MATH_HEADER}")
        header = header.replace(old, new)
    out = _build.BUILD_DIR / "no_math"
    out.mkdir(parents=True, exist_ok=True)
    (out / MATH_HEADER).write_text(header)  # found first: beside the source
    (out / f"{name}.cu").write_text((_build.CSRC / f"{name}.cu").read_text())
    lib = out / f"lib{name}_no_math.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(out / f"{name}.cu")],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))


def no_math_ms(fn, reps: int, module=fs) -> float:
    """``fn``'s time per call with the no-math build of ``module``'s kernel
    library in place of the real one (its results are not read)."""
    name, symbol = {fs: ("fused_score", "fused_score_launch"),
                    ps: ("pairwise_moments", "pairwise_moments_launch")}[module]
    real = module._entry
    bare = getattr(no_math_library(name), symbol)
    bare.argtypes, bare.restype = real().argtypes, ctypes.c_int
    module._entry = lambda: bare
    try:
        return time_ms(fn, reps)
    finally:
        module._entry = real


def ulps(got, want64):
    """|got - want| in units of the float32 spacing at want (float64)."""
    w32 = want64.float()
    spacing = (torch.nextafter(w32.abs(), torch.tensor(torch.inf, device=w32.device))
               - w32.abs()).double()
    return (got.double() - want64).abs() / spacing


def phase_math_probe(dev):
    """The sample loop's device functions against float64 on 2,000,001
    points u in [-60, 60]: libdevice ``expf`` of -2|u| and the kernel's
    polynomial ``log1p_unit`` of that float32 value, each within 2 ulp;
    log cosh of +-0 exactly 0 (the kernel has no select for it); and
    log cosh u and u exp(-u^2/2), whose float64 values they approximate
    through the formula the plain version shares (printed, not held: near
    u = 0, |u| + log1p(e) - log 2 cancels in every float32 implementation)."""
    u = torch.linspace(-60, 60, 2_000_001, dtype=torch.float64, device=dev).float()
    e, l1p, lc, ue = fs.math_probe(u)
    u64 = u.double()
    a = u64.abs()
    err_exp = ulps(e, torch.exp(-2 * a)).max().item()
    err_l1p = ulps(l1p, torch.log1p(e.double())).max().item()
    lc64 = a + torch.log1p(torch.exp(-2 * a)) - np.log(2.0)
    lc_abs = (lc.double() - lc64).abs().max().item()
    ue_abs = (ue.double() - u64 * torch.exp(-0.5 * u64 * u64)).abs().max().item()
    zero = fs.math_probe(torch.tensor([0.0, -0.0], device=dev))[2]
    ok = err_exp <= 2 and err_l1p <= 2 and bool(torch.all(zero == 0))
    say("fused_math_probe", points=u.numel(), expf_max_ulp=f"{err_exp:.3f}",
        log1p_unit_max_ulp=f"{err_l1p:.3f}", log_cosh_max_abs=f"{lc_abs:.3e}",
        u_exp_max_abs=f"{ue_abs:.3e}", log_cosh_at_0=f"{zero.abs().max().item():g}", ok=ok)
    check(ok, "a device function of the sample loop is more than 2 ulp from float64, "
              "or log cosh 0 is not exactly 0")


def fit_stage_inputs(x, dev):
    """Fit once with ``hopper_fused`` and keep the find-root inputs of the
    first iteration of every stage, keyed by the stage's buffer size."""
    captured = {}
    orig = ops.score_vector

    def spy(xn, c, mask, **kw):
        if xn.shape[0] not in captured:
            captured[xn.shape[0]] = (xn.clone(), c.clone(), mask.clone())
        return orig(xn, c, mask, **kw)

    ops.score_vector = spy
    try:
        res, _, seconds, _, _ = run_fit(x, "hopper_fused", dev)
    finally:
        ops.score_vector = orig
    return captured, res, seconds


def run_fit(x, backend, dev, **kw):
    """One ``fit``: (result, B, seconds, fused-kernel launches, update-kernel
    launches), the counts set to 0 just before it."""
    fs.LAUNCHES = cu.RANK1_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, b = fit(x, ParaLiNGAMConfig(score_backend=backend, **kw), device=dev)
    torch.cuda.synchronize()
    return res, b, time.perf_counter() - t0, fs.LAUNCHES, cu.RANK1_LAUNCHES


def phase_fit_small(dev):
    data = sem.generate(sem.SemSpec(p=8, n=2500, density="sparse", seed=0))
    res, b, _, launches, updates = run_fit(data["x"], "auto", dev, min_bucket=8)
    oracle = direct_lingam.causal_order(data["x"])
    say("fit_small", p=8, n=2500, order_equals_f64_oracle=res.order == oracle,
        launches=launches, update_launches=updates)
    check(res.order == oracle, "fit order differs from the float64 oracle at p=8")
    check(launches == 7 and updates == 7,
          "fit did not run the score and update kernels once per iteration")
    check(bool(torch.all(torch.isfinite(b))) and tuple(b.shape) == (8, 8),
          "B is not a finite (8, 8) matrix")


def phase_fit_core(dev, gpu) -> float:
    p, n = ECOLI
    data = sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=0))
    captured, warm, _ = fit_stage_inputs(data["x"], dev)
    res_k, b_k, t_k, launches, updates = run_fit(data["x"], "hopper_fused", dev)
    res_p, b_p, t_p, _, plain_updates = run_fit(data["x"], "torch", dev)
    same = res_k.order == res_p.order
    b_err = (b_k - b_p).abs().max().item()
    nv_err = float(np.max(np.abs(res_k.noise_var / res_p.noise_var - 1)))
    say("fit_ecoli_core", p=p, n=n, orders_equal=same, b_max_abs_diff=b_err,
        noise_var_max_rel_diff=nv_err, launches=launches, find_roots=p - 1,
        update_launches=updates, update_launches_torch=plain_updates,
        valid_order=sem.is_valid_causal_order(res_k.order, data["b_true"]),
        fit_s_hopper_fused=f"{t_k:.3f}", fit_s_torch=f"{t_p:.3f}", gpu=f"'{gpu}'")
    check(same, "hopper_fused and torch orders differ at p=85")
    # Same order and same raw data: phase 2 sees identical inputs.
    check(b_err <= 1e-6 and nv_err <= 1e-6, "B or noise_var differ at p=85")
    check(launches == p - 1, f"{launches} kernel launches for {p - 1} find-roots")
    check(updates == p - 1 and plain_updates == 0,
          f"{updates} update launches for {p - 1} iterations ({plain_updates} on torch)")
    check(res_k.order == warm.order, "two fits of the same data gave different orders")
    check(bool(torch.all(torch.isfinite(b_k))) and np.all(np.isfinite(res_k.noise_var)),
          "non-finite B or noise variances")
    err = max(compare(f"fit85_stage_m{m}", *captured[m]) for m in sorted(captured, reverse=True))
    return err, {"x": data["x"], "hopper_fused": (res_k, b_k, t_k), "torch": (res_p, b_p, t_p)}


def phase_fit_slice(dev, gpu):
    """Returns (launches, max_abs_err, kernel ms, plain ms, bound ms, extra)."""
    p, n = 512, 2000
    x = sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=1))["x"]
    captured, warm, t_warm = fit_stage_inputs(x, dev)  # the warm-up fit
    res, b, t_fit, launches, updates = run_fit(x, "hopper_fused", dev)  # the main path
    say("fit_ijr904_slice", p=p, n=n, launches=launches, find_roots=p - 1,
        update_launches=updates,
        fit_s=f"{t_fit:.4f}", warmup_fit_s=f"{t_warm:.4f}",
        same_order_as_warmup=res.order == warm.order, gpu=f"'{gpu}'")
    check(launches == p - 1 and updates == p - 1,
          f"{launches} kernel and {updates} update launches for {p - 1} iterations")
    check(res.order == warm.order, "two fits of the same data gave different orders")
    check(bool(torch.all(torch.isfinite(b))), "non-finite B at p=512")
    # The fit's own find-root inputs are held at m=512 only: from the m=256
    # stage on, this SEM's live correlations are all +-1 in float32 and every
    # score is ~0, a comparison that cannot fail. The smaller stages are held
    # on Gaussian rows cut to the stage size, under the fit's mask there.
    errs = [compare(f"fit512_stage_m{p}", *captured[p])]
    gauss = gauss_data(p, n, 1)
    for m in sorted((m for m in captured if m < p), reverse=True):
        xn, c, mask = captured[m]
        s_fit = fs.fused_score_vector_ref(xn, c, mask)[mask]
        say("fit512_stage_degenerate", m=m, live=int(mask.sum()),
            max_abs_S=f"{s_fit.abs().max().item():.3e}", held=False)
        xn, c = normalized(gauss[:m], dev)
        xn = torch.where(mask[:, None], xn, torch.nan).contiguous()
        c = torch.where(mask[:, None] & mask[None, :], c, torch.nan).contiguous()
        errs.append(compare(f"gauss_stage_m{m}", xn, c, mask))

    xn, c, mask = captured[p]
    ms = time_ms(lambda: fs.launch(xn, c, mask), reps=50)
    wrapper_ms = time_ms(lambda: fs.fused_score_vector(xn, c, mask), reps=20)
    tiles_ms = device_ms(lambda: fs.launch(xn, c, mask), "fused_tri_tiles", reps=10)
    bare_ms = no_math_ms(lambda: fs.launch(xn, c, mask), reps=50)
    plain_ms = time_ms(lambda: fs.fused_score_vector_ref(xn, c, mask), reps=3, warmup=1)
    live = int(mask.sum())
    bytes_moved = 4 * (live * n + live * live + live) + p  # x, c, S once; mask
    bound, t_bytes, t_fp32, t_sfu = sweep_bound_ms(live * (live - 1) / 2 * n, live * n,
                                                   bytes_moved)
    tiles = measure.live_tiles(mask[None], 8)
    swept, padded = measure.sweep_chunks(mask[None], None, n, 8)
    say("kernel_time", p=p, n=n, block=8, kernel_ms=f"{ms:.4f}",
        wrapper_ms=f"{wrapper_ms:.4f}", tiles_device_ms=f"{tiles_ms:.4f}",
        no_math_kernel_ms=f"{bare_ms:.4f}",
        plain_ms=f"{plain_ms:.3f}", bound_ms=f"{bound:.4f}", bytes_bound_ms=f"{t_bytes:.5f}",
        fp32_bound_ms=f"{t_fp32:.4f}", sfu_bound_ms=f"{t_sfu:.4f}",
        kernel_fraction_of_bound=f"{bound / ms:.3f}",
        tiles_skipped=f"{tiles.numel() - int(tiles.sum())}/{tiles.numel()}",
        chunks_swept=f"{swept}/{padded}", gpu=f"'{gpu}'")
    return launches, max(errs), ms, plain_ms, bound, wrapper_ms

SERVE_CFG = LingamServeConfig(max_batch=8)


def ecoli_requests():
    """8 ragged E. coli-size SEM datasets (p 70-85, n 8193-10000: all in the
    (128, 16384) bucket)."""
    rng = np.random.default_rng(13)
    shapes = [(int(rng.integers(70, 86)), int(rng.integers(8193, 10_001)))
              for _ in range(8)]
    return [sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=100 + i))["x"]
            for i, (p, n) in enumerate(shapes)]


def ijr_requests():
    """2 iJR904-size SEM datasets: the slice of bench_table2.py and a ragged one."""
    return [sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=seed))["x"]
            for p, n, seed in ((512, 2000, 1), (480, 1950, 3))]


def bucket_inputs(raw, bucket, dev, dead=torch.nan):
    """The batched kernels' inputs for ``raw`` datasets packed into a bucket:
    rows normalized on the card with each dataset's valid count, and dead
    rows holding ``dead`` in xn and c (NaN: the fused kernel must never read
    them; 0: what the pipeline gives the square kernel)."""
    xs, mask, nv, _ = pack_bucket(raw, *bucket)
    x, mk, n_valid = (torch.from_numpy(a).to(dev) for a in (xs, mask, nv))
    xn = torch.where(mk[..., None], normalize(x, n_valid=n_valid), 0.0)
    c = cov_matrix(xn, n_valid=n_valid)
    xn = torch.where(mk[..., None], xn, dead).contiguous()
    c = torch.where(mk[:, :, None] & mk[:, None, :], c, dead).contiguous()
    return xn, c, mk, n_valid


def phase_batch_kernel(dev, gpu):
    """(a) The batched kernel against its batched plain version. Returns
    (max_abs_err, kernel ms, wrapper ms, plain ms, bound ms, padded bound ms,
    the timed case's shape)."""
    gauss = gauss_data(500, 1900, 4)
    cases = (("ecoli_b8", ecoli_requests(), ECOLI_BUCKET),
             ("ijr904_b2", [ijr_requests()[0], gauss], IJR_BUCKET))
    errs, timing = [], None
    for name, raw, bucket in cases:
        xb, cb, mb, nv = bucket_inputs(raw, bucket, dev)
        s_k = fs.fused_score_batch(xb, cb, mb, n_valid=nv)
        s_r = fs.fused_score_batch_ref(xb, cb, mb, n_valid=nv)
        torch.cuda.synchronize()
        for i in range(len(raw)):
            errs.append(hold(f"{name}[{i}]", s_k[i], s_r[i], xb[i], cb[i], mb[i], nv[i]))
        # Row i of a batched launch is bit-identical to the one-dataset
        # wrapper on dataset i (the prologue is in the kernels), and
        # repeated launches agree.
        rows = [torch.equal(s_k[i], fs.fused_score_vector(xb[i], cb[i], mb[i], n_valid=nv[i]))
                for i in range(len(raw))]
        repeat = torch.equal(fs.fused_score_batch(xb, cb, mb, n_valid=nv), s_k)
        say("batch_row_invariance", case=name, B=len(raw),
            rows_bit_identical=f"{sum(rows)}/{len(rows)}", repeat_bit_identical=repeat)
        check(all(rows), f"{name}: a batched row differs from its one-dataset launch")
        check(repeat, f"{name}: two launches on the same inputs differ")
        if timing is None:
            bsz, _, n_pad = xb.shape
            nv32 = nv.to(torch.int32)
            ms = time_ms(lambda: fs.launch_batch(xb, cb, mb, nv32), reps=20)
            wrapper_ms = time_ms(lambda: fs.fused_score_batch(xb, cb, mb, n_valid=nv), reps=20)
            tiles_ms = device_ms(lambda: fs.launch_batch(xb, cb, mb, nv32), "fused_tri_tiles",
                                 reps=10)
            bare_ms = no_math_ms(lambda: fs.launch_batch(xb, cb, mb, nv32), reps=20)
            plain_ms = time_ms(lambda: fs.fused_score_batch_ref(xb, cb, mb, n_valid=nv),
                               reps=2, warmup=1)
            # What these inputs need: every live pair and live row of each
            # dataset over its valid samples, at the SASS-counted
            # instructions and MUFU per element; the live data read once.
            live_p, nvd = mb.sum(dim=1).double(), nv.double()
            bytes_moved = float((4 * (live_p * nvd + live_p * live_p + live_p)).sum())
            bound, t_bytes, t_fp32, t_sfu = sweep_bound_ms(
                float((live_p * (live_p - 1) / 2 * nvd).sum()), float((live_p * nvd).sum()),
                bytes_moved)
            p_pad = xb.shape[1]
            padded = sweep_bound_ms(bsz * p_pad * (p_pad - 1) / 2 * n_pad, bsz * p_pad * n_pad,
                                    0.0)[0]
            tiles = measure.live_tiles(mb, 8)
            swept, all_chunks = measure.sweep_chunks(mb, nv, n_pad, 8)
            say("batch_kernel_time", case=name, B=bsz, bucket=f"{tuple(xb.shape[1:])}",
                kernel_ms=f"{ms:.4f}", wrapper_ms=f"{wrapper_ms:.4f}",
                tiles_device_ms=f"{tiles_ms:.4f}", no_math_kernel_ms=f"{bare_ms:.4f}",
                plain_ms=f"{plain_ms:.3f}",
                bound_ms=f"{bound:.4f}", bytes_bound_ms=f"{t_bytes:.5f}",
                fp32_bound_ms=f"{t_fp32:.4f}", sfu_bound_ms=f"{t_sfu:.4f}",
                bound_ms_padded_buffer=f"{padded:.4f}",
                kernel_fraction_of_bound=f"{bound / ms:.3f}",
                tiles_skipped=f"{tiles.numel() - int(tiles.sum())}/{tiles.numel()}",
                chunks_swept=f"{swept}/{all_chunks}", gpu=f"'{gpu}'")
            live_p, live_n = live_p.long(), nv.long()
            shape = (f"B={bsz},bucket={xb.shape[1]}x{n_pad},"
                     f"p={int(live_p.min())}-{int(live_p.max())},"
                     f"n={int(live_n.min())}-{int(live_n.max())},block=8")
            timing = (ms, wrapper_ms, plain_ms, bound, padded, shape)
            stage_times(name, raw, bucket, dev, gpu)
    return (max(errs), *timing)


def stage_times(name, raw, bucket, dev, gpu):
    """The fused wrapper's mean time per call at each stage size m of one
    ``fit_batch`` dispatch of ``raw`` in ``bucket``, on the inputs that
    dispatch gave it: every call of the stage once per repetition."""
    xs, mask, nv, _ = pack_bucket(raw, *bucket)
    calls, orig = {}, ops.score_batch

    def spy(x, c, m, **kw):
        calls.setdefault(x.shape[1], []).append(
            (x.clone(), c.clone(), m.clone(),
             {k: v.clone() if torch.is_tensor(v) else v for k, v in kw.items()}))
        return orig(x, c, m, **kw)

    ops.score_batch = spy
    try:
        fit_batch(xs, ParaLiNGAMConfig(score_backend="hopper_fused"), n_valid=nv, mask=mask,
                  device=dev)
    finally:
        ops.score_batch = orig
    for m, group in sorted(calls.items(), reverse=True):
        def run(group=group):
            for x, c, mk, kw in group:
                fs.fused_score_batch(x, c, mk, **kw)
        ms = time_ms(run, reps=3, warmup=1) / len(group)
        say("batch_stage_time", case=name, m=m, calls=len(group), wrapper_ms=f"{ms:.4f}",
            stage_ms=f"{ms * len(group):.3f}", gpu=f"'{gpu}'")


def phase_fit_batch(dev, gpu):
    """(b) ``fit_batch`` on the E. coli bucket with the kernel and with the
    plain square path. Returns each request's order."""
    raw = ecoli_requests()
    xs, mask, nv, _ = pack_bucket(raw, *ECOLI_BUCKET)
    runs = {}
    for backend in ("hopper_fused", "torch"):
        fs.BATCH_LAUNCHES = cu.RANK1_LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit_batch(xs, ParaLiNGAMConfig(score_backend=backend), n_valid=nv,
                        mask=mask, device=dev)
        orders = res.orders.cpu().numpy()
        torch.cuda.synchronize()
        runs[backend] = (res, orders, time.perf_counter() - t0, fs.BATCH_LAUNCHES,
                         cu.RANK1_LAUNCHES)
    (rk, ok_, tk, launches, updates), (rp, op_, tp_, _, plain_updates) = (
        runs["hopper_fused"], runs["torch"])
    p_live = [x.shape[0] for x in raw]
    same = [list(ok_[i, :p]) == list(op_[i, :p]) for i, p in enumerate(p_live)]
    b_err = (rk.b - rp.b).abs().max().item()
    nv_err = ((rk.noise_var - rp.noise_var).abs() / rp.noise_var.abs().clamp(min=1e-30)).max().item()
    finite = bool(torch.isfinite(rk.b).all() and torch.isfinite(rk.noise_var).all())
    say("fit_batch_ecoli", B=len(raw), bucket=f"{ECOLI_BUCKET}", orders_equal=f"{sum(same)}/{len(same)}",
        b_max_abs_diff=b_err, noise_var_max_rel_diff=nv_err, launches=launches,
        find_roots=ECOLI_BUCKET[0] - 1, update_launches=updates,
        update_launches_torch=plain_updates, fit_batch_s_hopper_fused=f"{tk:.4f}",
        fit_batch_s_torch=f"{tp_:.4f}", gpu=f"'{gpu}'")
    check(all(same), "hopper_fused and torch orders differ in the E. coli bucket")
    check(b_err <= 1e-6 and nv_err <= 1e-6, "B or noise_var differ between the backends")
    check(launches == ECOLI_BUCKET[0] - 1,
          f"{launches} batched launches for {ECOLI_BUCKET[0] - 1} find-roots")
    check(updates == ECOLI_BUCKET[0] - 1 and plain_updates == 0,
          f"{updates} update launches for {ECOLI_BUCKET[0] - 1} iterations "
          f"({plain_updates} on torch)")
    check(finite, "non-finite B or noise variances in the E. coli bucket")
    # Each dataset's order, B and noise variances equal, bit for bit, those
    # of its own one-dataset fit_batch on the same padded inputs.
    differ = batch_differences(rk, xs, mask, nv, ParaLiNGAMConfig(score_backend="hopper_fused"),
                               p_live, ("orders",), dev)
    say("fit_batch_rows", B=len(raw), equal_to_own_fit_batch=f"{len(raw) - len({d.split(':')[0] for d in differ})}/{len(raw)}",
        first_differences=",".join(differ) or "none")
    check(not differ, "a dataset's fit differs between its batch and its own")
    return [list(ok_[i, :p]) for i, p in enumerate(p_live)]


def batch_differences(res, xs, mask, nv, cfg, p_live, names, dev):
    """Where each dataset's results in the batched ``res`` differ from its
    own one-dataset ``fit_batch`` on the same padded inputs: the per-
    iteration ``names`` (first differing iteration), then B and the noise
    variances on its live rows, bit for bit. Returns "i:field@index" items."""
    got = {k: getattr(res, k).cpu().numpy() for k in names}
    b, omega = res.b.cpu().numpy(), res.noise_var.cpu().numpy()
    differ = []
    for i, p in enumerate(p_live):
        one = fit_batch(xs[i:i + 1], cfg, n_valid=nv[i:i + 1], mask=mask[i:i + 1], device=dev)
        want = {k: getattr(one, k).cpu().numpy()[0] for k in names}
        differ += [f"{i}:{k}@{int(np.flatnonzero(got[k][i, :p] != want[k][:p])[0])}"
                   for k in names if list(got[k][i, :p]) != list(want[k][:p])]
        b1, om1 = one.b.cpu().numpy()[0], one.noise_var.cpu().numpy()[0]
        if not np.array_equal(b[i, :p, :p], b1[:p, :p]):
            differ.append(f"{i}:b@{float(np.abs(b[i, :p, :p] - b1[:p, :p]).max()):.3e}")
        if not np.array_equal(omega[i, :p], om1[:p]):
            differ.append(f"{i}:noise_var@{float(np.abs(omega[i, :p] / om1[:p] - 1).max()):.3e}")
    return differ


def conserved(st) -> bool:
    return (st["submitted"] == st["admitted"] + st["shed"] + st["rejected"] + st["quarantined"]
            and st["admitted"] == st["delivered"] + st["timeouts"] + st["failed"]
            + st["queue_depth"] + st["in_flight"])


def serve_round(eng, requests, threads=3):
    """Submit ``requests`` from ``threads`` submitter threads; wait for every
    ticket. Returns (results, wall seconds)."""
    tickets, errors = [None] * len(requests), []

    def submitter(w):
        try:
            for i in range(w, len(requests), threads):
                tickets[i] = eng.submit(requests[i])
        except Exception as e:  # noqa: BLE001 — reported through `errors`
            errors.append(repr(e))

    t0 = time.perf_counter()
    pool = [threading.Thread(target=submitter, args=(w,)) for w in range(threads)]
    for th in pool:
        th.start()
    for th in pool:
        th.join(600)
    check(not errors and all(not th.is_alive() for th in pool), f"submit failed: {errors}")
    results = [t.result(600) for t in tickets]
    return results, time.perf_counter() - t0


def reset_counts():
    """Every kernel wrapper's launch count to 0."""
    fs.LAUNCHES = fs.BATCH_LAUNCHES = ps.LAUNCHES = ps.BATCH_LAUNCHES = 0
    cu.DATA_LAUNCHES = cu.COV_LAUNCHES = cu.RANK1_LAUNCHES = sd.LAUNCHES = 0


def counts() -> dict:
    return {"fused_score": fs.LAUNCHES, "fused_score_batch": fs.BATCH_LAUNCHES,
            "pairwise_moments": ps.LAUNCHES, "pairwise_moments_batch": ps.BATCH_LAUNCHES,
            "update_data": cu.DATA_LAUNCHES, "update_cov": cu.COV_LAUNCHES,
            "rank1_update": cu.RANK1_LAUNCHES, "ssd_decode": sd.LAUNCHES}


def engine_round(cfg, requests, dev, *, replicas=1, prewarm=None, profile=False):
    """Serve ``requests`` once through an ``AsyncLingamEngine`` whose
    dispatch seam records every dispatch. Returns (results, wall seconds,
    stats, the served dispatch records, prewarm seconds, kernel launches of
    the served round, profiler rows of a second round or None)."""
    records, mu, holder = [], threading.Lock(), {}

    def recording(bucket, payloads):
        t0 = time.perf_counter()
        out = holder["eng"]._device_dispatch(bucket, payloads)
        with mu:
            records.append((bucket, list(payloads), out, time.perf_counter() - t0))
        return out

    # A bucket flushes when it holds 8 requests, or 1 s after its oldest one
    # arrived: the submitters validate each dataset first (~0.1 s each).
    t0 = time.perf_counter()
    eng = AsyncLingamEngine(
        cfg, SERVE_CFG, batch_cfg=BatchingConfig(max_batch=8, max_queue=64, flush_interval=1.0),
        dispatch=recording, replicas=replicas, prewarm=prewarm, device=dev)
    holder["eng"] = eng
    prewarm_s = time.perf_counter() - t0
    try:
        reset_counts()
        paralingam.reset_dispatch_stats()
        results, wall = serve_round(eng, requests)  # the main path
        launches = counts()
        st = eng.stats()
        st["rank1_update"] = paralingam.dispatch_stats_snapshot()["rank1_update"]
        busy = None
        if profile:
            from torch.profiler import ProfilerActivity, profile as prof_ctx

            with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _, wall2 = serve_round(eng, requests)
            busy = (device_rows(prof), wall2)
    finally:
        eng.close(timeout=120)
    check(all(r is not None for r in results), "a ticket did not resolve")
    check(conserved(st), f"stats ledger does not balance: {st}")
    check(st["delivered"] == len(requests), f"{st['delivered']} of {len(requests)} delivered")
    check(st["kernel_bypass"] == 0, f"kernel_bypass={st['kernel_bypass']}")
    return results, wall, st, records[:st["dispatches"]], prewarm_s, launches, busy


def replay_identical(served, cfg, dev) -> int:
    """How many served results are bit-identical to a replay of their
    recorded dispatch through ``fit_batch``."""
    ok = 0
    for bucket, payloads, out, _ in served:
        xs, mask, nv, exact = pack_bucket(payloads, *bucket)
        seams = {} if exact else dict(n_valid=nv, mask=mask)
        res = fit_batch(xs, cfg, device=dev, **seams)
        orders, b, omega = res.orders.cpu().numpy(), res.b.cpu().numpy(), res.noise_var.cpu().numpy()
        comps, rounds = res.comparisons.cpu().numpy(), res.rounds.cpu().numpy()
        for i, (x, f) in enumerate(zip(payloads, out)):
            p = x.shape[0]
            ok += (list(orders[i, :p]) == f.order and np.array_equal(b[i, :p, :p], f.b)
                   and np.array_equal(omega[i, :p], f.noise_var)
                   and int(comps[i, :p - 1].sum()) == f.comparisons
                   and int(rounds[i, :p - 1].sum()) == f.rounds)
    return ok


def phase_engine(dev, gpu, batch_orders, profile: bool):
    """(c) The serving path on the card. Returns the batched kernel's
    launches in the served run."""
    ecoli, ijr = ecoli_requests(), ijr_requests()
    requests = ecoli + ijr
    cfg = ParaLiNGAMConfig()
    results, wall, st, served, prewarm_s, launched, busy = engine_round(
        cfg, requests, dev, replicas=2, prewarm=[(85, 10_000), (512, 2000)], profile=profile)
    launches, vec_launches = launched["fused_score_batch"], launched["fused_score"]
    updates = launched["rank1_update"]
    dispatch_s = [f"{r[0]}x{len(r[1])}:{r[3]:.4f}" for r in served]
    say("engine", requests=len(requests), dispatches=st["dispatches"], prewarm_s=f"{prewarm_s:.2f}",
        prewarm_buckets=st["prewarm"]["buckets"], wall_s=f"{wall:.4f}",
        requests_per_s=f"{len(requests) / wall:.3f}", seconds_per_dispatch=",".join(dispatch_s),
        launches=launches, update_launches=updates,
        dispatch_stats_rank1_update=st["rank1_update"], kernel_bypass=st["kernel_bypass"],
        gpu=f"'{gpu}'")
    check(st["auto_downgrade"] == 0, f"auto_downgrade={st['auto_downgrade']}")
    want = sum(r[0][0] - 1 for r in served)
    check(launches == want and vec_launches == 0,
          f"{launches} batched launches (want {want}), {vec_launches} one-dataset launches")
    check(updates == want == st["rank1_update"],
          f"{updates} update launches, {st['rank1_update']} counted by dispatch_stats "
          f"(want {want})")

    # Each result is bit-identical to a replay of its recorded dispatch.
    replay_ok = replay_identical(served, cfg, dev)
    say("engine_replay", results_bit_identical_to_replay=f"{replay_ok}/{len(requests)}")
    check(replay_ok == len(requests), "a served result differs from the replay of its dispatch")
    same_as_b = sum(res.order == o for res, o in zip(results[:len(ecoli)], batch_orders))
    say("engine_vs_fit_batch", ecoli_orders_equal_to_phase_b=f"{same_as_b}/{len(ecoli)}",
        held=False)
    for res in results:
        check(np.isfinite(res.b).all() and np.isfinite(res.noise_var).all(),
              "non-finite B or noise variances served")

    # One fit per request, for comparison: the whole round, and the E. coli
    # requests against the seconds of their bucket's dispatches.
    serial = []
    for x in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit(x, cfg, device=dev)
        torch.cuda.synchronize()
        serial.append(time.perf_counter() - t0)
    serial_ecoli = sum(serial[:len(ecoli)])
    ecoli_s = sum(r[3] for r in served if r[0] == ECOLI_BUCKET)
    say("engine_vs_serial_fit", requests=len(requests), serial_fit_s=f"{sum(serial):.4f}",
        serial_requests_per_s=f"{len(requests) / sum(serial):.3f}",
        engine_requests_per_s=f"{len(requests) / wall:.3f}",
        ecoli_serial_fit_s=f"{serial_ecoli:.4f}",
        ecoli_serial_requests_per_s=f"{len(ecoli) / serial_ecoli:.3f}",
        ecoli_dispatch_s=f"{ecoli_s:.4f}",
        ecoli_batched_requests_per_s=f"{len(ecoli) / ecoli_s:.3f}",
        ecoli_speedup=f"{serial_ecoli / ecoli_s:.2f}", gpu=f"'{gpu}'")
    if busy is not None:
        rows, wall2 = busy
        busy_us = sum(r[0] for r in rows)
        say("profile_engine", requests=len(requests), wall_s=f"{wall2:.4f}",
            device_busy_s=f"{busy_us / 1e6:.4f}", device_busy_share=f"{busy_us / 1e6 / wall2:.3f}",
            gpu=f"'{gpu}'")
        say_rows("engine", rows, busy_us)
    return launches, updates


def device_rows(prof):
    """(device us, kernel name, calls) of a torch.profiler run, largest first."""
    from torch.autograd import DeviceType

    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sorted((r for r in rows if r[0] > 0), reverse=True)


def say_rows(run, rows, busy_us, top=12):
    for us, key, count in rows[:top]:
        say("profile_kernel", run=run, share=f"{us / busy_us:.3f}", device_ms=f"{us / 1e3:.3f}",
            calls=count, name=f"'{key[:90]}'")


def scan_bucket(xb, cb, mb, nv, kernel_update: bool):
    """The dense scan over a bucket with the update kernel, or with the
    plain updates in its place (the parent's path)."""
    saved = paralingam.UPDATE_KERNEL_BACKENDS
    paralingam.UPDATE_KERNEL_BACKENDS = saved if kernel_update else ()
    try:
        return paralingam._scan_order_impl(xb, cb, mask0=mb, n_valid=nv, backend="hopper_fused")
    finally:
        paralingam.UPDATE_KERNEL_BACKENDS = saved


def profile_find_root(dev, gpu):
    """``--profile``: the torch ops and device kernels of one dense find-root
    of the E. coli bucket's first stage, and of ``fused_layout``, the plain
    version's torch prologue (row entropies, diagonal tiles, padded layout),
    whose work the kernels now do themselves; then of that bucket's first
    update, plain (``covariance.update_data`` + ``update_cov``) and through
    the update kernel, and of its whole dense scan with each, per
    iteration."""
    xb, cb, mb, nv = bucket_inputs(ecoli_requests(), ECOLI_BUCKET, dev, dead=0.0)
    roots = paralingam._find_root_dense_impl(xb, cb, mb, 32, "hopper_fused", n_valid=nv)[0]
    # A session may drop device events, never add them: the fullest of five
    # one-call sessions is the count. Once other sessions have run in the
    # process, short ones were seen to lose all of them (a fresh process
    # counts them whole), so main() runs this before any other session.
    counted = {}
    for what, fn in (
            ("find_root", lambda: paralingam._find_root_dense_impl(
                xb, cb, mb, 32, "hopper_fused", n_valid=nv)),
            ("torch_prologue", lambda: fused_layout(xb, cb, mb, 8, n_valid=nv)),
            ("update_plain", lambda: cu.rank1_update_ref(xb, cb, roots, mb, n_valid=nv)),
            ("update_kernel", lambda: ops.rank1_update(xb, cb, roots, mb, nv)),
            ("scan_plain_update", lambda: scan_bucket(xb, cb, mb, nv, False)),
            ("scan_kernel_update", lambda: scan_bucket(xb, cb, mb, nv, True))):
        fn()
        torch.cuda.synchronize()
        for _ in range(5 if what in ("find_root", "torch_prologue") else 2):
            rows, events = profiled_rows(fn, 1, with_events=True)
            seen = (sum(e.count for e in events if e.key.startswith("aten::")),
                    sum(r[2] for r in rows), rows)
            counted[what] = max(counted.get(what, seen), seen, key=lambda c: c[1])
    (fr_ops, kernels, rows), (p_ops, p_kernels, _) = counted["find_root"], counted["torch_prologue"]
    names = ",".join(
        f"{r[1].replace('(anonymous namespace)::', '').split('(')[0].split('<')[0].split('::')[-1]}"
        f":{r[2]}" for r in rows)
    say("profile_find_root", B=xb.shape[0], bucket=f"{tuple(xb.shape[1:])}",
        aten_ops=fr_ops, device_kernels=kernels, kernels=names,
        torch_prologue_aten_ops=p_ops, torch_prologue_device_kernels=p_kernels,
        gpu=f"'{gpu}'")
    its = ECOLI_BUCKET[0] - 1
    (u_ops, u_kernels, _), (k_ops, k_kernels, _) = counted["update_plain"], counted["update_kernel"]
    (sp_ops, sp_kernels, _), (sk_ops, sk_kernels, _) = (counted["scan_plain_update"],
                                                        counted["scan_kernel_update"])
    say("profile_scan_iteration", B=xb.shape[0], bucket=f"{tuple(xb.shape[1:])}", iterations=its,
        update_aten_ops_plain=u_ops, update_device_kernels_plain=u_kernels,
        update_aten_ops_kernel=k_ops, update_device_kernels_kernel=k_kernels,
        aten_ops_per_iteration_plain_update=f"{sp_ops / its:.1f}",
        aten_ops_per_iteration_kernel_update=f"{sk_ops / its:.1f}",
        device_kernels_per_iteration_plain_update=f"{sp_kernels / its:.1f}",
        device_kernels_per_iteration_kernel_update=f"{sk_kernels / its:.1f}", gpu=f"'{gpu}'")


def profile_fits(dev, gpu):
    """``--profile``: where the time of one fit goes, from torch.profiler —
    device time by kernel, and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    for p, n, seed in ((85, 10_000, 0), (512, 2000, 1)):
        x = sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=seed))["x"]
        run_fit(x, "hopper_fused", dev)  # warm-up
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, _, wall, _, _ = run_fit(x, "hopper_fused", dev)
        rows = device_rows(prof)
        busy_us = sum(r[0] for r in rows)
        say("profile", p=p, n=n, wall_s=f"{wall:.4f}", device_busy_s=f"{busy_us / 1e6:.4f}",
            device_busy_share=f"{busy_us / 1e6 / wall:.3f}", gpu=f"'{gpu}'")
        say_rows(f"fit_p{p}", rows, busy_us)
    # The threshold fit of examples/causal_discovery_ecoli.py.
    x = sem.generate(sem.SemSpec(p=85, n=10_000, density="sparse", seed=7))["x"]
    cfg = ParaLiNGAMConfig(threshold=True, chunk=16)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = timed(lambda: fit(x, cfg, device=dev))
    rows = device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    say("profile", run="threshold_fit_p85", wall_s=f"{wall:.4f}",
        device_busy_s=f"{busy_us / 1e6:.4f}", device_busy_share=f"{busy_us / 1e6 / wall:.3f}",
        gpu=f"'{gpu}'")
    say_rows("threshold_fit_p85", rows, busy_us)
    # One dispatch of the E. coli bucket (B=8), as the engine runs it.
    xs, mask, nv, _ = pack_bucket(ecoli_requests(), *ECOLI_BUCKET)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit_batch(xs, ParaLiNGAMConfig(), n_valid=nv, mask=mask, device=dev).orders.cpu()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    say("profile", run="fit_batch_ecoli_b8", wall_s=f"{wall:.4f}",
        device_busy_s=f"{busy_us / 1e6:.4f}", device_busy_share=f"{busy_us / 1e6 / wall:.3f}",
        gpu=f"'{gpu}'")
    say_rows("fit_batch_ecoli_b8", rows, busy_us)


# -- slice 3: the square moments kernel, the host driver, the threshold machine

SQUARE_SOURCE = "src/repro_torch/kernels/csrc/pairwise_moments.cu"
SQUARE_REPLACES = "src/repro/kernels/pairwise_score.py:46"
# Entropies after the epilogue, kernel against plain: the rtol/atol of
# tests/test_kernel_moments.py (the JAX package's kernel route).
H_RTOL = H_ATOL = 1e-5


def live_off_diagonal(mask_i, mask_j=None):
    """(pi, pj) pairs of live rows with i != j: the sums that reach a score.
    The (i, i) sums are rounding noise amplified by up to 1e6 (c_ii ~ 1), and
    so are those of a row against its copies in a compacted buffer's dead
    slots."""
    mask_j = mask_i if mask_j is None else mask_j
    pi, pj = mask_i.shape[0], mask_j.shape[0]
    eye = torch.arange(pi, device=mask_i.device)[:, None] == torch.arange(pj, device=mask_i.device)
    return mask_i[:, None] & mask_j[None, :] & ~eye


def hold_sums(name, xi, xj, c, sel, live_i=None, live_j=None, n_valid=None):
    """The square kernel against its plain version on one dataset, called as
    the pipeline calls it (live rows, valid count): the raw sums on the
    ``sel`` entries within ``sum_tolerance``, every pair with a dead row
    exactly 0, and the entropies after ``finalize_moments`` within
    H_RTOL/H_ATOL. Returns the max abs error of the sums."""
    kw = {"live_i": live_i, "live_j": live_j, "n_valid": n_valid}
    k1, k2 = ps.pairwise_moments(xi, xj, c, **kw)
    r1, r2 = ps.pairwise_moments_ref(xi, xj, c, **kw)
    torch.cuda.synchronize()
    tol = ps.sum_tolerance(xi, xj, c, n_valid)[sel].double()
    errs, ratios = [], []
    for k, r in ((k1, r1), (k2, r2)):
        check(bool(torch.all(torch.isfinite(k[sel]))), f"{name}: non-finite sums")
        e = (k[sel].double() - r[sel].double()).abs()
        errs.append(e.max().item())
        ratios.append((e / tol).max().item())
    ones = torch.ones(max(xi.shape[0], xj.shape[0]), dtype=torch.bool, device=xi.device)
    li = ones[:xi.shape[0]] if live_i is None else live_i
    lj = ones[:xj.shape[0]] if live_j is None else live_j
    dead = ~(li[:, None] & lj[None, :])
    zero = bool(torch.all(k1[dead] == 0) and torch.all(k2[dead] == 0))
    n = xi.shape[-1]
    hk = ps.finalize(k1, k2, n, n_valid)[sel].double()
    hr = ps.finalize(r1, r2, n, n_valid)[sel].double()
    h_ok = bool(torch.all((hk - hr).abs() <= H_ATOL + H_RTOL * hr.abs()))
    ok = max(ratios) <= 1.0 and h_ok and zero
    say("pairwise_vs_plain", case=name, pi=xi.shape[0], pj=xj.shape[0], n=n,
        n_valid="n" if n_valid is None else int(n_valid), held_entries=int(sel.sum()),
        dead_pairs=int(dead.sum()), dead_pairs_zero=zero, max_abs_m1=f"{errs[0]:.3e}",
        max_abs_m2=f"{errs[1]:.3e}", max_err_over_tol=f"{max(ratios):.3e}",
        max_rel_entropy=f"{((hk - hr).abs() / hr.abs().clamp(min=1e-30)).max().item():.3e}",
        entropies_ok=h_ok, ok=ok)
    check(ok, f"{name}: square kernel disagrees with plain")
    return max(errs)


def square_bound_ms(pair_samples: float, bytes_moved: float):
    """(bound, bound_by, FP32 ms, SFU ms) of the square sums on this much
    work: the (ordered pair, sample) elements that a score needs (live
    off-diagonal pairs over valid samples), each counted at one direction of
    the fused sweep's math, half its FP32 and MUFU instructions per
    (unordered pair, sample) from this run's ``[fused_sass]``, whatever
    implements it; or the bytes read and written once over HBM."""
    tf, tm = SWEEP_SASS["tiles"]
    t = {"bytes": bytes_moved / HBM_BPS, "fp32": tf / 2 * pair_samples / FP32_INSNS,
         "sfu": tm / 2 * pair_samples / SFU_OPS}
    key = max(t, key=t.get)
    return (t[key] * 1e3, "bytes" if key == "bytes" else "operations",
            t["fp32"] * 1e3, t["sfu"] * 1e3)


def square_bytes(live, n_valid, m):
    """Bytes the square sums must move: the live rows' valid samples and
    their correlations read once, the two (m, m) sums written once."""
    return 4 * (live * n_valid + live * live + 2 * m * m)


def capture_dense_inputs(x, backend, dev):
    """Fit once and keep the find-root inputs of the first iteration of every
    stage (rows, correlations, mask), keyed by the stage's buffer size."""
    captured, orig = {}, paralingam._find_root_dense_impl

    def spy(xb, cb, mask, **kw):
        if xb.shape[1] not in captured:
            captured[xb.shape[1]] = (xb[0].clone(), cb[0].clone(), mask[0].clone())
        return orig(xb, cb, mask, **kw)

    paralingam._find_root_dense_impl = spy
    try:
        fit(x, ParaLiNGAMConfig(score_backend=backend), device=dev)
    finally:
        paralingam._find_root_dense_impl = orig
    return captured


def masked_case(p, n, n_pad, seed, dev, fill=0.0):
    """Normalized Gaussian rows with every fifth row dead, held at 0 in xn
    and c as the pipeline holds them, zero-padded to ``n_pad`` samples (the
    padding filled with ``fill``): (unpadded rows, padded rows, c, mask)."""
    xn, c = normalized(gauss_data(p, n, seed), dev)
    mask = torch.arange(p, device=dev) % 5 != 2
    xn = torch.where(mask[:, None], xn, 0.0).contiguous()
    c = torch.where(mask[:, None] & mask[None, :], c, 0.0).contiguous()
    xp = torch.full((p, n_pad), fill, device=dev)
    xp[:, :n] = xn
    return xn, xp, c, mask


def phase_pairwise_kernel(dev, gpu, ecoli_x):
    """The square moments kernel against its plain version, called as the
    pipeline calls it: ragged edges, live-row masks and valid counts on
    padded buffers, the E. coli fit's first stage (m=128, n=10000) under the
    fit's mask, m=512 n=2000, padding exactness, batch-row identity at the
    (128, 16384) bucket under masks and valid counts, and times."""
    errs, timing = [], {}
    xn, c = normalized(np.random.default_rng(1).standard_normal((13, 700)), dev)
    full = torch.ones(13, dtype=torch.bool, device=dev)
    errs.append(hold_sums("ragged_p13_n700", xn, xn, c, live_off_diagonal(full)))
    xi, cj = xn[:, :].contiguous(), c[:, :5].contiguous()
    errs.append(hold_sums("block_13x5_n700", xi, xn[:5].contiguous(), cj,
                          live_off_diagonal(full, full[:5])))
    # Masks and a valid count, as the pipeline passes them: dead rows 0,
    # samples past n_valid 0.
    xm, xp, cm, mm = masked_case(37, 1300, 2048, 4, dev)
    nv = torch.tensor(1300, device=dev)
    errs.append(hold_sums("masked_p37_n1300_pad2048", xp, xp, cm, live_off_diagonal(mm),
                          live_i=mm, live_j=mm, n_valid=nv))
    errs.append(hold_sums("masked_block_37x21_n1300_pad2048", xp, xp[:21].contiguous(),
                          cm[:, :21].contiguous(), live_off_diagonal(mm, mm[:21]),
                          live_i=mm, live_j=mm[:21].contiguous(), n_valid=nv))
    # zero columns add exactly 0: bit-identical sums
    same = []
    for n_pad in (1024, 2048):
        xz = torch.zeros((13, n_pad), device=dev)
        xz[:, :700] = xn
        same += [torch.equal(a, b) for a, b in zip(ps.pairwise_moments(xn, xn, c),
                                                    ps.pairwise_moments(xz, xz, c))]
    # under n_valid the loops stop at the valid count: a padded launch gives
    # the unpadded launch's bits, whatever the padding holds (n=700 rows
    # 16-byte aligned, n=1901 rows not: the 4-byte staging path)
    padded = []
    for p, n, n_pad, seed in ((21, 700, 1024, 2), (19, 1901, 2048, 3)):
        for fill in (0.0, torch.nan):
            xm, xp, cm, mm = masked_case(p, n, n_pad, seed, dev, fill)
            kw = {"live_i": mm, "live_j": mm}
            padded += [torch.equal(a, b) for a, b in zip(
                ps.pairwise_moments(xp, xp, cm, n_valid=torch.tensor(n, device=dev), **kw),
                ps.pairwise_moments(xm, xm, cm, **kw))]
    say("pairwise_padding", sums_bit_identical=f"{sum(same)}/{len(same)}",
        n_valid_padded_vs_unpadded_bit_identical=f"{sum(padded)}/{len(padded)}",
        cases="p21_n700_pad1024,p19_n1901_pad2048;fill=0,nan")
    check(all(same), "zero-padding n changed the square kernel's sums")
    check(all(padded), "a padded launch with n_valid differs from the unpadded launch")

    stages = capture_dense_inputs(ecoli_x, "hopper", dev)
    xe, ce, me = stages[max(stages)]  # the first stage
    errs.append(hold_sums(f"ecoli_fit_stage_m{xe.shape[0]}", xe, xe, ce, live_off_diagonal(me),
                          live_i=me, live_j=me))
    xg, cg = normalized(gauss_data(*SLICE, 1), dev)
    mg = torch.ones(SLICE[0], dtype=torch.bool, device=dev)
    errs.append(hold_sums(f"gauss_m{SLICE[0]}_n{SLICE[1]}", xg, xg, cg, live_off_diagonal(mg),
                          live_i=mg, live_j=mg))

    for name, (x_, c_, m_) in (("ecoli_stage", (xe, ce, me)), ("slice", (xg, cg, mg))):
        m, n = x_.shape
        args = (x_[None], x_[None], c_[None], m_[None], m_[None])
        ms = time_ms(lambda: ps._launch(*args), reps=50)
        unmasked_ms = time_ms(lambda: ps._launch(*args[:3]), reps=20)
        bare_ms = no_math_ms(lambda: ps._launch(*args), reps=20, module=ps)
        wrapper_ms = time_ms(lambda: ps.pairwise_moments(x_, x_, c_, live_i=m_, live_j=m_), reps=20)
        plain_ms = time_ms(lambda: ps.pairwise_moments_ref(x_, x_, c_, live_i=m_, live_j=m_),
                           reps=3, warmup=1)
        live = int(m_.sum())
        bound, by, t_fp32, t_sfu = square_bound_ms(live * (live - 1) * n, square_bytes(live, n, m))
        padded_bound = square_bound_ms(m * m * n, square_bytes(m, n, m))[0]
        lanes = ps._lanes(-(-m // ps.BLOCK_I) * -(-m // ps.BLOCK_J))
        timing[name] = (ms, wrapper_ms, plain_ms, bound, by)
        say("pairwise_kernel_time", shape=f"m{m}_n{n}", live_rows=live, kernel_ms=f"{ms:.4f}",
            wrapper_ms=f"{wrapper_ms:.4f}", unmasked_kernel_ms=f"{unmasked_ms:.4f}",
            no_math_kernel_ms=f"{bare_ms:.4f}", plain_ms=f"{plain_ms:.3f}",
            bound_ms=f"{bound:.4f}", bound_by=by, bound_ms_fp32=f"{t_fp32:.4f}",
            bound_ms_sfu=f"{t_sfu:.4f}", bound_ms_padded_buffer=f"{padded_bound:.4f}",
            kernel_fraction_of_bound=f"{bound / ms:.3f}", lanes=lanes,
            threads_per_block=ps.MICRO_TILES * lanes, blocks_per_sm=ps.occupancy(lanes),
            gpu=f"'{gpu}'")

    # The batched entry on the E. coli bucket, as the pipeline calls it (dead
    # rows 0, each dataset's mask and valid count): per dataset against
    # plain, and row b bit-identical to a one-dataset launch.
    xb, cb, mb, nv = bucket_inputs(ecoli_requests(), ECOLI_BUCKET, dev, dead=0.0)
    bsz, p_pad, n_pad = xb.shape
    nv32 = fs._valid_counts(nv, bsz, dev)
    b1, b2 = ps.pairwise_moments_batch(xb, cb, mask=mb, n_valid=nv)
    r1, r2 = ps.pairwise_moments_batch_ref(xb, cb, mask=mb, n_valid=nv)
    torch.cuda.synchronize()
    rows, ratios, zero = [], [], True
    for b in range(bsz):
        o1, o2 = ps._launch(xb[b:b + 1], xb[b:b + 1], cb[b:b + 1], mb[b:b + 1], mb[b:b + 1],
                            nv32[b:b + 1])
        rows.append(torch.equal(b1[b], o1[0]) and torch.equal(b2[b], o2[0]))
        sel = live_off_diagonal(mb[b])
        dead = ~(mb[b][:, None] & mb[b][None, :])
        zero = zero and bool(torch.all(b1[b][dead] == 0) and torch.all(b2[b][dead] == 0))
        tol = ps.sum_tolerance(xb[b], xb[b], cb[b], nv[b])[sel].double()
        for k, r in ((b1[b], r1[b]), (b2[b], r2[b])):
            e = (k[sel].double() - r[sel].double()).abs()
            errs.append(e.max().item())
            ratios.append((e / tol).max().item())
    say("pairwise_batch", B=bsz, bucket=f"{tuple(xb.shape[1:])}", masked=True, n_valid=True,
        rows_bit_identical=f"{sum(rows)}/{len(rows)}", dead_pairs_zero=zero,
        max_err_over_tol=f"{max(ratios):.3e}")
    check(all(rows), "a batched row of the square kernel differs from its one-dataset launch")
    check(max(ratios) <= 1.0 and zero, "the batched square kernel disagrees with plain")
    ms = time_ms(lambda: ps._launch(xb, xb, cb, mb, mb, nv32), reps=10)
    unmasked_ms = time_ms(lambda: ps._launch(xb, xb, cb), reps=5)
    bare_ms = no_math_ms(lambda: ps._launch(xb, xb, cb, mb, mb, nv32), reps=10, module=ps)
    wrapper_ms = time_ms(lambda: ps.pairwise_moments_batch(xb, cb, mask=mb, n_valid=nv), reps=5)
    plain_ms = time_ms(lambda: ps.pairwise_moments_batch_ref(xb, cb, mask=mb, n_valid=nv),
                       reps=2, warmup=1)
    live, nvd = mb.sum(dim=1).double(), nv.double()
    bound, by, t_fp32, t_sfu = square_bound_ms(float((live * (live - 1) * nvd).sum()),
                                               float(square_bytes(live, nvd, p_pad).sum()))
    padded = square_bound_ms(bsz * p_pad * p_pad * n_pad, bsz * square_bytes(p_pad, n_pad, p_pad))[0]
    timing["batch"] = (ms, wrapper_ms, plain_ms, bound, by, padded,
                       f"B={bsz},bucket={p_pad}x{n_pad},p={int(live.min())}-{int(live.max())},"
                       f"n={int(nv.min())}-{int(nv.max())}")
    say("pairwise_batch_kernel_time", B=bsz, bucket=f"{(p_pad, n_pad)}", kernel_ms=f"{ms:.4f}",
        wrapper_ms=f"{wrapper_ms:.4f}", unmasked_kernel_ms=f"{unmasked_ms:.4f}",
        no_math_kernel_ms=f"{bare_ms:.4f}", plain_ms=f"{plain_ms:.3f}", bound_ms=f"{bound:.4f}",
        bound_by=by, bound_ms_fp32=f"{t_fp32:.4f}", bound_ms_sfu=f"{t_sfu:.4f}",
        bound_ms_padded_buffer=f"{padded:.4f}", kernel_fraction_of_bound=f"{bound / ms:.3f}",
        gpu=f"'{gpu}'")
    return max(errs), timing


def dense_scores_along(x, order, it, dev):
    """The dense scores (plain square path) and their tolerance at iteration
    ``it`` of the updates along ``order``."""
    from repro_torch.core.covariance import update_cov, update_data
    from repro_torch.core.pairwise import dense_scores

    xn, c = normalized(x, dev)
    mask = torch.ones(xn.shape[0], dtype=torch.bool, device=dev)
    for r in order[:it]:
        xn, c = update_data(xn, c, r, mask), update_cov(c, r, mask)
        mask[r] = False
    s = dense_scores(xn, c, mask)[0]
    return s, fs.score_tolerance(s, xn, c, mask)


def hold_order(name, got, want, x, dev) -> bool:
    """Equal orders, or a departure at an f32 near-tie: the two roots' dense
    scores at the first differing iteration within their tolerances of each
    other. Raises otherwise. Returns whether the orders are equal."""
    if got == want:
        return True
    k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    s, tol = dense_scores_along(x, want, k, dev)
    a, b = got[k], want[k]
    gap, allowed = abs(s[a] - s[b]).item(), (tol[a] + tol[b]).item()
    say("order_departure", case=name, iteration=k, root=a, reference_root=b,
        dense_score_root=f"{s[a].item():.6e}", dense_score_reference=f"{s[b].item():.6e}",
        gap=f"{gap:.3e}", allowed=f"{allowed:.3e}", near_tie=gap <= allowed)
    check(gap <= allowed, f"{name}: orders depart at iteration {k} beyond an f32 near-tie")
    return False


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_fit_hopper(dev, gpu, core):
    """``fit(score_backend="hopper")`` at the E. coli core size: one square
    launch per find-root, the orders of the other backends, B and noise
    variances as the fused fit's. Returns its launches."""
    x = core["x"]
    p, n = x.shape
    res_k, b_k, t_k = core["hopper_fused"]
    res_p = core["torch"][0]
    fit(x, ParaLiNGAMConfig(score_backend="hopper"), device=dev)  # warm-up
    reset_counts()
    (res, b), t = timed(lambda: fit(x, ParaLiNGAMConfig(score_backend="hopper"), device=dev))
    launched = counts()
    same_fused = hold_order("fit_hopper_vs_hopper_fused", res.order, res_k.order, x, dev)
    same_torch = hold_order("fit_hopper_vs_torch", res.order, res_p.order, x, dev)
    b_err = (b - b_k).abs().max().item()
    nv_err = float(np.max(np.abs(res.noise_var / res_k.noise_var - 1)))
    say("fit_hopper_ecoli", p=p, n=n, launches=launched["pairwise_moments"], find_roots=p - 1,
        update_launches=launched["rank1_update"],
        order_equals_hopper_fused=same_fused, order_equals_torch=same_torch,
        b_max_abs_diff=b_err, noise_var_max_rel_diff=nv_err, fit_s_hopper=f"{t:.4f}",
        fit_s_hopper_fused=f"{t_k:.4f}", gpu=f"'{gpu}'")
    check(launched["pairwise_moments"] == p - 1 and launched["fused_score"] == 0
          and launched["rank1_update"] == p - 1, f"{launched} launches for {p - 1} iterations")
    if same_fused:
        check(b_err <= 1e-6 and nv_err <= 1e-6, "B or noise_var differ from the fused fit")
    return launched["pairwise_moments"]


def phase_causal_order_host(dev, gpu, core):
    """The host driver (``causal_order``, ``order_backend="host"``) with the
    square and the fused kernels: the orders of ``fit``."""
    x = core["x"]
    p, n = x.shape
    fit_order = core["hopper_fused"][0].order
    for backend in ("hopper", "hopper_fused"):
        reset_counts()
        res, t = timed(lambda: causal_order(x, ParaLiNGAMConfig(score_backend=backend), device=dev))
        launched = counts()
        key = "pairwise_moments" if backend == "hopper" else "fused_score"
        same = hold_order(f"host_{backend}_vs_fit", res.order, fit_order, x, dev)
        say("causal_order_host", backend=backend, p=p, n=n, launches=launched[key],
            update_launches=launched["rank1_update"],
            order_equals_fit=same, comparisons=res.comparisons, seconds=f"{t:.4f}",
            fit_s=f"{core['hopper_fused'][2]:.4f}", gpu=f"'{gpu}'")
        check(launched[key] == p - 1 and launched["rank1_update"] == p - 1,
              f"{launched} launches for {p - 1} host iterations")


def count_reads(fn):
    """Run ``fn`` counting the threshold loop's host reads."""
    reads, orig = [0], paralingam._still_running

    def spy(run):
        reads[0] += 1
        return orig(run)

    paralingam._still_running = spy
    try:
        out = timed(fn)
    finally:
        paralingam._still_running = orig
    return out, reads[0]


def phase_threshold_ecoli(dev, gpu):
    """The configuration of examples/causal_discovery_ecoli.py (p=85,
    n=10000, seed 7, threshold, chunk 16) through ``fit`` (the scan) and
    ``causal_order`` (the host driver), held to each other and to the dense
    fused order; and a p=8 threshold fit held to the float64 oracle."""
    p, n = ECOLI
    data = sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=7))
    x = data["x"]
    cfg = ParaLiNGAMConfig(threshold=True, chunk=16)
    fit(x, ParaLiNGAMConfig(), device=dev)  # warm-up
    (dense, _), t_dense = timed(lambda: fit(x, ParaLiNGAMConfig(), device=dev))
    ((scan, b), t_scan), reads_scan = count_reads(lambda: fit(x, cfg, device=dev))
    (host, t_host), reads_host = count_reads(lambda: causal_order(x, cfg, device=dev))
    scan_host = hold_order("threshold_scan_vs_host", scan.order, host.order, x, dev)
    scan_dense = hold_order("threshold_scan_vs_dense", scan.order, dense.order, x, dev)
    host_dense = hold_order("threshold_host_vs_dense", host.order, dense.order, x, dev)
    for name, r, t, reads in (("scan", scan, t_scan, reads_scan), ("host", host, t_host, reads_host)):
        say("threshold_ecoli", driver=name, p=p, n=n, chunk=16, comparisons=r.comparisons,
            comparisons_dense=r.comparisons_dense, saving_vs_serial=f"{r.saving_vs_serial:.4f}",
            rounds=r.rounds, converged=r.converged, host_reads=reads,
            valid_order=sem.is_valid_causal_order(r.order, data["b_true"]),
            seconds=f"{t:.4f}", dense_fit_s=f"{t_dense:.4f}", gpu=f"'{gpu}'")
        check(r.converged, f"threshold {name} did not converge")
        check(0 < r.comparisons < r.comparisons_dense, f"threshold {name} counted no saving")
    say("threshold_orders", scan_equals_host=scan_host, scan_equals_dense=scan_dense,
        host_equals_dense=host_dense)
    check(bool(torch.all(torch.isfinite(b))) and np.all(np.isfinite(scan.noise_var)),
          "non-finite B or noise variances from the threshold fit")

    small = sem.generate(sem.SemSpec(p=8, n=2500, density="sparse", seed=0))
    res, _ = fit(small["x"], ParaLiNGAMConfig(threshold=True, min_bucket=8), device=dev)
    oracle = direct_lingam.causal_order(small["x"])
    say("threshold_small", p=8, n=2500, order_equals_f64_oracle=res.order == oracle,
        comparisons=res.comparisons, rounds=res.rounds)
    check(res.order == oracle, "threshold fit order differs from the float64 oracle at p=8")
    return {"fit_s": t_scan, "host_s": t_host, "dense_fit_s": t_dense}


def phase_threshold_batch(dev, gpu):
    """``fit_batch(threshold=True)`` on the ragged E. coli bucket, against
    each dataset's own one-dataset ``fit_batch`` on the same padded inputs;
    then one served round of the same requests, each result bit-identical
    to a replay of its dispatch."""
    raw = ecoli_requests()
    xs, mask, nv, _ = pack_bucket(raw, *ECOLI_BUCKET)
    cfg = ParaLiNGAMConfig(threshold=True)
    names = ("orders", "comparisons", "rounds", "converged")
    (res, t_batch), reads = count_reads(
        lambda: fit_batch(xs, cfg, n_valid=nv, mask=mask, device=dev))
    got = {k: getattr(res, k).cpu().numpy() for k in names}
    differ, t_ones = timed(lambda: batch_differences(res, xs, mask, nv, cfg,
                                                     [x.shape[0] for x in raw], names, dev))
    same = len(raw) - len({d.split(":")[0] for d in differ})
    comps = [int(got["comparisons"][i, :x.shape[0] - 1].sum()) for i, x in enumerate(raw)]
    dense = [sum(r * (r - 1) // 2 for r in range(2, x.shape[0] + 1)) for x in raw]
    say("threshold_batch", B=len(raw), bucket=f"{ECOLI_BUCKET}", seconds=f"{t_batch:.4f}",
        one_dataset_fit_batch_s=f"{t_ones:.4f}", host_reads=reads,
        equal_to_own_fit_batch=f"{same}/{len(raw)}", first_differences=",".join(differ) or "none",
        saving_vs_serial=",".join(f"{1 - c / (2 * d):.3f}" for c, d in zip(comps, dense)),
        converged=bool(res.converged.all()), gpu=f"'{gpu}'")
    check(same == len(raw), "a dataset's threshold fit differs between its batch and its own")
    check(bool(res.converged.all()), "a threshold fit in the bucket did not converge")

    results, wall, st, served, _, launched, _ = engine_round(cfg, raw, dev)
    replay_ok = replay_identical(served, cfg, dev)
    say("threshold_engine", requests=len(raw), dispatches=st["dispatches"], wall_s=f"{wall:.4f}",
        requests_per_s=f"{len(raw) / wall:.3f}",
        results_bit_identical_to_replay=f"{replay_ok}/{len(raw)}",
        launches=sum(launched.values()), gpu=f"'{gpu}'")
    check(replay_ok == len(raw), "a served threshold result differs from the replay of its dispatch")
    return t_batch


def phase_threshold_slice(dev, gpu):
    """A threshold fit at the iJR904 slice size (p=512, n=2000), for its
    comparisons, rounds and time beside the dense fit's. Its orders mean
    nothing: this SEM is degenerate in f32 (ROADMAP.md queue 3)."""
    p, n = SLICE
    x = sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=1))["x"]
    (dense, _), t_dense = timed(lambda: fit(x, ParaLiNGAMConfig(), device=dev))
    ((res, _), t), reads = count_reads(
        lambda: fit(x, ParaLiNGAMConfig(threshold=True, chunk=16), device=dev))
    say("threshold_slice", p=p, n=n, chunk=16, comparisons=res.comparisons,
        comparisons_dense=res.comparisons_dense, saving_vs_serial=f"{res.saving_vs_serial:.4f}",
        rounds=res.rounds, converged=res.converged, host_reads=reads, seconds=f"{t:.4f}",
        dense_fit_s=f"{t_dense:.4f}", order_equals_dense=res.order == dense.order, held=False,
        gpu=f"'{gpu}'")
    check(res.converged, "the p=512 threshold fit did not converge")


def phase_fit_batch_hopper(dev, gpu, batch_orders):
    """``fit_batch(score_backend="hopper")`` on the E. coli bucket: one
    batched square launch per find-root, the fused backend's orders."""
    raw = ecoli_requests()
    xs, mask, nv, _ = pack_bucket(raw, *ECOLI_BUCKET)
    cfg = ParaLiNGAMConfig(score_backend="hopper")
    reset_counts()
    res, t = timed(lambda: fit_batch(xs, cfg, n_valid=nv, mask=mask, device=dev))
    launched = counts()
    orders = res.orders.cpu().numpy()
    same = sum(list(orders[i, :x.shape[0]]) == o for i, (x, o) in enumerate(zip(raw, batch_orders)))
    say("fit_batch_hopper", B=len(raw), bucket=f"{ECOLI_BUCKET}", launches=launched["pairwise_moments_batch"],
        update_launches=launched["rank1_update"],
        find_roots=ECOLI_BUCKET[0] - 1, orders_equal_to_hopper_fused=f"{same}/{len(raw)}",
        seconds=f"{t:.4f}", gpu=f"'{gpu}'")
    check(launched["pairwise_moments_batch"] == ECOLI_BUCKET[0] - 1 and launched["pairwise_moments"] == 0
          and launched["rank1_update"] == ECOLI_BUCKET[0] - 1,
          f"{launched} launches for {ECOLI_BUCKET[0] - 1} iterations")
    for i, (x, o) in enumerate(zip(raw, batch_orders)):
        if list(orders[i, :x.shape[0]]) != o:
            hold_order(f"fit_batch_hopper[{i}]", list(orders[i, :x.shape[0]]), o, x, dev)
    return launched["pairwise_moments_batch"]


# -- slice 4: the rank-1 update kernels, the SSD decode kernel, Mamba2 serving

COV_SOURCE = "src/repro_torch/kernels/csrc/covupdate.cu"
DATA_REPLACES = "src/repro/kernels/covupdate.py:21"
COV_REPLACES = "src/repro/kernels/covupdate.py:29"
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_decode.cu"
SSD_REPLACES = "src/repro/kernels/ssd_decode.py:27"
# Kernel against plain: the rtol/atol of tests/test_kernels.py, which holds
# the Pallas kernels to the same formulas: 1e-5 (data, decode step; 1e-6
# atol on the covariance). Both sides round each product and sum on its own;
# only y's N-term sum of the decode step is taken in another order.
RTOL, ATOL, COV_ATOL = 1e-5, 1e-5, 1e-6
# Mamba2-370M serving at the shape of examples/serve_lm.py.
SERVE_B, SERVE_PROMPT, SERVE_NEW = 4, 32, 16
# A greedy token of the card may depart from the CPU's only at a near-tie:
# where the CPU's top-2 logits lie within GAP_TOL of each other. The logits
# are O(1) (unit-RMS hidden state after the final norm, a N(0, 1/d) head);
# float32 sums taken in other orders on the card and on the CPU move them by
# ~1e-5 after 48 layers (printed as prefill_logits_max_abs_diff), so a gap
# of 1e-3 is 100 times what the rounding can flip.
GAP_TOL = 1e-3


def within(k, r, atol, rtol=RTOL):
    """max |k - r|, and whether every entry is within atol + rtol |r|."""
    e = (k.double() - r.double()).abs()
    return e.max().item(), bool(torch.all(e <= atol + rtol * r.double().abs()))


def copy_rate(dev) -> float:
    """Bytes read and written per second by a device-to-device copy of a
    1 GiB float32 buffer (CUDA events)."""
    src = torch.empty(1 << 28, device=dev)
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), reps=10)
    return 2 * src.numel() * 4 / (ms / 1e3)


def device_ms(fn, kernel: str, reps: int = 50) -> float:
    """Device time per launch of the kernel whose name contains ``kernel``,
    from torch.profiler over ``reps`` calls of ``fn``: the kernel's own
    execution, without the host's launch gaps that back-to-back CUDA-event
    timing of a microsecond kernel measures."""
    fn()
    torch.cuda.synchronize()
    rows = [r for r in profiled_rows(fn, reps, kernel) if kernel in r[1]]
    check(len(rows) == 1, f"the profiler saw {len(rows)} kernels named like {kernel}")
    return rows[0][0] / rows[0][2] / 1e3


# A torch.profiler session on the card now and then delivers no device
# events at all (seen on the H100 machine in about one session in ten, for
# kernels it had traced before): such a session is run again.
PROFILE_ATTEMPTS = 3


def profiled_rows(fn, reps: int, kernel: str = "", with_events: bool = False):
    """``device_rows`` of a profiler session over ``reps`` calls of ``fn``,
    run again (up to ``PROFILE_ATTEMPTS`` sessions) while it saw no device
    kernel named like ``kernel`` (any kernel for ""). With ``with_events``
    also returns the session's ``key_averages()``."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        if any(kernel in r[1] for r in rows):
            break
        say("profiler_retry", kernel=f"'{kernel}'", attempt=attempt, device_events=0)
        time.sleep(0.5)
    return (rows, prof.key_averages()) if with_events else rows


def covupdate_inputs(p, n, dev):
    """Normalized Gaussian rows, their correlations, b = c[:, 0] with the
    root zeroed, and the root's row, as tests/test_kernels.py builds them."""
    xn, c = normalized(gauss_data(p, n, p), dev)
    b = c[:, 0].clone()
    b[0] = 0.0
    return xn, c, b, xn[0].contiguous()


def hold_covupdate(name, xn, c, b, xr):
    """Both kernels against their plain versions on one input; returns the
    max abs errors (data, covariance)."""
    kx, kc = ops.update_data(xn, xr, b), ops.update_cov(c, b)
    rx, rc = cu.update_data_ref(xn, xr, b), cu.update_cov_ref(c, b)
    torch.cuda.synchronize()
    ex, okx = within(kx, rx, ATOL)
    ec, okc = within(kc, rc, COV_ATOL)
    diag = bool(torch.all(torch.diagonal(kc) == 1))
    say("covupdate_vs_plain", case=name, p=xn.shape[0], n=xn.shape[1], max_abs_data=f"{ex:.3e}",
        max_abs_cov=f"{ec:.3e}", data_bit_equal=torch.equal(kx, rx),
        cov_bit_equal=torch.equal(kc, rc), unit_diagonal=diag, ok=okx and okc and diag)
    check(okx and okc and diag, f"{name}: a rank-1 update kernel disagrees with plain")
    return ex, ec


def empty_times(mode, batch, m, n, dev):
    """Event ms and device ms of an empty kernel on the grid of a ``mode``
    launch of the update kernel: the launch floor beside its time."""
    fn = lambda: cu.launch_empty(mode, batch, m, n, dev)  # noqa: E731
    return time_ms(fn, reps=200, warmup=5), device_ms(fn, "rank1_update_empty")


def phase_covupdate_kernel(dev, gpu, rate):
    """The update kernel's TPU mode (``update_data``, ``update_cov``)
    against its plain versions at the CPU tests' cases, p=85/n=10000 and
    p=512/n=2000, with times per launch beside an empty kernel's on the
    same grid."""
    errs = [hold_covupdate(f"gauss_p{p}_n{n}", *covupdate_inputs(p, n, dev))
            for p, n in ((8, 512), (21, 1000), (64, 4096), (7, 130), ECOLI, SLICE)]
    timing = {}
    for p, n in (SLICE, (64, 4096), ECOLI):
        xn, c, b, xr = covupdate_inputs(p, n, dev)
        for name, mode, kern, plain, nbytes, ops_ in (
                ("update_data", cu.MODE_DATA, lambda: cu.launch_data(xn, xr, b),
                 lambda: cu.update_data_ref(xn, xr, b), 4 * (2 * p * n + n + p), 3 * p * n),
                ("update_cov", cu.MODE_COV, lambda: cu.launch_cov(c, b),
                 lambda: cu.update_cov_ref(c, b), 4 * (2 * p * p + p), 3 * p * p)):
            if name == "update_cov" and (p, n) != SLICE:
                continue
            ms = time_ms(kern, reps=200, warmup=5)
            dev_ms = device_ms(kern, "rank1_update_kernel")
            empty_ms, empty_dev = empty_times(mode, 1, p, n, dev)
            plain_ms = time_ms(plain, reps=50, warmup=2)
            bound = max(nbytes / HBM_BPS, ops_ / FP32_FLOPS) * 1e3
            shape = f"p={p},n={n}" if name == "update_data" else f"p={p}"
            timing.setdefault(name, (ms, plain_ms, bound, shape, dev_ms, empty_dev))
            say("covupdate_kernel_time", kernel=name, shape=shape, kernel_ms=f"{ms:.5f}",
                device_ms=f"{dev_ms:.5f}", empty_kernel_ms=f"{empty_ms:.5f}",
                empty_kernel_device_ms=f"{empty_dev:.5f}",
                blocks=cu.blocks(mode, 1, p, n), plain_ms=f"{plain_ms:.5f}",
                bound_ms=f"{bound:.5f}", bound_by="bytes",
                bound_ms_at_copy_rate=f"{nbytes / rate * 1e3:.5f}",
                device_fraction_of_bound=f"{bound / dev_ms:.3f}", gpu=f"'{gpu}'")
    return max(e[0] for e in errs), max(e[1] for e in errs), timing


def phase_covupdate_path(dev, gpu, x, order):
    """The kernels' entry points on their own path: Algorithms 7 and 8 along
    a causal order of the E. coli core data, one ``ops.update_data`` and one
    ``ops.update_cov`` per iteration (b = c[:, root] with the root and the
    earlier roots zeroed). Each step's kernel outputs are held against the
    plain versions on the same inputs. Returns (launches, max errors)."""
    xn, c = normalized(x, dev)
    dead = torch.zeros(xn.shape[0], dtype=torch.bool, device=dev)
    steps = []
    reset_counts()
    for r in order[:-1]:
        b = torch.where(dead, 0.0, c[:, r])
        b[r] = 0.0
        xr = xn[r].contiguous()
        nx, nc = ops.update_data(xn, xr, b), ops.update_cov(c, b)
        steps.append((xn, c, b, xr, nx, nc))
        xn, c = nx, nc
        dead[r] = True
    launched = counts()
    ex = ec = 0.0
    ok = True
    for xn0, c0, b, xr, nx, nc in steps:
        e1, ok1 = within(nx, cu.update_data_ref(xn0, xr, b), ATOL)
        e2, ok2 = within(nc, cu.update_cov_ref(c0, b), COV_ATOL)
        ex, ec, ok = max(ex, e1), max(ec, e2), ok and ok1 and ok2
    finite = bool(torch.isfinite(xn).all() and torch.isfinite(c).all())
    say("covupdate_path", p=x.shape[0], n=x.shape[1], iterations=len(steps),
        launches_update_data=launched["update_data"], launches_update_cov=launched["update_cov"],
        max_abs_data=f"{ex:.3e}", max_abs_cov=f"{ec:.3e}", finite=finite, ok=ok, gpu=f"'{gpu}'")
    check(launched["update_data"] == launched["update_cov"] == len(steps),
          f"{launched} launches for {len(steps)} rank-1 updates")
    check(ok and finite, "a rank-1 update on the entry path disagrees with plain")
    return launched, ex, ec


# -- slice 7: the update kernel's fit mode, on the path of every fit

RANK1_REPLACES = ("src/repro/kernels/covupdate.py:21,29; "
                  "src/repro/core/covariance.py:98,128")


def capture_updates(fn):
    """Run ``fn`` with ``ops.rank1_update`` spied on: the inputs of its
    first call at each buffer size m, copied before the call (the scan may
    update in place)."""
    captured, orig = {}, ops.rank1_update

    def spy(xb, cb, roots, mloc, n_valid=None, *, inplace=False):
        if xb.shape[1] not in captured:
            captured[xb.shape[1]] = tuple(None if t is None else t.clone()
                                          for t in (xb, cb, roots, mloc, n_valid))
        return orig(xb, cb, roots, mloc, n_valid, inplace=inplace)

    ops.rank1_update = spy
    try:
        fn()
    finally:
        ops.rank1_update = orig
    return captured


def rank1_live(xb, roots, mloc):
    return mloc & (torch.arange(xb.shape[1], device=xb.device) != roots[:, None])


def hold_rank1(name, xb, cb, roots, mloc, nv):
    """The fit mode against its plain version on one launch's inputs: c'
    and x' bit-equal, each live row's scale within ``cu.SCALE_ULP_TOL`` ulp, columns
    past the valid count +0, dead rows unchanged, and the in-place launch
    the bits of the out-of-place one. Returns the max abs error of x'."""
    kx, kc = cu.launch_rank1(xb, cb, roots, mloc, nv)
    rx, rc = cu.rank1_update_ref(xb, cb, roots, mloc, n_valid=nv)
    own = xb.clone()
    ix, ic = cu.launch_rank1(own, cb, roots, mloc, nv, inplace=True)
    torch.cuda.synchronize()
    live = rank1_live(xb, roots, mloc)
    ulps = cu.scale_ulps(kx, rx, xb, cb, roots, mloc)
    rows = torch.all(kx == rx, dim=-1)[live]
    n = xb.shape[2]
    past = torch.arange(n, device=xb.device) >= (n if nv is None else nv[:, None, None])
    padded_zero = bool(torch.all(kx.masked_select(past.expand_as(kx)) == 0))
    dead_same = torch.equal(kx[~live], xb[~live])
    in_place = torch.equal(ix, kx) and torch.equal(ic, kc)
    err = (kx.double() - rx.double()).abs().max().item()
    ok = (torch.equal(kc, rc) and torch.equal(kx, rx) and float(ulps.max()) <= cu.SCALE_ULP_TOL
          and padded_zero and dead_same and in_place)
    say("rank1_update_vs_plain", case=name, B=xb.shape[0], m=xb.shape[1], n=n,
        n_valid="none" if nv is None else f"{int(nv.min())}-{int(nv.max())}",
        live_rows=int(live.sum()), cb_bit_equal=torch.equal(kc, rc), xb_bit_equal=torch.equal(kx, rx),
        rows_bit_equal=f"{int(rows.sum())}/{rows.numel()}", scale_max_ulp=f"{float(ulps.max()):.3f}",
        scale_ulp_tol=cu.SCALE_ULP_TOL, max_abs_x=f"{err:.3e}", padded_columns_zero=padded_zero,
        dead_rows_unchanged=dead_same, in_place_bit_equal=in_place, ok=ok)
    check(ok, f"{name}: the update kernel's fit mode disagrees with plain")
    return err


def rank1_bytes(xb, cb, roots, mloc, nv):
    """The bytes one launch must move: each live row's valid samples read
    and written, each dataset's root row read, c read and c' written."""
    bsz, m, n = xb.shape
    live = rank1_live(xb, roots, mloc).sum(dim=1).double()
    nvd = torch.full((bsz,), float(n), dtype=torch.float64, device=xb.device) if nv is None \
        else nv.double()
    return float((live * nvd * 8 + nvd * 4 + m * m * 8).sum())


def phase_rank1_update(dev, gpu, core):
    """The update kernel's fit mode (``ops.rank1_update``) against its plain
    version on the inputs the fits give it: the first update of each stage
    of one E. coli dispatch (B=8, m=128, 64, 32, masks and valid counts),
    of the E. coli core fit (its 128-row first stage) and of the p=512
    slice fit, and the core fit's first update with |b| at and past 1
    (clip and floor); then its time per launch at those shapes, in place as
    the scan runs all but the first update (device and event ms), beside
    the out-of-place launch, an empty kernel on the same grid, the plain
    composition and the live bytes' bound. Returns (max abs err, timing of
    the dispatch's m=128 update)."""
    xs, mask, nv, _ = pack_bucket(ecoli_requests(), *ECOLI_BUCKET)
    bucket = capture_updates(lambda: fit_batch(xs, ParaLiNGAMConfig(), n_valid=nv, mask=mask,
                                               device=dev))
    fit85 = capture_updates(lambda: fit(core["x"], ParaLiNGAMConfig(), device=dev))
    x512 = sem.generate(sem.SemSpec(p=SLICE[0], n=SLICE[1], density="sparse", seed=1))["x"]
    fit512 = capture_updates(lambda: fit(x512, ParaLiNGAMConfig(), device=dev))
    cases = [(f"ecoli_bucket_m{m}", bucket[m]) for m in sorted(bucket, reverse=True)]
    # each fit's first update, on its first stage's buffer (128 rows for p=85)
    cases += [("ecoli_fit_p85_n10000", fit85[max(fit85)]),
              ("ijr904_fit_p512_n2000", fit512[max(fit512)])]
    errs = [hold_rank1(name, *args) for name, args in cases]
    xb, cb, roots, mloc, _ = fit85[max(fit85)]
    near = cb.clone()
    r = int(roots[0])
    rows = [int(i) for i in torch.nonzero(rank1_live(xb, roots, mloc)[0])[:6]]
    near[0, rows, r] = torch.tensor([1.0000001, -1.0000001, 0.99999, -0.9999999, 1.0, -1.0],
                                    device=dev)
    errs.append(hold_rank1("clip_and_floor_p85", xb, near, roots, mloc, None))

    timing = None
    for name, (xb, cb, roots, mloc, nvb) in cases:
        bsz, m, n = xb.shape
        own = xb.clone()
        fn = lambda: cu.launch_rank1(own, cb, roots, mloc, nvb, inplace=True)  # noqa: E731
        ms = time_ms(fn, reps=200, warmup=5)
        dev_ms = device_ms(fn, "rank1_update_kernel")
        out_ms = device_ms(lambda: cu.launch_rank1(xb, cb, roots, mloc, nvb),
                           "rank1_update_kernel")
        empty_ms, empty_dev = empty_times(cu.MODE_FIT, bsz, m, n, dev)
        plain_ms = time_ms(lambda: cu.rank1_update_ref(xb, cb, roots, mloc, n_valid=nvb),
                           reps=20, warmup=2)
        bound = rank1_bytes(xb, cb, roots, mloc, nvb) / HBM_BPS * 1e3
        say("rank1_update_kernel_time", case=name, B=bsz, m=m, n=n,
            live_rows=int(rank1_live(xb, roots, mloc).sum()), blocks=cu.blocks(cu.MODE_FIT, bsz, m, n),
            kernel_ms=f"{ms:.5f}", device_ms=f"{dev_ms:.5f}", out_of_place_device_ms=f"{out_ms:.5f}",
            empty_kernel_ms=f"{empty_ms:.5f}", empty_kernel_device_ms=f"{empty_dev:.5f}",
            plain_ms=f"{plain_ms:.5f}", bound_ms=f"{bound:.5f}", bound_by="bytes",
            device_fraction_of_bound=f"{bound / dev_ms:.3f}", gpu=f"'{gpu}'")
        if timing is None:
            timing = (ms, plain_ms, bound, dev_ms, empty_dev,
                      f"B={bsz},m={m},n={n},n_valid={int(nvb.min())}-{int(nvb.max())},in place")
    return max(errs), timing


# (rows, n) of torch.sum over the squares: the fit mode's shapes (the E. coli
# dispatch's stages, the E. coli and p=512 fits) and one of each other shape
# ATen takes (unaligned rows, fewer than 16 rows, scalar loads, a row split
# across blocks).
SUM_ORDER_SHAPES = ((1024, 16384), (512, 16384), (256, 16384), (128, 10_000), (512, 2000),
                    (74, 1301), (8, 3000), (3, 100), (2, 300_000), (40, 131_072))


def phase_rank1_sum_order(dev):
    """The fit mode's sum of squares against torch.sum on the card, bit for
    bit, at each of ``SUM_ORDER_SHAPES``."""
    held = []
    for rows, n in SUM_ORDER_SHAPES:
        x = torch.from_numpy(np.random.default_rng(rows + n).standard_normal((rows, n))
                             .astype(np.float32)).to(dev)
        got, shape = cu.sum_probe(x)
        held.append(torch.equal(got, torch.sum(torch.square(x), dim=-1)))
        say("rank1_sum_order", rows=rows, n=n, torch_block=f"{shape[0]}x{shape[1]}",
            rows_share_block=bool(shape[2]), blocks_per_row=shape[3], vectors=bool(shape[4]),
            bits_equal=held[-1])
    check(all(held), "the fit mode's sum of squares departs from torch.sum's order")


def phase_rank1_scale_probe(dev):
    """The kernel's scale function against torch's CUDA rsqrt (after the
    1e-12 floor): the same bits on every float32 in [0.25, 4) and on 2^20
    random magnitudes in [1e-14, 1e6]."""
    lo, hi = np.float32(0.25).view(np.int32), np.float32(4.0).view(np.int32)
    every = torch.arange(int(lo), int(hi), device=dev, dtype=torch.int32).view(torch.float32)
    wide = torch.from_numpy((10.0 ** np.random.default_rng(0).uniform(-14, 6, 1 << 20))
                            .astype(np.float32)).to(dev)
    same = [torch.equal(cu.scale_probe(v).view(torch.int32),
                        torch.rsqrt(torch.clamp(v, min=1e-12)).view(torch.int32))
            for v in (every, wide)]
    say("rank1_scale_probe", points=every.numel() + wide.numel(), bits_equal_to_torch_rsqrt=all(same))
    check(all(same), "the kernel's rsqrt differs from torch's on the card")


def ssd_inputs(b, h, p, n, dev, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, h, p, n)), rng.standard_normal((b, h, p)),
              rng.uniform(0.01, 0.5, (b, h)), rng.standard_normal((b, n)),
              rng.standard_normal((b, n)), -rng.uniform(0.5, 2.0, (h,)),
              rng.standard_normal((h,))]
    return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in arrays]


def hold_ssd(name, args):
    """The decode kernel against its plain version on one input: the new
    state bit-equal (both round each product and sum on its own), y within
    ATOL/RTOL. Returns the max abs error of y and of the new state."""
    yk, sk = sd.ssd_decode(*args)
    yr, sr = sd.ssd_decode_ref(*args)
    torch.cuda.synchronize()
    ey, oky = within(yk, yr, ATOL)
    es, oks = within(sk, sr, ATOL)
    same = torch.equal(sk, sr)
    say("ssd_decode_vs_plain", case=name, shape="x".join(map(str, args[0].shape)),
        max_abs_y=f"{ey:.3e}", max_abs_state=f"{es:.3e}", state_bit_equal=same,
        ok=oky and oks and same)
    check(oky and oks and same, f"{name}: the decode kernel disagrees with plain")
    return max(ey, es)


def ssd_bytes(b, h, p, n):
    """Bytes a decode step must move: the state read and the new state
    written, x and y, dt, B and C, A and D, each once."""
    return 4 * (2 * b * h * p * n + 2 * b * h * p + b * h + 2 * b * n + 2 * h)


def offset_copies(args):
    """Copies of ``args`` whose data start 4 bytes past a 16-byte boundary:
    the kernel's scalar path, on the same values."""
    out = []
    for t in args:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        out.append(view)
    return out


def decode_rows(shape, dev, seed):
    """Whether row b of a launch equals a one-row launch of the row's
    contiguous views, for every b, and a repeat launch equals the first."""
    args = ssd_inputs(*shape, dev, seed)
    y, s = sd.launch(*args)
    rows = []
    for b in range(shape[0]):
        y1, s1 = sd.launch(*[t[b:b + 1].contiguous() for t in args[:5]], *args[5:])
        rows.append(torch.equal(y1[0], y[b]) and torch.equal(s1[0], s[b]))
    repeat = all(torch.equal(u, v) for u, v in zip(sd.launch(*args), (y, s)))
    return rows, repeat, args, (y, s)


def phase_ssd_kernel(dev, gpu, rate):
    """The decode kernel against its plain version at Mamba2-370M's decode
    shape (B=4, H=32, P=64, N=128), at ragged head counts, P not a multiple
    of the kernel's 16-row P-slice and N not a multiple of 4; row b of a B=4 launch
    bit-identical to a one-row launch (N=128, and N=37 whose views are not
    16-byte aligned); the scalar path on offset copies bit-identical to the
    vector path; times per launch."""
    cfg = configs.get("mamba2-370m")
    full = (SERVE_B, cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
    errs = [hold_ssd(f"random_{'x'.join(map(str, s))}", ssd_inputs(*s, dev, i))
            for i, s in enumerate((full, (3, 12, 64, 128), (2, 5, 24, 40), (1, 33, 64, 128),
                                   (2, 5, 24, 37), (2, 3, 70, 130)))]
    rows, repeat, args, (y, s) = decode_rows(full, dev, 9)
    rows37, repeat37, _, _ = decode_rows((4, 5, 24, 37), dev, 10)
    paths = all(torch.equal(u, v) for u, v in zip(sd.launch(*offset_copies(args)), (y, s)))
    say("ssd_decode_rows", B=SERVE_B, rows_bit_identical=f"{sum(rows)}/{len(rows)}",
        rows_bit_identical_n37=f"{sum(rows37)}/{len(rows37)}",
        repeat_bit_identical=repeat and repeat37, scalar_path_bit_identical=paths)
    check(all(rows) and all(rows37) and repeat and repeat37,
          "a row of the decode kernel depends on its batch or run")
    check(paths, "the decode kernel's scalar path differs from its vector path")
    return max(errs), ssd_times(args, rate, gpu)


def ssd_times(args, rate, gpu):
    """The decode kernel's times on ``args`` (launch, wrapper, device,
    plain) beside the bytes bound. Returns (ms, plain ms, bound ms, shape,
    device ms, wrapper ms)."""
    full = tuple(args[0].shape)
    shape = "B={},H={},P={},N={}".format(*full)
    ms = time_ms(lambda: sd.launch(*args), reps=200, warmup=5)
    wrapper_ms = time_ms(lambda: sd.ssd_decode(*args), reps=200, warmup=5)
    dev_ms = device_ms(lambda: sd.launch(*args), "ssd_decode_heads")
    plain_ms = time_ms(lambda: sd.ssd_decode_ref(*args), reps=50, warmup=2)
    nbytes = ssd_bytes(*full)
    bound = max(nbytes / HBM_BPS, 5 * np.prod(full) / FP32_FLOPS) * 1e3
    say("ssd_decode_kernel_time", shape=shape, kernel_ms=f"{ms:.5f}",
        wrapper_ms=f"{wrapper_ms:.5f}", device_ms=f"{dev_ms:.5f}", plain_ms=f"{plain_ms:.5f}",
        bound_ms=f"{bound:.5f}", bound_by="bytes", bound_ms_at_copy_rate=f"{nbytes / rate * 1e3:.5f}",
        kernel_fraction_of_bound=f"{bound / ms:.3f}",
        device_fraction_of_bound=f"{bound / dev_ms:.3f}", gpu=f"'{gpu}'")
    return ms, plain_ms, bound, shape, dev_ms, wrapper_ms


def capture_decode_inputs(params, cfg, tokens, dev):
    """The ``ssd_decode`` inputs of every SSM layer of one real decode step
    after a prefill of ``tokens`` (attention K/V grown by the one new
    position), in layer order."""
    calls, orig = [], ops.ssd_decode

    def spy(*args):
        calls.append([a.clone() for a in args])
        return orig(*args)

    logits, caches = lm.prefill(params, tokens, cfg, max_seq=tokens.shape[1] + 1)
    ops.ssd_decode = spy
    try:
        lm.decode_step(params, torch.argmax(logits, dim=-1), caches,
                       torch.full((tokens.shape[0],), tokens.shape[1], device=dev), cfg)
    finally:
        ops.ssd_decode = orig
    return calls


def profile_generate(run, eng, prompts, gpu):
    """Where one ``generate``'s time goes, by device kernel, and the
    device's busy share of its wall time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = timed(lambda: eng.generate(prompts))
    rows = device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    say("profile", run=run, wall_s=f"{wall:.4f}", device_busy_s=f"{busy_us / 1e6:.4f}",
        device_busy_share=f"{busy_us / 1e6 / wall:.3f}",
        device_kernels=sum(r[2] for r in rows), gpu=f"'{gpu}'")
    say_rows(run, rows, busy_us)


def replay(params, cfg, prompts, tokens, step, dev="cpu"):
    """The engine's greedy loop on ``dev`` up to decode step ``step``, fed
    ``tokens``: the logits from which token ``step`` is drawn."""
    s = prompts.shape[1]
    padded = np.pad(prompts, ((0, 0), (0, bucket_dim(s) - s)))
    logits, caches = lm.prefill(params, torch.as_tensor(padded, dtype=torch.int64, device=dev), cfg,
                                max_seq=padded.shape[1] + step)
    for i in range(step):
        tok = torch.as_tensor(tokens[:, i], dtype=torch.int64, device=dev)
        logits, caches = lm.decode_step(params, tok, caches,
                                        torch.full((len(tok),), s + i, device=dev), cfg)
    return logits


def cpu_top2_gap(params, cfg, prompts, tokens, step, row):
    """The CPU run's top-2 logit gap of sequence ``row`` at decode step
    ``step``, replaying its greedy loop (``tokens`` are its own)."""
    top = torch.topk(replay(params, cfg, prompts, tokens, step)[row].double(), 2).values
    return float(top[0] - top[1])


def phase_mamba2_serve(dev, gpu, profile=False):
    """Mamba2-370M at full width and depth (48 layers, vocab 50280) through
    ``Engine.generate`` on the card: B=4 prompts of 32 tokens, 16 new tokens,
    768 decode-kernel launches; greedy tokens against a CPU run of the same
    weights; the kernel against plain on inputs of layers 0 and 47 of a
    real decode step. Returns (launches, max error, prefill and decode times)."""
    cfg = configs.get("mamba2-370m")
    params, init_s = timed(lambda: lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev))
    prompts = serve_prompts(cfg)
    want = cfg.n_layers * SERVE_NEW
    out, wall, peak_gb, launched = generate_on(params, cfg, prompts, dev, gpu, {"ssd_decode": want},
                                               "mamba2 float32", "mamba2_generate" if profile else None)
    prefill_s, step_s = step_times(params, cfg, prompts, dev)
    same_rows, logit_diff, cpu_s = hold_tokens_against_cpu("mamba2", cfg, params, prompts, dev)
    say("mamba2_serve", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=cfg.n_ssm_heads, state=f"{cfg.ssm_headdim}x{cfg.ssm_state}", vocab=cfg.vocab,
        params_m=f"{tree_numel(params) / 1e6:.1f}", init_s=f"{init_s:.3f}", batch=SERVE_B,
        prompt_len=SERVE_PROMPT, new_tokens=SERVE_NEW,
        ssd_decode_launches=launched["ssd_decode"],
        generate_s=f"{wall:.4f}", tok_per_s=f"{SERVE_B * SERVE_NEW / wall:.1f}",
        prefill_s=f"{prefill_s:.4f}", decode_step_s=f"{np.mean(step_s):.5f}",
        decode_step_s_min=f"{min(step_s):.5f}", peak_gb=f"{peak_gb:.3f}",
        rows_equal_to_cpu=f"{same_rows}/{SERVE_B}", prefill_logits_max_abs_diff=f"{logit_diff:.3e}",
        cpu_generate_s=f"{cpu_s:.3f}", sample=",".join(map(str, out[0][:8])), gpu=f"'{gpu}'")

    # The decode kernel on the inputs of layers 0 and 47 of a real step.
    toks = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    calls = capture_decode_inputs(params, cfg, toks, dev)
    check(len(calls) == cfg.n_layers, f"{len(calls)} decode-kernel calls in one step")
    err = max(hold_ssd(f"layer{i}", calls[i]) for i in (0, cfg.n_layers - 1))
    return launched["ssd_decode"], err, (prefill_s, float(np.mean(step_s)), wall)


# ---------------------------------------------------------------------------
# the attention families (models/attention.py, models/lm.py) and the hybrid
# ---------------------------------------------------------------------------

# Attention against attention on the card (the blocked, windowed and decode
# forms against the masked full form): the CPU tests' float32 tolerance, the
# same formulas with sums over the same keys taken in other orders.
ATTN_RTOL, ATTN_ATOL = 1e-4, 1e-5
# Layers of the granite-3-2b and zamba2-2.7b cuts run on the CPU beside the
# card: granite's first 8 layers; zamba2's first group (6 SSM layers and the
# shared block).
GRANITE_CUT, ZAMBA2_CUT = 8, 6
# bfloat16 weights against the float32 ones they round, on the card: the
# prefill logits within this share of the largest float32 logit. Measured on
# the CPU at full width, 1 to 4 layers: 1.0-1.3% (logits up to ~4.8).
BF16_SHARE = 0.1
# The int8 KV cache at full width: the decode logits within this share of
# the largest ``forward`` logit. The reference's absolute 0.05
# (tests/test_serve.py) is set for the smoke model's logits (up to ~0.65);
# at full width (logits up to ~4.5) the error measured on the CPU at 1 to 8
# layers is 0.045-0.055, 1.0-1.2% of the scale. The smoke model on the card
# is held to the reference's own 0.05.
INT8_SHARE, INT8_SMOKE_ATOL = 0.05, 0.05


def tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(v, fn) for v in tree)
    return fn(tree)


def tree_numel(tree) -> int:
    total = []
    tree_map(tree, lambda t: total.append(t.numel()))
    return sum(total)


def free():
    """Return the allocator's cached blocks, so that the next phase loads
    its own weights into a free card (the previous phase's tensors are
    dropped first: ``del``, or the phase function's return)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def serve_prompts(cfg, b=SERVE_B, s=SERVE_PROMPT, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def generate_on(params, cfg, prompts, dev, gpu, want: dict, what: str, profile_run=None):
    """The main path: ``Engine.generate`` after a warm-up, with every kernel
    count set to 0 just before it and read just after; the counts must equal
    ``want`` (0 for every kernel it does not name). A second generate gives
    the same tokens; with ``profile_run`` a third runs under the profiler.
    Returns (tokens, seconds, peak GB, the launches counted)."""
    eng = Engine(params, cfg, ServeConfig(max_new_tokens=SERVE_NEW), device=dev)
    eng.generate(prompts)  # warm-up: library handles, allocator
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out, wall = timed(lambda: eng.generate(prompts))
    launched = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect = {k: want.get(k, 0) for k in launched}
    check(launched == expect, f"{what}: launches {launched}, want {expect}")
    check(out.shape == (len(prompts), SERVE_NEW) and bool(np.all((out >= 0) & (out < cfg.vocab))),
          f"{what}: tokens of shape {out.shape} outside the vocabulary")
    check(np.array_equal(out, eng.generate(prompts)), f"{what}: two generates differ")
    if profile_run:
        profile_generate(profile_run, eng, prompts, gpu)
    return out, wall, peak_gb, launched


def step_times(params, cfg, prompts, dev):
    """The prefill's seconds and each decode step's, fed greedy tokens."""
    b, s = prompts.shape
    toks = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    (logits, caches), prefill_s = timed(lambda: lm.prefill(params, toks, cfg, max_seq=s + SERVE_NEW))
    tok, steps = torch.argmax(logits, dim=-1), []
    for i in range(SERVE_NEW):
        (logits, caches), t = timed(lambda: lm.decode_step(
            params, tok, caches, torch.full((b,), s + i, device=dev), cfg))
        steps.append(t)
        tok = torch.argmax(logits, dim=-1)
    return prefill_s, steps


def hold_tokens_against_cpu(tag, cfg, params, prompts, dev):
    """Greedy tokens on the card against a CPU run of the same weights (the
    whole model, or a cut of it): equal, or departing only where the CPU's
    top-2 logits lie within ``GAP_TOL``, or (an MoE model) where the two
    runs, fed the CPU's tokens up to the departure, routed a token to other
    experts at a routing near-tie that can reach the departing row
    (``flip_in_row``). Returns (rows equal, prefill logit diff, CPU seconds)."""
    cpu_params = tree_map(params, lambda t: t.cpu())
    scfg = ServeConfig(max_new_tokens=SERVE_NEW)
    out = Engine(params, cfg, scfg, device=dev).generate(prompts)
    before = sd.LAUNCHES
    cpu_out, cpu_s = timed(lambda: Engine(cpu_params, cfg, scfg, device="cpu").generate(prompts))
    check(sd.LAUNCHES == before, f"{tag}: the CPU route launched the kernel")
    toks = torch.as_tensor(prompts, dtype=torch.int64)
    cpu_logits, _ = lm.prefill(cpu_params, toks, cfg)
    gpu_logits, _ = lm.prefill(params, toks.to(dev), cfg)
    v = cfg.vocab
    logit_diff = (gpu_logits[:, :v].cpu().double() - cpu_logits[:, :v].double()).abs().max().item()
    same_rows = 0
    for r in range(len(prompts)):
        if np.array_equal(out[r], cpu_out[r]):
            same_rows += 1
            continue
        k = int(np.flatnonzero(out[r] != cpu_out[r])[0])
        gap = cpu_top2_gap(cpu_params, cfg, prompts, cpu_out, k, r)
        routed, excuse = {}, None
        if cfg.is_moe and gap > GAP_TOL:
            flips = routing_flips(tag, params, cpu_params, cfg, prompts, cpu_out, k, dev)
            excuse = flip_in_row(flips, r, len(prompts), cfg)
            routed = {"routing_flips": len(flips), "routing_near_tie": excuse is not None}
            if excuse is not None:
                routed.update(excused_by_moe_call=excuse[0], excused_by_token=excuse[1],
                              excused_because=excuse[2])
        say("token_departure", case=tag, row=r, step=k, card_token=int(out[r, k]),
            cpu_token=int(cpu_out[r, k]), cpu_top2_gap=f"{gap:.3e}", allowed=GAP_TOL,
            near_tie=gap <= GAP_TOL, **routed)
        check(gap <= GAP_TOL or excuse is not None,
              f"{tag}: sequence {r} departs from the CPU run at step {k} beyond a near-tie")
    return same_rows, logit_diff, cpu_s


def to_bf16(params):
    """The float32 weights rounded to bfloat16, the norm scales kept in
    float32 (the layout ``init_params`` gives at ``cfg.dtype``)."""
    return tree_map(params, lambda t: t.to(torch.bfloat16) if t.ndim >= 2 else t)


def int8_decode_error(params, cfg, b, s, dev, seed):
    """``tests/test_serve.py::test_int8_kv_cache_close_to_bf16`` at ``cfg``:
    prefill S-1 tokens into an int8 cache of S, decode the last; returns
    (max abs diff to ``forward``'s logits, their largest magnitude, argmax
    equal, ``forward``'s top-2 gap where it differs)."""
    cfg_q = cfg.with_overrides(kv_quant="int8")
    toks = torch.as_tensor(np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)),
                           device=dev)
    full = lm.forward(params, toks, cfg)[:, s - 1, :cfg.vocab].double()
    _, caches = lm.prefill(params, toks[:, : s - 1], cfg_q, max_seq=s)
    check(caches["groups"][0]["pos0"][0].dtype == torch.int8, "the int8 cache is not int8")
    dec, _ = lm.decode_step(params, toks[:, s - 1], caches, torch.full((b,), s - 1, device=dev),
                            cfg_q)
    dec = dec[:, :cfg.vocab].double()
    same = torch.argmax(dec, -1) == torch.argmax(full, -1)
    top = torch.topk(full, 2).values
    gap = (top[:, 0] - top[:, 1])[~same]
    return ((dec - full).abs().max().item(), full.abs().max().item(), bool(same.all()),
            gap.max().item() if gap.numel() else 0.0)


def phase_granite_serve(dev, gpu, profile=False):
    """granite-3-2b at full width and depth (40 layers, d_model 2048, 32/8
    heads, vocab 49155, tied), float32 weights from a seeded generator,
    through ``Engine.generate`` (B=4 prompts of 32, 16 new tokens): no hand
    kernel on this path; the first 8 layers' tokens against a CPU run; then
    the same weights in bfloat16, and the int8 KV cache. Returns the float32
    parameters and config for the long prefill."""
    cfg = configs.get("granite-3-2b")
    params, init_s = timed(lambda: lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev))
    prompts = serve_prompts(cfg)
    out, wall, peak_gb, _ = generate_on(params, cfg, prompts, dev, gpu, {}, "granite float32",
                                     "granite_generate" if profile else None)
    prefill_s, steps = step_times(params, cfg, prompts, dev)

    cut_cfg = cfg.with_overrides(n_layers=GRANITE_CUT)
    cut = {**params, "groups": params["groups"][:GRANITE_CUT]}
    same_rows, logit_diff, cpu_s = hold_tokens_against_cpu("granite_cut", cut_cfg, cut, prompts, dev)
    say("granite_serve", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim}", vocab=cfg.vocab,
        params_m=f"{tree_numel(params) / 1e6:.1f}", dtype="float32", init_s=f"{init_s:.3f}",
        batch=SERVE_B, prompt_len=SERVE_PROMPT, new_tokens=SERVE_NEW, kernel_launches=0,
        generate_s=f"{wall:.4f}", tok_per_s=f"{SERVE_B * SERVE_NEW / wall:.1f}",
        prefill_s=f"{prefill_s:.4f}", decode_step_s=f"{np.mean(steps):.5f}",
        decode_step_s_min=f"{min(steps):.5f}", peak_gb=f"{peak_gb:.3f}",
        cut_layers=GRANITE_CUT, cut_rows_equal_to_cpu=f"{same_rows}/{SERVE_B}",
        cut_prefill_logits_max_abs_diff=f"{logit_diff:.3e}", cpu_generate_s=f"{cpu_s:.3f}",
        sample=",".join(map(str, out[0][:8])), gpu=f"'{gpu}'")

    # bfloat16: the same weights rounded, against the float32 run.
    p16 = to_bf16(params)
    out16, wall16, peak16, _ = generate_on(p16, cfg, prompts, dev, gpu, {}, "granite bfloat16")
    prefill16_s, steps16 = step_times(p16, cfg, prompts, dev)
    toks = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    l32 = lm.prefill(params, toks, cfg)[0][:, :cfg.vocab].double()
    l16 = lm.prefill(p16, toks, cfg)[0][:, :cfg.vocab].double()
    d16, scale = (l16 - l32).abs().max().item(), l32.abs().max().item()
    check(d16 <= BF16_SHARE * scale,
          f"bfloat16 prefill logits {d16:.3e} from float32's, beyond {BF16_SHARE} of {scale:.3e}")
    first_equal = int((torch.argmax(l16, -1) == torch.argmax(l32, -1)).sum())
    say("granite_serve_bf16", dtype="bfloat16", generate_s=f"{wall16:.4f}",
        tok_per_s=f"{SERVE_B * SERVE_NEW / wall16:.1f}", prefill_s=f"{prefill16_s:.4f}",
        decode_step_s=f"{np.mean(steps16):.5f}", peak_gb=f"{peak16:.3f}",
        prefill_logits_max_abs_diff_vs_float32=f"{d16:.4e}", float32_logit_scale=f"{scale:.4f}",
        share=f"{d16 / scale:.4f}", allowed_share=BF16_SHARE,
        first_token_equal=f"{first_equal}/{SERVE_B}",
        rows_equal_to_float32=f"{sum(np.array_equal(a, b) for a, b in zip(out16, out))}/{SERVE_B}",
        gpu=f"'{gpu}'")
    del p16, l16, l32
    free()  # the bfloat16 copy, before the int8 runs

    # The int8 KV cache: full width, and the reference test's smoke model.
    cfg_q = cfg.with_overrides(kv_quant="int8")
    out8, wall8, peak8, _ = generate_on(params, cfg_q, prompts, dev, gpu, {}, "granite int8 KV")
    _, steps8 = step_times(params, cfg_q, prompts, dev)
    err, scale8, same8, gap8 = int8_decode_error(params, cfg, 2, 16, dev, seed=1)
    check(err <= INT8_SHARE * scale8,
          f"int8 KV decode logits {err:.3e} from forward's, beyond {INT8_SHARE} of {scale8:.3e}")
    check(same8 or gap8 <= 2 * err, "int8 KV decode changed a greedy token beyond a near-tie")
    smoke = configs.smoke("granite-3-2b")
    sp = lm.init_params(smoke, seed=0, dtype=torch.float32, device=dev)
    err_s, _, same_s, _ = int8_decode_error(sp, smoke, 2, 16, dev, seed=1)
    check(err_s < INT8_SMOKE_ATOL and same_s,
          f"int8 KV at the smoke size: {err_s:.3e} (reference bound {INT8_SMOKE_ATOL}), "
          f"argmax equal {same_s}")
    say("granite_serve_int8", kv_quant="int8", generate_s=f"{wall8:.4f}",
        tok_per_s=f"{SERVE_B * SERVE_NEW / wall8:.1f}", decode_step_s=f"{np.mean(steps8):.5f}",
        peak_gb=f"{peak8:.3f}",
        decode_vs_forward_max_abs=f"{err:.4e}", forward_logit_scale=f"{scale8:.4f}",
        share=f"{err / scale8:.4f}", allowed_share=INT8_SHARE, argmax_equal=same8,
        smoke_decode_vs_forward_max_abs=f"{err_s:.4e}", smoke_allowed=INT8_SMOKE_ATOL,
        rows_equal_to_float32_cache=f"{sum(np.array_equal(a, b) for a, b in zip(out8, out))}/{SERVE_B}",
        gpu=f"'{gpu}'")
    return params, cfg


def layer0_qkv(params, cfg, toks):
    """Layer 0's q, k, v (and positions) for the tokens, as the prefill
    computes them."""
    lp = params["groups"][0]["pos0"]
    b, s = toks.shape
    pos = torch.arange(s, device=toks.device)[None, :].expand(b, s)
    h = rmsnorm(embed(params["embed"], toks), lp["ln1"], cfg.norm_eps)
    return (*attn.qkv(lp["attn"], h, cfg, pos), pos)


def phase_granite_prefill_long(dev, gpu, params, cfg):
    """One 1024-token prompt at full width: ``pick_q_chunk`` gives 512, so
    every layer's blocked attention runs in 2 chunks; layer 0's q, k, v
    through ``blocked_attention`` against ``causal_attention``."""
    s = 1024
    toks = torch.as_tensor(serve_prompts(cfg, 1, s, seed=2), dtype=torch.int64, device=dev)
    lm.prefill(params, toks, cfg)  # warm-up
    reset_counts()
    (logits, _), prefill_s = timed(lambda: lm.prefill(params, toks, cfg))
    launched = counts()
    check(sum(launched.values()) == 0, f"the long prefill launched {launched}")
    check(bool(torch.all(torch.isfinite(logits[:, :cfg.vocab]))), "non-finite prefill logits")
    chunk = attn.pick_q_chunk(1, cfg.n_heads, s)
    check(chunk == 512, f"pick_q_chunk gave {chunk} at S={s}")
    q, k, v, pos = layer0_qkv(params, cfg, toks)
    blocked = attn.blocked_attention(q, k, v, pos, pos, 0, chunk)
    full = attn.causal_attention(q, k, v, pos, pos)
    diff, ok = within(blocked, full, ATTN_ATOL, ATTN_RTOL)
    check(ok, f"blocked attention in {s // chunk} chunks disagrees with causal_attention: {diff:.3e}")
    blocked_ms = time_ms(lambda: attn.blocked_attention(q, k, v, pos, pos, 0, chunk), reps=10)
    full_ms = time_ms(lambda: attn.causal_attention(q, k, v, pos, pos), reps=10)
    say("granite_prefill_long", prompt_len=s, q_chunk=chunk, chunks=s // chunk,
        prefill_s=f"{prefill_s:.4f}", prefill_tok_per_s=f"{s / prefill_s:.1f}",
        layer0_blocked_vs_causal_max_abs=f"{diff:.3e}", rtol=ATTN_RTOL, atol=ATTN_ATOL,
        blocked_ms=f"{blocked_ms:.4f}", causal_ms=f"{full_ms:.4f}", gpu=f"'{gpu}'")


def phase_gemma3_window(dev, gpu):
    """gemma3-12b at full width cut to one group (5 local layers of window
    1024 + 1 global), a 2048-token prompt: the windowed blocked path (2
    chunks, each over 2W keys) against the masked full form on layer 0, then
    decode past the window: ``decode_attention`` against the masked full
    form on layer 0's cache."""
    cfg = configs.get("gemma3-12b").with_overrides(n_layers=6)
    w, s, extra = cfg.window, 2048, 4
    params, init_s = timed(lambda: lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev))
    toks = torch.as_tensor(serve_prompts(cfg, 1, s, seed=3), dtype=torch.int64, device=dev)
    lm.prefill(params, toks, cfg, max_seq=s + extra)  # warm-up
    reset_counts()
    (logits, caches), prefill_s = timed(lambda: lm.prefill(params, toks, cfg, max_seq=s + extra))
    tok, steps = torch.argmax(logits, dim=-1), []
    for i in range(extra):
        (logits, caches), t = timed(lambda: lm.decode_step(
            params, tok, caches, torch.full((1,), s + i, device=dev), cfg))
        steps.append(t)
        tok = torch.argmax(logits, dim=-1)
    launched = counts()
    check(sum(launched.values()) == 0, f"the gemma3 path launched {launched}")
    check(bool(torch.all(torch.isfinite(logits[:, :cfg.vocab]))), "non-finite decode logits")

    q, k, v, pos = layer0_qkv(params, cfg, toks)
    blocked = attn.blocked_attention(q, k, v, pos, pos, w)
    full = attn.causal_attention(q, k, v, pos, pos, w)
    diff_b, ok_b = within(blocked, full, ATTN_ATOL, ATTN_RTOL)
    check(ok_b, f"windowed blocked attention disagrees with the masked form: {diff_b:.3e}")
    blocked_ms = time_ms(lambda: attn.blocked_attention(q, k, v, pos, pos, w), reps=10)
    full_ms = time_ms(lambda: attn.causal_attention(q, k, v, pos, pos, w), reps=10)

    # One new token at position s, past the window, over layer 0's cache.
    lp = params["groups"][0]["pos0"]
    gen = torch.Generator(device=dev).manual_seed(4)
    h = torch.randn((1, 1, cfg.d_model), generator=gen, device=dev)
    qn, kn, vn = attn.qkv(lp["attn"], h, cfg, torch.full((1, 1), s, device=dev))
    kc, vc = (t.clone() for t in caches["groups"][0]["pos0"])
    at = torch.full((1,), s, device=dev)
    attn._cache_write(kc, kn, at)
    attn._cache_write(vc, vn, at)
    kv_pos = torch.arange(kc.shape[1], device=dev)[None, :]
    dec = attn.decode_attention(qn, kc, vc, at + 1, w)
    masked = attn.causal_attention(qn, kc, vc, at[:, None], kv_pos, w)
    diff_d, ok_d = within(dec, masked, ATTN_ATOL, ATTN_RTOL)
    check(ok_d, f"decode_attention past the window disagrees with the masked form: {diff_d:.3e}")
    dec_ms = time_ms(lambda: attn.decode_attention(qn, kc, vc, at + 1, w), reps=50)
    masked_ms = time_ms(lambda: attn.causal_attention(qn, kc, vc, at[:, None], kv_pos, w), reps=50)
    say("gemma3_window", arch=cfg.name, layers=f"{cfg.local_global_ratio}x attn_w(window={w}) + 1 attn",
        d_model=cfg.d_model, heads=f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim}",
        params_m=f"{tree_numel(params) / 1e6:.1f}", init_s=f"{init_s:.3f}", prompt_len=s,
        prefill_s=f"{prefill_s:.4f}", decode_step_s=f"{np.mean(steps):.5f}",
        layer0_windowed_blocked_vs_masked_max_abs=f"{diff_b:.3e}",
        blocked_ms=f"{blocked_ms:.4f}", masked_ms=f"{full_ms:.4f}", decode_pos=s,
        decode_vs_masked_max_abs=f"{diff_d:.3e}", decode_attention_ms=f"{dec_ms:.4f}",
        masked_decode_ms=f"{masked_ms:.4f}", rtol=ATTN_RTOL, atol=ATTN_ATOL, gpu=f"'{gpu}'")


def phase_zamba2_serve(dev, gpu, rate, profile=False):
    """zamba2-2.7b at full width and depth (54 Mamba2 layers in 9 groups,
    each closed by the shared attention block) through ``Engine.generate``:
    one ``ssd_decode`` launch per SSM layer and step (864), nothing else;
    the first group's tokens against a CPU run; the kernel against plain
    on the inputs of SSM layers 0 and 53 of a real decode step, and its
    times at this path's shape. Returns (launches, max error, timing)."""
    cfg = configs.get("zamba2-2.7b")
    params, init_s = timed(lambda: lm.init_params(cfg, seed=0, dtype=torch.float32, device=dev))
    prompts = serve_prompts(cfg)
    ssm_layers = cfg.n_groups * cfg.hybrid_attn_every
    want = ssm_layers * SERVE_NEW
    out, wall, peak_gb, launched = generate_on(params, cfg, prompts, dev, gpu, {"ssd_decode": want},
                                               "zamba2 float32",
                                               "zamba2_generate" if profile else None)
    prefill_s, steps = step_times(params, cfg, prompts, dev)
    cut_cfg = cfg.with_overrides(n_layers=ZAMBA2_CUT)
    cut = {**params, "groups": params["groups"][:cut_cfg.n_groups]}
    same_rows, logit_diff, cpu_s = hold_tokens_against_cpu("zamba2_cut", cut_cfg, cut, prompts, dev)
    say("zamba2_serve", arch=cfg.name, ssm_layers=ssm_layers, shared_block_applications=cfg.n_groups,
        d_model=cfg.d_model, ssm_heads=cfg.n_ssm_heads, state=f"{cfg.ssm_headdim}x{cfg.ssm_state}",
        vocab=cfg.vocab, params_m=f"{tree_numel(params) / 1e6:.1f}", init_s=f"{init_s:.3f}",
        batch=SERVE_B, prompt_len=SERVE_PROMPT, new_tokens=SERVE_NEW,
        ssd_decode_launches=launched["ssd_decode"],
        generate_s=f"{wall:.4f}", tok_per_s=f"{SERVE_B * SERVE_NEW / wall:.1f}",
        prefill_s=f"{prefill_s:.4f}", decode_step_s=f"{np.mean(steps):.5f}",
        decode_step_s_min=f"{min(steps):.5f}", peak_gb=f"{peak_gb:.3f}",
        cut_layers=f"{ZAMBA2_CUT}+shared", cut_rows_equal_to_cpu=f"{same_rows}/{SERVE_B}",
        cut_prefill_logits_max_abs_diff=f"{logit_diff:.3e}", cpu_generate_s=f"{cpu_s:.3f}",
        sample=",".join(map(str, out[0][:8])), gpu=f"'{gpu}'")

    # The decode kernel on the inputs of SSM layers 0 and 53 of a real step.
    toks = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    calls = capture_decode_inputs(params, cfg, toks, dev)
    check(len(calls) == ssm_layers, f"{len(calls)} decode-kernel calls in one zamba2 step")
    err = max(hold_ssd(f"zamba2_layer{i}", calls[i]) for i in (0, ssm_layers - 1))
    return launched["ssd_decode"], err, ssd_times(calls[0], rate, gpu)


# ---------------------------------------------------------------------------
# MLA and MoE (models/attention.py's mla_block, models/moe.py)
# ---------------------------------------------------------------------------

# deepseek-v2-lite's cut run on the CPU beside the card: the dense MLA
# prologue and the first 2 MLA+MoE groups, upcast to float32. llama4-scout
# is served at full width cut to its first 8 of 48 layers: its 48 x 16
# experts (~216 GB in bfloat16) do not fit one card.
DEEPSEEK_CUT_GROUPS, LLAMA4_LAYERS = 2, 8
# A routing near-tie, float32 on both sides: the CPU's k-th and (k+1)-th
# router probabilities within this gap. The router is one (T, D) x (D, E)
# float32 product and a softmax; the card and the CPU sum the product in
# other orders, which moves a probability by ~1e-7 (D=2048, logits of
# order 1), while the gap between neighbouring probabilities of 64 experts
# is ~4e-3 on these random weights.
ROUTE_TOL = 1e-5
# llama4's first MoE layer on the card against the CPU, in bfloat16: within
# this many bf16 ulps of the largest |out| (the rule of the CPU tests'
# bfloat16 tolerance, tests/test_torch_moe.py).
MOE_BF16_ULPS = 5
# Host RAM (GB, /proc/meminfo's MemAvailable, the "available" column of
# `free -g`) a CPU run needs per GB of the weights it copies: the copy,
# the activations and the caller's own copies.
HOST_RAM_FACTOR = 3


def host_ram_gb() -> tuple[float, float]:
    """(available, total) GB of host RAM, as ``free -g`` reads them."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            info[key] = int(value.split()[0]) * 1024 / 1e9
    return info["MemAvailable"], info["MemTotal"]


def capture_moe(fn):
    """Run ``fn`` with the (router, layer input (T, D)) of every MoE layer
    it runs recorded, in call order. Returns (fn's result, the calls)."""
    calls, orig = [], moe._moe_local

    def spy(params, x2d, cfg, *rest):
        calls.append((params["router"], x2d))
        return orig(params, x2d, cfg, *rest)

    moe._moe_local = spy
    try:
        out = fn()
    finally:
        moe._moe_local = orig
    return out, calls


def routing_differences(router_a, xa, router_b, xb, k):
    """The tokens whose expert set under ``router_a`` on ``xa`` differs from
    that under ``router_b`` on ``xb``: (token, b's k-th minus (k+1)-th
    probability, a's experts, b's experts)."""
    _, _, ea = moe.route(router_a, xa, k)
    pb, _, eb = moe.route(router_b, xb, k)
    ea, eb = ea.sort(-1).values.cpu(), eb.sort(-1).values.cpu()
    top = pb.sort(-1, descending=True).values.cpu().double()
    return [(t, float(top[t, k - 1] - top[t, k]), ea[t].tolist(), eb[t].tolist())
            for t in torch.nonzero((ea != eb).any(-1)).flatten().tolist()]


def hold_flips(tag, call, diffs):
    """Print each token of MoE call ``call`` that ``routing_differences``
    found routed to other experts on the card than on the CPU; raise unless
    every one lies at a routing near-tie. Returns their token indices."""
    for tok, gap, card_e, cpu_e in diffs:
        say("routing_near_tie", case=tag, moe_call=call, token=tok, card_experts=card_e,
            cpu_experts=cpu_e, cpu_gap=f"{gap:.3e}", allowed=ROUTE_TOL, near_tie=gap <= ROUTE_TOL)
        check(gap <= ROUTE_TOL, f"{tag}: MoE call {call} token {tok} routed to {card_e} on the "
              f"card and {cpu_e} on the CPU beyond a near-tie ({gap:.3e})")
    return [d[0] for d in diffs]


def routing_flips(tag, params, cpu_params, cfg, prompts, tokens, step, dev):
    """Both runs fed the CPU's ``tokens`` through the prefill and ``step``
    decode steps; each MoE call's routing on the card (its own input) and
    on the CPU (its own input), held by ``hold_flips``. Returns the flips as
    (MoE call, token, tokens in that call)."""
    _, card = capture_moe(lambda: replay(params, cfg, prompts, tokens, step, dev))
    _, cpu = capture_moe(lambda: replay(cpu_params, cfg, prompts, tokens, step))
    return [(i, tok, xc.shape[0])
            for i, ((rc, xc), (rp, xp)) in enumerate(zip(card, cpu))
            for tok in hold_flips(tag, i, routing_differences(rc, xc, rp, xp, cfg.top_k))]


def flip_in_row(flips, row, b, cfg):
    """The first flip (``routing_flips``) that can move sequence ``row``,
    with why: at a decode step (``b`` tokens, dropless) only the row's own
    token; at a prefill of T tokens, the row's own T/b tokens, or any token
    where capacity drops (T·k > 256) couple the rows. None if no flip can."""
    for call, tok, t in flips:
        if t == b and tok == row:
            return call, tok, "decode_step_own_token"
        if t != b and tok // (t // b) == row:
            return call, tok, "prefill_own_token"
        if t != b and t * cfg.top_k > 256:
            return call, tok, "prefill_rows_coupled_by_capacity_drops"
    return None


def hold_routing(tag, calls, k):
    """Each recorded MoE layer input, captured on the card, through its
    router on the card and on the CPU: equal expert sets or near-ties
    (``hold_flips``). Returns (token-layers held, near-ties)."""
    ties = sum(len(hold_flips(tag, i, routing_differences(router, x2d, router.cpu(), x2d.cpu(), k)))
               for i, (router, x2d) in enumerate(calls))
    return sum(x.shape[0] for _, x in calls), ties


def prefill_drops(params, cfg, prompts, dev):
    """Assignments kept and dropped by the capacity at the prefill of
    ``prompts``, summed over the MoE layers, and the capacity."""
    toks = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    _, calls = capture_moe(lambda: lm.prefill(params, toks, cfg))
    kept = dropped = 0
    for router, x2d in calls:
        _, _, eids = moe.route(router, x2d, cfg.top_k)
        cap = moe.capacity(x2d.shape[0], cfg)
        n = int((moe.arrival(eids.reshape(-1), cfg.n_experts) < cap).sum())
        kept, dropped = kept + n, dropped + eids.numel() - n
    return kept, dropped, cap


def mla_layers(cfg) -> int:
    return sum(kind in lm.MLA_KINDS for kind in lm.prologue_layout(cfg) + lm.group_layout(cfg)
               * cfg.n_groups)


def serve_moe(tag, cfg, dev, gpu, profile_run=None):
    """``cfg`` in bfloat16 (``cfg.dtype``) from a seeded generator through
    ``Engine.generate`` at the serving shape: no hand kernel, two generates
    equal, the parameter count against ``cfg.param_count()`` (which leaves
    out ``final_norm`` and each MLA layer's ``kv_norm``). Returns the
    parameters and the numbers the phase prints."""
    params, init_s = timed(lambda: lm.init_params(cfg, seed=0, device=dev))
    n = tree_numel(params)
    unc = cfg.d_model + mla_layers(cfg) * cfg.kv_lora_rank
    check(n - cfg.param_count() == unc,
          f"{tag}: {n} parameters, param_count {cfg.param_count()}, want a difference of {unc}")
    prompts = serve_prompts(cfg)
    out, wall, peak_gb, _ = generate_on(params, cfg, prompts, dev, gpu, {}, f"{tag} bfloat16",
                                        profile_run)
    prefill_s, steps = step_times(params, cfg, prompts, dev)
    kept, dropped, cap = prefill_drops(params, cfg, prompts, dev)
    check(kept + dropped == SERVE_B * bucket_dim(SERVE_PROMPT) * cfg.top_k
          * sum(kind in lm.MOE_KINDS for kind in lm.group_layout(cfg)) * cfg.n_groups,
          f"{tag}: {kept} + {dropped} assignments at the prefill")
    numbers = dict(
        arch=cfg.name, d_model=cfg.d_model, experts=f"{cfg.n_experts}top{cfg.top_k}"
        f"+{cfg.n_shared_experts}shared", d_ff_expert=cfg.d_ff_expert, vocab=cfg.vocab,
        params_b=f"{n / 1e9:.3f}", param_count_b=f"{cfg.param_count() / 1e9:.3f}",
        params_minus_param_count=n - cfg.param_count(), dtype=cfg.dtype, init_s=f"{init_s:.3f}",
        batch=SERVE_B, prompt_len=SERVE_PROMPT, new_tokens=SERVE_NEW, kernel_launches=0,
        generate_s=f"{wall:.4f}", tok_per_s=f"{SERVE_B * SERVE_NEW / wall:.1f}",
        prefill_s=f"{prefill_s:.4f}", decode_step_s=f"{np.mean(steps):.5f}",
        decode_step_s_min=f"{min(steps):.5f}", peak_gb=f"{peak_gb:.3f}",
        prefill_capacity=cap, prefill_assignments_kept=kept, prefill_assignments_dropped=dropped,
        sample=",".join(map(str, out[0][:8])), gpu=f"'{gpu}'")
    return params, prompts, numbers


def phase_deepseek_serve(dev, gpu, profile=False):
    """deepseek-v2-lite-16b at full width and depth (1 dense MLA prologue
    layer + 26 MLA+MoE layers, 64 experts top-6 + 2 shared, kv_lora 512,
    vocab 102400), bfloat16 weights (15.71B) through ``Engine.generate``;
    then ``[deepseek_cut]``: the prologue and the first 2 MoE groups of the
    same weights, upcast to float32, against a CPU run, the routing of the
    cut's prefill held first."""
    cfg = configs.get("deepseek-v2-lite-16b")
    params, prompts, numbers = serve_moe("deepseek", cfg, dev, gpu,
                                         "deepseek_generate" if profile else None)
    say("deepseek_serve", layers=f"{len(lm.prologue_layout(cfg))} mla + {cfg.n_groups} mla_moe",
        heads=f"{cfg.n_heads}x(nope {cfg.nope_head_dim}+rope {cfg.rope_head_dim}, v {cfg.head_dim})",
        kv_lora_rank=cfg.kv_lora_rank, **numbers)
    if profile:
        profile_decode_step("deepseek_decode_step", params, cfg, prompts, dev, gpu)

    cut_cfg = cfg.with_overrides(n_layers=1 + DEEPSEEK_CUT_GROUPS)
    cut = tree_map({k: v for k, v in params.items() if k != "groups"}
                   | {"groups": params["groups"][:DEEPSEEK_CUT_GROUPS]}, lambda t: t.float())
    del params
    free()
    avail, total = host_ram_gb()
    cut_gb = tree_numel(cut) * 4 / 1e9
    check(avail >= HOST_RAM_FACTOR * cut_gb,
          f"deepseek_cut: {avail:.1f} GB of host RAM available, {HOST_RAM_FACTOR} x {cut_gb:.1f} wanted")
    toks = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    _, calls = capture_moe(lambda: lm.prefill(cut, toks, cut_cfg))
    held, ties = hold_routing("deepseek_cut", calls, cfg.top_k)
    same_rows, logit_diff, cpu_s = hold_tokens_against_cpu("deepseek_cut", cut_cfg, cut, prompts, dev)
    say("deepseek_cut", layers=f"1 mla + {DEEPSEEK_CUT_GROUPS} mla_moe", dtype="float32",
        params_b=f"{tree_numel(cut) / 1e9:.3f}", host_ram_available_gb=f"{avail:.1f}",
        host_ram_total_gb=f"{total:.1f}", routing_tokens_held=held, routing_near_ties=ties,
        route_tol=ROUTE_TOL, rows_equal_to_cpu=f"{same_rows}/{SERVE_B}",
        prefill_logits_max_abs_diff=f"{logit_diff:.3e}", cpu_generate_s=f"{cpu_s:.3f}",
        gpu=f"'{gpu}'")


def profile_decode_step(run, params, cfg, prompts, dev, gpu):
    """The device kernels of one decode step after the prompt's prefill,
    and the device's busy share of its wall time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    b, s = prompts.shape
    toks = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    logits, caches = lm.prefill(params, toks, cfg, max_seq=s + 1)
    tok, at = torch.argmax(logits, dim=-1), torch.full((b,), s, device=dev)
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = timed(lambda: lm.decode_step(params, tok, caches, at, cfg))
    rows = device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    say("profile", run=run, wall_s=f"{wall:.4f}", device_busy_s=f"{busy_us / 1e6:.4f}",
        device_busy_share=f"{busy_us / 1e6 / wall:.3f}",
        device_kernels=sum(r[2] for r in rows), gpu=f"'{gpu}'")
    say_rows(run, rows, busy_us)


def phase_llama4_serve(dev, gpu):
    """llama4-scout-17b-a16e at full width (d_model 5120, 40/8 heads, 16
    experts top-1 + 1 shared of 8192, vocab 202048) cut to its first 8 of
    48 layers (19.69B bfloat16 weights), through ``Engine.generate``; then
    its first MoE layer's ``moe_ffn`` on the card against the CPU on the
    hidden states of the first decode step, if the host's RAM allows."""
    cfg = configs.get("llama4-scout-17b-a16e").with_overrides(n_layers=LLAMA4_LAYERS)
    params, prompts, numbers = serve_moe("llama4", cfg, dev, gpu)
    say("llama4_serve", layers=f"{cfg.n_layers} attn_moe",
        heads=f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim}",
        reduced=f"n_layers {configs.get(cfg.name).n_layers}->{cfg.n_layers}", **numbers)

    b, s = prompts.shape
    toks = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    logits, caches = lm.prefill(params, toks, cfg, max_seq=s + 1)
    _, calls = capture_moe(lambda: lm.decode_step(
        params, torch.argmax(logits, dim=-1), caches, torch.full((b,), s, device=dev), cfg))
    check(len(calls) == cfg.n_layers, f"llama4: {len(calls)} MoE calls in one decode step")
    lp = params["groups"][0]["pos0"]["moe"]
    x = calls[0][1][:, None, :]  # (B, 1, D), the layer's input at the step
    avail, total = host_ram_gb()
    moe_gb = tree_numel(lp) * 2 / 1e9
    if avail < HOST_RAM_FACTOR * moe_gb:
        say("llama4_moe_hold", run="skipped", host_ram_available_gb=f"{avail:.1f}",
            wanted_gb=f"{HOST_RAM_FACTOR * moe_gb:.1f}")
        return
    out, aux = moe.moe_ffn(lp, x, cfg)
    cpu_lp = tree_map(lp, lambda t: t.cpu())
    (cpu_out, cpu_aux), cpu_s = timed(lambda: moe.moe_ffn(cpu_lp, x.cpu(), cfg))
    flips = hold_flips("llama4_layer0", 0, routing_differences(
        lp["router"], x[:, 0], cpu_lp["router"], x[:, 0].cpu(), cfg.top_k))
    keep = [t for t in range(b) if t not in flips]
    got, want = out[keep, 0].float().cpu().double(), cpu_out[keep, 0].float().double()
    scale = want.abs().max().item()
    atol = MOE_BF16_ULPS * 2.0 ** (math.floor(math.log2(scale)) - 7)
    diff = (got - want).abs().max().item()
    check(diff <= atol, f"llama4: layer 0 moe_ffn on the card {diff:.3e} from the CPU's, "
          f"beyond {atol:.3e}")
    say("llama4_moe_hold", run="decode_step_hidden_states", tokens=b, layer=0,
        host_ram_available_gb=f"{avail:.1f}", host_ram_total_gb=f"{total:.1f}",
        tokens_held=len(keep), routing_near_ties=len(flips), max_abs_diff=f"{diff:.4e}",
        allowed=f"{atol:.4e}", out_scale=f"{scale:.4f}",
        aux=f"{aux.item():.6f}", cpu_aux=f"{cpu_aux.item():.6f}", cpu_s=f"{cpu_s:.3f}",
        gpu=f"'{gpu}'")


# ---------------------------------------------------------------------------
# the baselines (core/ica_lingam.py, core/poly_scores.py)
# ---------------------------------------------------------------------------

EASY_P5 = sem.SemSpec(p=5, n=20000, density="sparse", seed=3)  # tests/test_ica_lingam.py


def phase_ica_lingam(dev, gpu):
    """ICA-LiNGAM at the E. coli core size and on the easy p=5 SEM of
    ``tests/test_ica_lingam.py``: the card against the CPU from the same
    random start ``w0`` (W, orders, iterations, seconds), with ``fit``'s
    time beside it. At p=5 both converge and the orders are held equal. At
    E. coli core FastICA reaches max_iter without converging: the whitened
    data is ill-conditioned and two CPU runs with other thread counts
    already part, so there W and the order are printed, not held."""
    for name, spec in (("ecoli_core", sem.SemSpec(p=ECOLI[0], n=ECOLI[1], density="sparse", seed=0)),
                       ("easy_p5", EASY_P5)):
        x = sem.generate(spec)["x"]
        w0 = np.random.default_rng(0).standard_normal((spec.p, spec.p)).astype(np.float32)
        ica._fast_ica(x, w0=w0, device=dev)  # warm-up: solver handles
        (w_k, it_k), card_s = timed(lambda: ica._fast_ica(x, w0=w0, device=dev))
        t0 = time.perf_counter()
        w_c, it_c = ica._fast_ica(x, w0=w0, device="cpu")
        cpu_s = time.perf_counter() - t0
        check(bool(torch.all(torch.isfinite(w_k))), f"{name}: non-finite unmixing matrix")
        order_k, b_k = ica.ica_lingam(x, w0=w0, device=dev)
        order_c, _ = ica.ica_lingam(x, w0=w0, device="cpu")
        w_diff, w_ok = within(w_k.cpu(), w_c, ATTN_ATOL, ATTN_RTOL)
        if name == "easy_p5":
            check(it_k < 500 and it_c < 500, f"{name}: FastICA did not converge")
            check(w_ok and order_k == order_c, f"{name}: the card's W or order differs from the CPU's")
        fit(x, device=dev)  # warm-up
        _, fit_s = timed(lambda: fit(x, device=dev))
        say("ica_lingam", case=name, p=spec.p, n=spec.n, iterations=it_k, iterations_cpu=it_c,
            converged=it_k < 500, fast_ica_s=f"{card_s:.4f}", fast_ica_cpu_s=f"{cpu_s:.4f}",
            w_max_abs_diff_vs_cpu=f"{w_diff:.3e}", w_scale=f"{w_c.abs().max().item():.3e}",
            w_within_tol=w_ok, orders_equal=order_k == order_c,
            b_finite=bool(np.isfinite(b_k).all()), fit_s=f"{fit_s:.4f}", gpu=f"'{gpu}'")


def phase_poly_scores(dev, gpu):
    """The polynomial scorer on the first find-root's inputs at the E. coli
    core size and the iJR904 slice: times of ``cross_power_moments``,
    ``poly_scores`` and ``hybrid_find_root`` beside ``find_root_dense`` under
    ``hopper_fused``; the hybrid root equals the dense root."""
    for name, spec in (("ecoli_core", sem.SemSpec(p=ECOLI[0], n=ECOLI[1], density="sparse", seed=0)),
                       ("ijr904_slice", sem.SemSpec(p=SLICE[0], n=SLICE[1], seed=1))):
        xn, c = normalized(sem.generate(spec)["x"], dev)
        mask = torch.ones((spec.p,), dtype=torch.bool, device=dev)
        root, s_dense = paralingam.find_root_dense(xn, c, mask, score_backend="hopper_fused")
        h_root, h_score = poly.hybrid_find_root(xn, c, mask)
        check(int(h_root) == int(root), f"{name}: hybrid root {int(h_root)} != dense root {int(root)}")
        check(bool(torch.isfinite(h_score)), f"{name}: non-finite hybrid score")
        s_approx, _ = poly.poly_scores(xn, c, mask)
        rank = int((torch.argsort(s_approx) == root).nonzero()[0])
        cpm_ms = time_ms(lambda: poly.cross_power_moments(xn), reps=5)
        poly_ms = time_ms(lambda: poly.poly_scores(xn, c, mask), reps=5)
        hybrid_ms = time_ms(lambda: poly.hybrid_find_root(xn, c, mask), reps=5)
        dense_ms = time_ms(lambda: paralingam.find_root_dense(xn, c, mask,
                                                              score_backend="hopper_fused"), reps=5)
        say("poly_scores", case=name, p=spec.p, n=spec.n, dense_root=int(root),
            hybrid_root=int(h_root), dense_root_rank_in_approx=rank,
            cross_power_moments_ms=f"{cpm_ms:.4f}", poly_scores_ms=f"{poly_ms:.4f}",
            hybrid_find_root_ms=f"{hybrid_ms:.4f}", find_root_dense_hopper_fused_ms=f"{dense_ms:.4f}",
            gpu=f"'{gpu}'")


# ---------------------------------------------------------------------------
# the messaging ring (dist/ring.py, dist/ring_order.py)
# ---------------------------------------------------------------------------


def ring_runs(x, dev, cfg_kw, mesh, warm: bool = True):
    """One timed ``causal_order_ring`` of ``x``, after a warm-up unless
    ``warm`` is False: (result, seconds, square-kernel launches of the timed
    run)."""
    cfg = ParaLiNGAMConfig(order_backend="ring", **cfg_kw)
    if warm:
        causal_order_ring(x, cfg, mesh=mesh, device=dev)
    reset_counts()
    res, t = timed(lambda: causal_order_ring(x, cfg, mesh=mesh, device=dev))
    return res, t, counts()["pairwise_moments"]


def phase_ring_ecoli(dev, gpu, profile: bool):
    """The messaging ring on one card: one shard (R=1) under an NCCL process
    group of one rank (``file://`` init), through ``causal_order_ring``, at
    the E. coli core size, dense and with the threshold, under
    ``hopper_fused`` (both ``hopper`` names run the square kernel in the
    ring): the orders of the scan with the same kernel (``hopper``), the runs
    without a process group (one before the group exists, one after it is
    gone: the wall times alternate none, NCCL, NCCL, none) bit-equal (orders
    and every counter), 84 square launches per dense order, ``wire`` all
    zero, ``fit(order_backend="ring")`` with the scan fit's B and noise
    variances; ``ring_find_root`` on the degenerate one-shard ring runs the
    square kernel once and gives the dense root; wall times beside the
    scan's, here and at the iJR904 slice (where the orders mean nothing; its
    threshold runs only with ``--profile``). Returns (the dense ring's
    square launches, the degenerate find-root's)."""
    import torch.distributed as dist

    from repro_torch.core.pairwise import dense_scores
    from repro_torch.core.paralingam import causal_order_scan
    from repro_torch.dist.ring import ring_find_root
    from repro_torch.launch.mesh import make_ring_mesh

    p, n = ECOLI
    data = sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=0))
    x = data["x"]
    dense_kw = dict(score_backend="hopper_fused")
    thr_kw = dict(score_backend="hopper_fused", threshold=True, chunk=16)
    scan_cfg = ParaLiNGAMConfig(score_backend="hopper")
    thr_scan_cfg = ParaLiNGAMConfig(score_backend="hopper", threshold=True, chunk=16)
    causal_order_scan(x, scan_cfg, device=dev)  # warm-up
    scan, t_scan = timed(lambda: causal_order_scan(x, scan_cfg, device=dev))
    thr_scan, t_thr_scan = timed(lambda: causal_order_scan(x, thr_scan_cfg, device=dev))
    alone = {k: ring_runs(x, dev, kw, None) for k, kw in (("dense", dense_kw), ("threshold", thr_kw))}

    init = _build.BUILD_DIR / f"ring_init_{os.getpid()}"  # git-ignored
    init.parent.mkdir(parents=True, exist_ok=True)
    init.unlink(missing_ok=True)
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0, world_size=1)
    try:
        mesh = make_ring_mesh(1, 1, 1)
        runs = {k: ring_runs(x, dev, kw, mesh) for k, kw in (("dense", dense_kw), ("threshold", thr_kw))}
        again = {k: ring_runs(x, dev, kw, mesh, warm=False)[1]
                 for k, kw in (("dense", dense_kw), ("threshold", thr_kw))}
        xn, c = normalized(x, dev)
        mask = torch.ones(p, dtype=torch.bool, device=dev)
        reset_counts()
        root, s_ring = ring_find_root(xn, c, mask, mesh, score_backend="hopper_fused")
        fr_launches = counts()["pairwise_moments"]
        (res_f, b_f), t_fit = timed(lambda: fit(
            x, ParaLiNGAMConfig(order_backend="ring", **dense_kw), device=dev))
        slice_x = sem.generate(sem.SemSpec(p=SLICE[0], n=SLICE[1], density="sparse", seed=1))["x"]
        slice_runs = {"dense": ring_runs(slice_x, dev, dense_kw, mesh)[:2]}
        causal_order_scan(slice_x, scan_cfg, device=dev)  # warm-up
        slice_scans = {"dense": timed(lambda: causal_order_scan(slice_x, scan_cfg, device=dev))}
        if profile:  # 50-70 s on the card, and nothing held
            # no warm-up: the dense runs built and loaded everything it uses
            slice_runs["threshold"] = ring_runs(slice_x, dev, thr_kw, mesh, warm=False)[:2]
            slice_scans["threshold"] = timed(
                lambda: causal_order_scan(slice_x, thr_scan_cfg, device=dev))
    finally:
        dist.destroy_process_group()
        init.unlink(missing_ok=True)
    after = {k: ring_runs(x, dev, kw, None, warm=False)
             for k, kw in (("dense", dense_kw), ("threshold", thr_kw))}
    (res_s, b_s), _ = timed(lambda: fit(x, scan_cfg, device=dev))

    zero_wire = {"pods": 1, "ring": 1, "hops_intra": 0, "hops_cross": 0, "hops_overlapped": 0,
                 "seq_hops": 0, "seq_cross_hops": 0, "overlap_frac": 0.0}
    for kind, scan_res, t_ref in (("dense", scan, t_scan), ("threshold", thr_scan, t_thr_scan)):
        res, t, launches = runs[kind]
        res0, t0, launches0 = alone[kind]
        res1, t1, _ = after[kind]
        same = hold_order(f"ring_{kind}_vs_scan_hopper", res.order, scan.order, x, dev)
        same_thr = hold_order(f"ring_{kind}_vs_scan_{kind}", res.order, scan_res.order, x, dev)
        bit_equal = res == res0 == res1
        say("ring_ecoli", run=kind, p=p, n=n, topology="1x1x1", backend="nccl",
            order_equals_scan_hopper=same, order_equals_scan_same_evaluation=same_thr,
            equal_without_process_group=bit_equal, square_launches=launches,
            square_launches_without_process_group=launches0, comparisons=res.comparisons,
            rounds=res.rounds, converged=res.converged, wire_zero=res.wire == zero_wire,
            ring_s_none_nccl_nccl_none=f"{t0:.4f},{t:.4f},{again[kind]:.4f},{t1:.4f}",
            scan_s=f"{t_ref:.4f}", gpu=f"'{gpu}'")
        check(bit_equal, f"ring {kind}: the run without a process group differs")
        check(res.wire == zero_wire, f"ring {kind}: wire counters {res.wire} at one shard")
        check(res.converged, f"ring {kind} did not converge")
        if kind == "dense":
            check(launches == launches0 == p - 1,
                  f"{launches} square launches for {p - 1} dense find-roots")
    s_dense = dense_scores(xn, c, mask)[0]
    fr_err = (s_ring - s_dense).abs()
    fr_ok = bool(torch.all(fr_err <= fs.score_tolerance(s_dense, xn, c, mask)))
    say("ring_find_root", p=p, n=n, topology="1x1x1", backend="nccl", degenerate=True,
        square_launches=fr_launches, root=int(root), dense_root=int(torch.argmin(s_dense)),
        max_abs_err=f"{fr_err.max().item():.3e}", within_tolerance=fr_ok, gpu=f"'{gpu}'")
    check(fr_launches == 1, f"the degenerate ring_find_root made {fr_launches} square launches")
    check(int(root) == int(torch.argmin(s_dense)) and fr_ok,
          "the degenerate ring_find_root disagrees with the plain dense evaluation")
    same = res_f.order == res_s.order
    b_err = (b_f - b_s).abs().max().item()
    nv_err = float(np.max(np.abs(res_f.noise_var - res_s.noise_var)))
    say("ring_fit", p=p, n=n, order_equals_scan_fit=same, b_max_abs_diff=b_err,
        noise_var_max_abs_diff=nv_err, fit_s=f"{t_fit:.4f}", gpu=f"'{gpu}'")
    check(same and b_err == 0.0 and nv_err == 0.0,
          "fit(order_backend='ring') differs from the scan fit")
    if "threshold" not in slice_runs:
        say("ring_slice", run="threshold", skipped=True, reason="runs with --profile")
    for kind in slice_runs:
        (res, t), (ref, t_ref) = slice_runs[kind], slice_scans[kind]
        say("ring_slice", run=kind, p=SLICE[0], n=SLICE[1], ring_s=f"{t:.4f}",
            scan_s=f"{t_ref:.4f}", comparisons=res.comparisons, rounds=res.rounds,
            converged=res.converged, order_equals_scan=res.order == ref.order, held=False,
            gpu=f"'{gpu}'")
    return runs["dense"][2], fr_launches


#: Ring topologies whose row blocks ``[ring_block_kernel]`` holds: (pods, ring).
RING_TOPOLOGIES = ((1, 2), (1, 4), (1, 8), (2, 2))


def ring_block_pairs(m: int, pods: int, ring: int):
    """(own, visiting) row slices of block 0 against each block it visits
    in ``make_hier_plan(pods, ring)``."""
    from repro_torch.utils.schedule import make_hier_plan

    m_l = m // (pods * ring)
    plan = make_hier_plan(pods, ring)
    return [(slice(0, m_l), slice(src * m_l, (src + 1) * m_l))
            for src in (plan.src(e, t, 0, 0) for e, t, _ in plan.processed_offsets())]


def phase_ring_block_kernel(dev, gpu, ecoli_x):
    """The square kernel against its plain version on the blocks the ring
    passes it at R = 2, 4, 8 and (P, R) = (2, 2): own rows against each
    visiting block (each side with its own live mask) and the reverse
    direction with the transposed correlation block, at the E. coli fit's
    first stage (m=128, n=10000, the fit's mask) and at the p=512 stage
    shape (m=512, n=2000, Gaussian rows: the SEM's near-collinear pairs
    amplify rounding past any sum tolerance); and the same on the two
    sample shards of n/2, whose sums add up to the full-n sums within the
    tolerance. Live sums within ``sum_tolerance``, dead pairs exactly 0.
    Returns the max abs error."""
    stages = capture_dense_inputs(ecoli_x, "hopper", dev)
    xe, ce, me = stages[max(stages)]
    xg, cg = normalized(gauss_data(*SLICE, 1), dev)
    mg = torch.ones(SLICE[0], dtype=torch.bool, device=dev)
    worst = 0.0
    for stage, (x_, c_, m_) in ((f"ecoli_m{xe.shape[0]}", (xe, ce, me)),
                                (f"gauss_m{SLICE[0]}", (xg, cg, mg))):
        n = x_.shape[1]
        halves = (slice(0, n // 2), slice(n // 2, n))
        for pods, ring in RING_TOPOLOGIES:
            ratio, sum_ratio, errs, zero, calls = 0.0, 0.0, [], True, 0
            for own, vis in ring_block_pairs(x_.shape[0], pods, ring):
                for a, b, c_blk in ((own, vis, c_[own, vis]), (vis, own, c_[own, vis].T)):
                    xi, xj, cb = x_[a].contiguous(), x_[b].contiguous(), c_blk.contiguous()
                    li, lj = m_[a].contiguous(), m_[b].contiguous()
                    sel = li[:, None] & lj[None, :]
                    full = None
                    parts = []
                    for cols in (slice(0, n),) + halves:
                        xs_i, xs_j = xi[:, cols].contiguous(), xj[:, cols].contiguous()
                        k = ps.pairwise_moments(xs_i, xs_j, cb, live_i=li, live_j=lj)
                        r = ps.pairwise_moments_ref(xs_i, xs_j, cb, live_i=li, live_j=lj)
                        calls += 1
                        tol = ps.sum_tolerance(xs_i, xs_j, cb)[sel].double()
                        for kk, rr in zip(k, r):
                            zero = zero and bool(torch.all(kk[~sel] == 0))
                            if bool(sel.any()):
                                e = (kk[sel].double() - rr[sel].double()).abs()
                                errs.append(e.max().item())
                                ratio = max(ratio, (e / tol).max().item())
                        if full is None:
                            full, full_tol = k, tol
                        else:
                            parts.append(k)
                    if bool(sel.any()):
                        for q in range(2):
                            e = (parts[0][q][sel].double() + parts[1][q][sel].double()
                                 - full[q][sel].double()).abs()
                            sum_ratio = max(sum_ratio, (e / full_tol).max().item())
            torch.cuda.synchronize()
            ok = ratio <= 1.0 and sum_ratio <= 1.0 and zero
            worst = max([worst] + errs)
            say("ring_block_kernel", stage=stage, topology=f"{pods}x{ring}",
                block_rows=x_.shape[0] // (pods * ring), launches=calls,
                max_abs=f"{max(errs):.3e}", max_err_over_tol=f"{ratio:.3e}",
                half_n_shards_sum_over_tol=f"{sum_ratio:.3e}", dead_pairs_zero=zero, ok=ok,
                gpu=f"'{gpu}'")
            check(ok, f"the square kernel disagrees on the ring's {stage} {pods}x{ring} blocks")
    return worst



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gpu = gpu_line()
    print(gpu, flush=True)
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=f"'{torch.cuda.get_device_name(0)}'", count=torch.cuda.device_count())
    t0 = time.perf_counter()
    logs = _build.build_all()
    say("build", kernels=",".join(logs), seconds=f"{time.perf_counter() - t0:.2f}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)

    phase_sass()
    phase_math_probe(dev)
    phase_rank1_scale_probe(dev)
    phase_rank1_sum_order(dev)
    profile = "--profile" in sys.argv[1:]
    if profile:
        profile_find_root(dev, gpu)
    err_kernel = phase_kernel(dev)
    phase_fit_small(dev)
    err_core, core = phase_fit_core(dev, gpu)
    rate = copy_rate(dev)
    say("copy_rate", bytes_per_s=f"{rate:.4e}", published_bytes_per_s=f"{HBM_BPS:.4e}",
        gpu=f"'{gpu}'")
    err_data, err_cov, cov_timing = phase_covupdate_kernel(dev, gpu, rate)
    cov_launched, path_ex, path_ec = phase_covupdate_path(
        dev, gpu, core["x"], core["hopper_fused"][0].order)
    err_rank1, rank1_timing = phase_rank1_update(dev, gpu, core)
    err_ssd, ssd_timing = phase_ssd_kernel(dev, gpu, rate)
    ssd_launches, err_serve, _ = phase_mamba2_serve(dev, gpu, profile)
    free()
    granite, granite_cfg = phase_granite_serve(dev, gpu, profile)
    phase_granite_prefill_long(dev, gpu, granite, granite_cfg)
    del granite
    free()
    phase_gemma3_window(dev, gpu)
    free()
    ssd_launches_zamba2, err_zamba2, zamba2_timing = phase_zamba2_serve(dev, gpu, rate, profile)
    free()
    phase_deepseek_serve(dev, gpu, profile)
    free()
    phase_llama4_serve(dev, gpu)
    free()
    err_sq, sq = phase_pairwise_kernel(dev, gpu, core["x"])
    launches_sq = phase_fit_hopper(dev, gpu, core)
    phase_causal_order_host(dev, gpu, core)
    launches, err_fit, ms, plain_ms, bound, wrapper_ms = phase_fit_slice(dev, gpu)
    err_b, ms_b, wrapper_b, plain_b, bound_b, padded_b, shape_b = phase_batch_kernel(dev, gpu)
    batch_orders = phase_fit_batch(dev, gpu)
    launches_sqb = phase_fit_batch_hopper(dev, gpu, batch_orders)
    launches_b, launches_upd = phase_engine(dev, gpu, batch_orders, profile)
    phase_threshold_ecoli(dev, gpu)
    phase_threshold_batch(dev, gpu)
    if time.perf_counter() - t_start < 500:  # well inside the 1200 s limit
        phase_threshold_slice(dev, gpu)
    else:
        say("threshold_slice", skipped=True, elapsed_s=f"{time.perf_counter() - t_start:.1f}")
    err_ring = phase_ring_block_kernel(dev, gpu, core["x"])
    launches_ring, launches_ring_find_root = phase_ring_ecoli(dev, gpu, profile)
    phase_ica_lingam(dev, gpu)
    phase_poly_scores(dev, gpu)
    if profile:
        profile_fits(dev, gpu)
    sq_ms, sq_wrapper, sq_plain, sq_bound, sq_by = sq["ecoli_stage"]
    sqb_ms, sqb_wrapper, sqb_plain, sqb_bound, sqb_by, sqb_padded, sqb_shape = sq["batch"]
    print(json.dumps({"kernels": [{
        "name": "fused_score", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max(err_kernel, err_core, err_fit), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": "operations", "library_ms": None,
        "wrapper_ms": wrapper_ms, "shape": "p=512,n=2000,block=8",
        "gpu": gpu,
    }, {
        "name": "fused_score_batch", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": BATCH_REPLACES, "launches": launches_b, "max_abs_err": err_b,
        "ms": ms_b, "plain_ms": plain_b, "bound_ms": bound_b, "bound_by": "operations",
        "library_ms": None, "wrapper_ms": wrapper_b, "bound_ms_padded_buffer": padded_b,
        "shape": shape_b, "gpu": gpu,
    }, {
        "name": "pairwise_moments", "route": "cuda", "source": SQUARE_SOURCE,
        "replaces": SQUARE_REPLACES, "launches": launches_sq,
        "launches_ring": launches_ring, "launches_ring_find_root": launches_ring_find_root,
        "max_abs_err": max(err_sq, err_ring),
        "ms": sq_ms, "plain_ms": sq_plain, "bound_ms": sq_bound, "bound_by": sq_by,
        "library_ms": None, "wrapper_ms": sq_wrapper,
        "shape": "m=128,n=10000,the E. coli fit's first-stage mask",
        "ms_m512_n2000": sq["slice"][0], "plain_ms_m512_n2000": sq["slice"][2],
        "bound_ms_m512_n2000": sq["slice"][3], "gpu": gpu,
    }, {
        "name": "pairwise_moments_batch", "route": "cuda", "source": SQUARE_SOURCE,
        "replaces": SQUARE_REPLACES, "launches": launches_sqb, "max_abs_err": err_sq,
        "ms": sqb_ms, "plain_ms": sqb_plain, "bound_ms": sqb_bound, "bound_by": sqb_by,
        "library_ms": None, "wrapper_ms": sqb_wrapper, "bound_ms_padded_buffer": sqb_padded,
        "shape": sqb_shape, "gpu": gpu,
    }] + [{
        "name": name, "route": "cuda", "source": COV_SOURCE, "replaces": replaces,
        "launches": cov_launched[name], "max_abs_err": err, "ms": cov_timing[name][0],
        "plain_ms": cov_timing[name][1], "bound_ms": cov_timing[name][2], "bound_by": "bytes",
        "library_ms": None, "device_ms": cov_timing[name][4],
        "empty_kernel_device_ms": cov_timing[name][5], "shape": cov_timing[name][3],
        "gpu": gpu,
    } for name, replaces, err in (("update_data", DATA_REPLACES, max(err_data, path_ex)),
                                  ("update_cov", COV_REPLACES, max(err_cov, path_ec)))] + [{
        "name": "rank1_update", "route": "cuda", "source": COV_SOURCE,
        "replaces": RANK1_REPLACES, "launches": launches_upd, "max_abs_err": err_rank1,
        "ms": rank1_timing[0], "plain_ms": rank1_timing[1], "bound_ms": rank1_timing[2],
        "bound_by": "bytes", "library_ms": None, "device_ms": rank1_timing[3],
        "empty_kernel_device_ms": rank1_timing[4], "shape": rank1_timing[5], "gpu": gpu,
    }] + [{
        "name": "ssd_decode", "route": "cuda", "source": SSD_SOURCE, "replaces": SSD_REPLACES,
        "launches": ssd_launches, "launches_zamba2": ssd_launches_zamba2,
        "max_abs_err": max(err_ssd, err_serve, err_zamba2), "ms": ssd_timing[0],
        "plain_ms": ssd_timing[1], "bound_ms": ssd_timing[2], "bound_by": "bytes",
        "library_ms": None, "device_ms": ssd_timing[4], "wrapper_ms": ssd_timing[5],
        "shape": ssd_timing[3], "max_abs_err_zamba2": err_zamba2, "ms_zamba2": zamba2_timing[0],
        "plain_ms_zamba2": zamba2_timing[1], "bound_ms_zamba2": zamba2_timing[2],
        "device_ms_zamba2": zamba2_timing[4], "shape_zamba2": zamba2_timing[3], "gpu": gpu,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
