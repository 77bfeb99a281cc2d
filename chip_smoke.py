#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--profile]

Phases, each printed on its own line:

1. The card's name and power limit (``nvidia-smi``), and the build of every
   hand-written kernel from the sources in ``src/repro_torch/kernels/csrc``.
2. Kernel against plain, on the card: the fused triangular score kernel
   against its plain torch version at odd p, ragged n, ``n_valid`` padding,
   dead rows holding NaN, and the full widths p=85/n=10000 and p=512/n=2000.
   A case most of whose scores lie within their tolerance of 0 is refused.
3. ``repro_torch.fit`` on a small SEM against the float64 serial oracle, and
   at the E. coli core size (p=85, n=10000) with the kernel and with the
   plain square path: equal orders, equal B and noise variances, and one
   kernel launch per find-root.
4. ``fit`` at the iJR904 slice size (p=512, n=2000): the score vector of the
   fit's first iteration against the plain version, the kernel against plain
   at every smaller stage size on Gaussian rows under the fit's mask (the
   fit's own inputs there score ~0), the fit's wall time, and the kernel's
   time per launch at m=512.
5. With ``--profile``: where one fit's time goes (torch.profiler device time
   by kernel, and the device's busy share), at both fit sizes.
6. A ``{"kernels": [...]}`` line with each hand kernel's launches on the main
   path, its error against the plain version, its time, the plain version's
   time and its bound.

Every failed check raises, and the script exits non-zero without printing a
result. It needs a CUDA device (it exits non-zero without one) and imports
neither JAX nor the JAX package. The last line of its output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import direct_lingam, sem  # noqa: E402
from repro_torch.core.covariance import cov_matrix, normalize  # noqa: E402
from repro_torch.core.paralingam import ParaLiNGAMConfig, fit  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import fused_score as fs  # noqa: E402

# Kernel against plain: the same root, and per live row the error bound of
# fused_score.score_tolerance — float32 rounding of each entropy carried
# through I and S = sum min(0, I)^2. Both sides take the same float32
# formulas and differ only in the order of the sample sums (per-thread chunk
# sums vs torch's tree reduction) and of the tile sums.
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3 bytes/s,
# FP32 FLOP/s outside the tensor cores, and special-function results/s
# (132 SMs x 16 per clock x 1.98 GHz: the transcendentals' pipe).
HBM_BPS, FP32_FLOPS, SFU_OPS = 3.35e12, 67e12, 132 * 16 * 1.98e9
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/fused_score.cu"
KERNEL_REPLACES = "src/repro/kernels/fused_score.py:70"


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
    check(bool(torch.all(torch.isinf(s_k[~mask]))), f"{name}: dead rows not +inf")
    k, r = s_k[mask].double(), s_r[mask].double()
    check(bool(torch.all(torch.isfinite(k))), f"{name}: non-finite live scores")
    err = (k - r).abs()
    tol = fs.score_tolerance(s_r, xn, c, mask, n_valid=kw.get("n_valid"))[mask].double()
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
    # n_valid padding: zero columns change nothing but the divide
    xn, c = normalized(np.random.default_rng(2).standard_normal((21, 700)), dev)
    xp = torch.zeros((21, 1024), device=dev)
    xp[:, :700] = xn
    mask = torch.ones(21, dtype=torch.bool, device=dev)
    nv = torch.tensor(700, device=dev)
    errs.append(compare("n_valid_pad", xp, c, mask, n_valid=nv))
    s_pad = fs.fused_score_vector(xp, c, mask, n_valid=nv).double()
    s_exact = fs.fused_score_vector(xn, c, mask).double()
    d = (s_pad - s_exact).abs()
    ok = bool(torch.all(d <= fs.score_tolerance(s_exact, xn, c, mask)))
    say("kernel_padding", padded_vs_unpadded_max_abs=f"{d.max().item():.3e}", ok=ok)
    check(ok, "n_valid padding changed the kernel's scores beyond rounding")
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
        res, _, seconds, _ = run_fit(x, "hopper_fused", dev)
    finally:
        ops.score_vector = orig
    return captured, res, seconds


def run_fit(x, backend, dev, **kw):
    fs.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, b = fit(x, ParaLiNGAMConfig(score_backend=backend, **kw), device=dev)
    torch.cuda.synchronize()
    return res, b, time.perf_counter() - t0, fs.LAUNCHES


def phase_fit_small(dev):
    data = sem.generate(sem.SemSpec(p=8, n=2500, density="sparse", seed=0))
    res, b, _, launches = run_fit(data["x"], "auto", dev, min_bucket=8)
    oracle = direct_lingam.causal_order(data["x"])
    say("fit_small", p=8, n=2500, order_equals_f64_oracle=res.order == oracle,
        launches=launches)
    check(res.order == oracle, "fit order differs from the float64 oracle at p=8")
    check(launches == 7, "fit did not run the kernel once per find-root")
    check(bool(torch.all(torch.isfinite(b))) and tuple(b.shape) == (8, 8),
          "B is not a finite (8, 8) matrix")


def phase_fit_core(dev, gpu) -> float:
    data = sem.generate(sem.SemSpec(p=85, n=10_000, density="sparse", seed=0))
    captured, warm, _ = fit_stage_inputs(data["x"], dev)
    res_k, b_k, t_k, launches = run_fit(data["x"], "hopper_fused", dev)
    res_p, b_p, t_p, _ = run_fit(data["x"], "torch", dev)
    same = res_k.order == res_p.order
    b_err = (b_k - b_p).abs().max().item()
    nv_err = float(np.max(np.abs(res_k.noise_var / res_p.noise_var - 1)))
    say("fit_ecoli_core", p=85, n=10000, orders_equal=same, b_max_abs_diff=b_err,
        noise_var_max_rel_diff=nv_err, launches=launches, find_roots=84,
        valid_order=sem.is_valid_causal_order(res_k.order, data["b_true"]),
        fit_s_hopper_fused=f"{t_k:.3f}", fit_s_torch=f"{t_p:.3f}", gpu=f"'{gpu}'")
    check(same, "hopper_fused and torch orders differ at p=85")
    # Same order and same raw data: phase 2 sees identical inputs.
    check(b_err <= 1e-6 and nv_err <= 1e-6, "B or noise_var differ at p=85")
    check(launches == 84, f"{launches} kernel launches for 84 find-roots")
    check(res_k.order == warm.order, "two fits of the same data gave different orders")
    check(bool(torch.all(torch.isfinite(b_k))) and np.all(np.isfinite(res_k.noise_var)),
          "non-finite B or noise variances")
    return max(compare(f"fit85_stage_m{m}", *captured[m]) for m in sorted(captured, reverse=True))


def phase_fit_slice(dev, gpu):
    """Returns (launches, max_abs_err, kernel ms, plain ms, bound ms, extra)."""
    p, n = 512, 2000
    x = sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=1))["x"]
    captured, warm, t_warm = fit_stage_inputs(x, dev)  # the warm-up fit
    res, b, t_fit, launches = run_fit(x, "hopper_fused", dev)  # the main path
    say("fit_ijr904_slice", p=p, n=n, launches=launches, find_roots=p - 1,
        fit_s=f"{t_fit:.4f}", warmup_fit_s=f"{t_warm:.4f}",
        same_order_as_warmup=res.order == warm.order, gpu=f"'{gpu}'")
    check(launches == p - 1, f"{launches} kernel launches for {p - 1} find-roots")
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
    _, _, _, hxb, mb, s_diag = fs.fused_layout(xn, c, mask, 8)
    ms = time_ms(lambda: fs.launch(xn, c, hxb, mb, s_diag), reps=50)
    wrapper_ms = time_ms(lambda: fs.fused_score_vector(xn, c, mask), reps=20)
    plain_ms = time_ms(lambda: fs.fused_score_vector_ref(xn, c, mask), reps=3, warmup=1)
    nt = mb.shape[0]
    elems = nt * (nt - 1) * 64 * n  # the kernel's (ordered pair, sample) elements
    bytes_moved = 4 * (p * n + p * p + 3 * p) + p  # x, c, hx, s_diag, S once; mask
    t_bytes = bytes_moved / HBM_BPS * 1e3
    t_fp32 = 12 * elems / FP32_FLOPS * 1e3  # residual, |u|, u^2, scalings, 4 adds
    t_sfu = 3 * elems / SFU_OPS * 1e3  # exp, log1p, exp per element
    bound = max(t_bytes, t_fp32, t_sfu)
    say("kernel_time", p=p, n=n, block=8, kernel_ms=f"{ms:.4f}",
        wrapper_ms=f"{wrapper_ms:.4f}", plain_ms=f"{plain_ms:.3f}",
        bound_ms=f"{bound:.4f}", bytes_bound_ms=f"{t_bytes:.5f}",
        fp32_bound_ms=f"{t_fp32:.4f}", sfu_bound_ms=f"{t_sfu:.4f}",
        kernel_fraction_of_bound=f"{bound / ms:.3f}", gpu=f"'{gpu}'")
    return launches, max(errs), ms, plain_ms, bound, wrapper_ms


def profile_fits(dev, gpu):
    """``--profile``: where the time of one fit goes, from torch.profiler —
    device time by kernel, and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for p, n, seed in ((85, 10_000, 0), (512, 2000, 1)):
        x = sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=seed))["x"]
        run_fit(x, "hopper_fused", dev)  # warm-up
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, _, wall, _ = run_fit(x, "hopper_fused", dev)
        rows = [(e.self_device_time_total, e.key, e.count)
                for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        rows = sorted((r for r in rows if r[0] > 0), reverse=True)
        busy_us = sum(r[0] for r in rows)
        say("profile", p=p, n=n, wall_s=f"{wall:.4f}", device_busy_s=f"{busy_us / 1e6:.4f}",
            device_busy_share=f"{busy_us / 1e6 / wall:.3f}", gpu=f"'{gpu}'")
        for us, key, count in rows[:12]:
            say("profile_kernel", p=p, share=f"{us / busy_us:.3f}", device_ms=f"{us / 1e3:.3f}",
                calls=count, name=f"'{key[:90]}'")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
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

    err_kernel = phase_kernel(dev)
    phase_fit_small(dev)
    err_core = phase_fit_core(dev, gpu)
    launches, err_fit, ms, plain_ms, bound, wrapper_ms = phase_fit_slice(dev, gpu)
    if "--profile" in sys.argv[1:]:
        profile_fits(dev, gpu)
    print(json.dumps({"kernels": [{
        "name": "fused_score", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max(err_kernel, err_core, err_fit), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": "operations", "library_ms": None,
        "wrapper_ms": wrapper_ms, "shape": "p=512,n=2000,block=8",
        "gpu": gpu,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
