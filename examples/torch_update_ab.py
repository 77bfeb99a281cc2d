"""The rank-1 update kernel's fit and ring modes on one CUDA card, in two
source trees: the device ms per launch (torch.profiler) at the five cases
of PERF.md (the p=85 and p=512 fits' first updates, in place; the E. coli
dispatch's first update, B=8, m=128, n=16384 with valid counts, in place;
the ring's E. coli block 0 at (1, 2, 1), one fused launch, and at (1, 2,
2), sums and scale around the sums' reduction), then the wall seconds and
the profiled device-busy seconds of one dense p=85 ``fit`` and one E. coli
dispatch (``fit_batch``, B=8), with the update kernel's share of each.
Each run prints ``[update_ab]`` lines.

    python examples/torch_update_ab.py PARENT_TREE   # parent, change, change, parent
    python examples/torch_update_ab.py TREE LABEL    # one run of one tree

PARENT_TREE is an unpacked ``git archive`` of the commit to compare with;
the change is this checkout. Each run is a process of its own, so the two
trees' kernels and packages never meet.
"""

import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL = "rank1_update_kernel"


def one_run(tree: str, label: str):
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import sem
    from repro_torch.core.covariance import cov_matrix, normalize, rank1_gates
    from repro_torch.core.paralingam import ParaLiNGAMConfig, _compact, fit, fit_batch
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import covupdate as cu
    from repro_torch.serve.lingam_engine import pack_bucket

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    _build.build_all()
    dev = torch.device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]

    def device_rows(fn, reps):
        """(device us, name, calls) of every kernel ``reps`` calls of
        ``fn`` launch (a session that saw none is run again)."""
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            rows = [(e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
            if rows:
                return rows
        raise RuntimeError("the profiler saw no device kernel")

    def kernel_ms(fn, reps=50):
        """Device ms per launch of the update kernel, and its launches per call."""
        rows = [r for r in device_rows(fn, reps) if KERNEL in r[1]]
        us, calls = sum(r[0] for r in rows), sum(r[2] for r in rows)
        return us / calls / 1e3, calls // reps

    def capture(run):
        """The first ``ops.rank1_update`` inputs at each buffer size m."""
        got, orig = {}, ops.rank1_update

        def spy(xb, cb, roots, mloc, n_valid=None, *, inplace=False):
            if xb.shape[1] not in got:
                got[xb.shape[1]] = tuple(None if t is None else t.clone()
                                         for t in (xb, cb, roots, mloc, n_valid))
            return orig(xb, cb, roots, mloc, n_valid, inplace=inplace)

        ops.rank1_update = spy
        try:
            run()
        finally:
            ops.rank1_update = orig
        return got

    x85 = sem.generate(sem.SemSpec(p=85, n=10_000, density="sparse", seed=0))["x"]
    x512 = sem.generate(sem.SemSpec(p=512, n=2000, density="sparse", seed=1))["x"]
    rng = np.random.default_rng(13)
    shapes = [(int(rng.integers(70, 86)), int(rng.integers(8193, 10_001))) for _ in range(8)]
    raw = [sem.generate(sem.SemSpec(p=p, n=n, density="sparse", seed=100 + i))["x"]
           for i, (p, n) in enumerate(shapes)]
    xs, mask, nv, _ = pack_bucket(raw, 128, 16384)
    cfg = ParaLiNGAMConfig(score_backend="hopper_fused")
    fit85 = capture(lambda: fit(x85, cfg, device=dev))
    fit512 = capture(lambda: fit(x512, cfg, device=dev))
    bucket = capture(lambda: fit_batch(xs, cfg, n_valid=nv, mask=mask, device=dev))
    for name, (xb, cb, roots, mloc, nvb) in (("fit_p85_first", fit85[128]),
                                             ("fit_p512_first", fit512[512]),
                                             ("dispatch_first", bucket[128])):
        own = xb.clone()
        ms, per = kernel_ms(lambda: cu.launch_rank1(own, cb, roots, mloc, nvb, inplace=True))
        print(f"[update_ab] tree={label} case={name} device_ms={ms:.5f} launches={per} "
              f"gpu='{gpu}'", flush=True)

    # the ring's E. coli block 0, as dist.ring_order._update_shard builds it
    xn0 = normalize(torch.as_tensor(x85, dtype=torch.float32, device=dev))
    c0 = cov_matrix(xn0)
    order = fit(x85, cfg, device=dev)[0].order
    sel = _compact(torch.ones((1, 85), dtype=torch.bool, device=dev), 128)[0]
    xn, c = xn0[sel].contiguous(), c0[sel][:, sel].contiguous()
    m, n = 128, 10_000
    live_all = torch.arange(m, device=dev) < 85
    root = int(torch.nonzero(sel == order[0])[0, 0])
    for shards in (1, 2):
        m_l, n_loc = 64, n // shards
        live = live_all[:m_l] & (torch.arange(m_l, device=dev) != root)
        b, s_row = rank1_gates(c[:m_l, root].contiguous(), live)
        b_col, s_col = rank1_gates(c[:, root].contiguous(),
                                   live_all & (torch.arange(m, device=dev) != root))
        others = torch.zeros(m_l, device=dev)
        for k in range(1, shards):
            cols = slice(k * n_loc, (k + 1) * n_loc)
            out = (xn[:m_l, cols] - b[:, None] * xn[root, cols][None, :]) / s_row[:, None]
            others = others + torch.sum(torch.square(out), dim=-1)
        args = (xn[:m_l, :n_loc].contiguous(), c[:m_l].contiguous(),
                xn[root, :n_loc].contiguous(), b, s_row, b_col, s_col, live)
        reduce = None if shards == 1 else (lambda sq: sq.add_(others))
        ms, per = kernel_ms(lambda: ops.ring_update(*args, row0=0, n=n, reduce=reduce))
        print(f"[update_ab] tree={label} case=ring_{'1x2x1' if shards == 1 else '1x2x2'}_block0 "
              f"device_ms_per_launch={ms:.5f} launches={per} device_ms_per_update={ms * per:.5f} "
              f"gpu='{gpu}'", flush=True)

    # one dense p=85 fit and one E. coli dispatch: wall, busy, the update kernel's share
    for name, run in (("fit_p85", lambda: fit(x85, cfg, device=dev)),
                      ("dispatch_ecoli_b8",
                       lambda: fit_batch(xs, cfg, n_valid=nv, mask=mask, device=dev).orders.cpu())):
        run()
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_prof = time.perf_counter() - t0
        rows = [(e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy = sum(r[0] for r in rows) / 1e6
        upd = [r for r in rows if KERNEL in r[1]]
        print(f"[update_ab] tree={label} run={name} wall_s={','.join(f'{w:.4f}' for w in walls)} "
              f"wall_profiled_s={wall_prof:.4f} device_busy_s={busy:.4f} "
              f"update_kernel_ms={sum(r[0] for r in upd) / 1e3:.4f} "
              f"update_launches={sum(r[2] for r in upd)} gpu='{gpu}'", flush=True)


def main(parent: str) -> int:
    rc = 0
    for tree, label in ((parent, "parent"), (HERE, "change"), (HERE, "change"),
                        (parent, "parent")):
        r = subprocess.run([sys.executable, __file__, tree, label], capture_output=True,
                           text=True)
        print(r.stdout[-6000:], r.stderr[-3000:] if r.returncode else "", flush=True)
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    if len(sys.argv) == 3:
        one_run(sys.argv[1], sys.argv[2])
    elif len(sys.argv) == 2:
        sys.exit(main(sys.argv[1]))
    else:
        sys.exit(__doc__)
