"""The messaging ring's phases of ``chip_smoke.py`` alone on one CUDA card:
the update kernel's ring mode against its plain version
(``[ring_update_kernel]``), the one-rank ring (``[ring_ecoli]``), then the
ring over 2 and 4 gloo ranks that share the card (``[ring_sharded]`` at
(1, 2, 1), (1, 4, 1), (2, 2, 1), (1, 2, 2), the iJR904 slice included).

    python examples/torch_ring_card.py

Run from the root of a checkout: it imports ``chip_smoke`` from there.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gpu = cs.gpu_line()
    print(gpu, flush=True)
    print(cs._build.build_all().keys(), f"build {time.perf_counter() - t0:.1f}", flush=True)
    x = cs.sem.generate(cs.sem.SemSpec(p=85, n=10000, density="sparse", seed=0))["x"]
    cfg = cs.ParaLiNGAMConfig(order_backend="scan", score_backend="hopper_fused")
    order = cs.causal_order(x, cfg, device=dev).order
    t = time.perf_counter()
    print(cs.phase_ring_update_kernel(dev, gpu, x, order),
          f"phase {time.perf_counter() - t:.1f}", flush=True)
    t = time.perf_counter()
    *launches, want = cs.phase_ring_ecoli(dev, gpu, False)
    print(launches, f"ring_ecoli {time.perf_counter() - t:.1f}", flush=True)
    sets = []
    for world, grids in ((2, [(1, 2, 1)]), (4, [(1, 4, 1), (2, 2, 1), (1, 2, 2)])):
        t = time.perf_counter()
        ranks, backend, cards = cs.run_ranks(
            [("ring_sharded", {"grid": g, "profile": True}) for g in grids], world)
        print("probe", ranks[0][0], f"set {world}: {time.perf_counter() - t:.1f}", flush=True)
        for i, g in enumerate(grids, 1):
            sets.append([g, [r[i] for r in ranks], backend, cards, time.perf_counter() - t0])
    print(cs.report_ring_sharded(gpu, sets, want, profile=True), flush=True)
    print(f"total {time.perf_counter() - t0:.1f}", flush=True)


if __name__ == "__main__":
    main()
