"""The messaging ring at R = 1 on one CUDA card, in two source trees: the
E. coli core order (p=85, n=10000, sparse, seed 0) through
``causal_order_ring`` under ``hopper_fused`` and an NCCL process group of
one rank. Each run makes a warm-up order, 7 timed orders and one more
under a ``CollectiveLedger``, and prints a ``[ring_ab]`` line with the
seconds, the collectives counted and the order's head.

    python examples/torch_ring_ab.py PARENT_TREE   # parent, change, change, parent
    python examples/torch_ring_ab.py TREE LABEL    # one run of one tree

PARENT_TREE is an unpacked ``git archive`` of the commit to compare with;
the change is this checkout. Each run is a process of its own, so the two
trees' kernels and packages never meet.
"""

import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_run(tree: str, label: str):
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.core import sem
    from repro_torch.core.paralingam import ParaLiNGAMConfig
    from repro_torch.dist.ring_order import causal_order_ring
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_ring_mesh
    from repro_torch.utils.collectives import CollectiveLedger

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    _build.build_all()
    x = sem.generate(sem.SemSpec(p=85, n=10000, density="sparse", seed=0))["x"]
    cfg = ParaLiNGAMConfig(order_backend="ring", score_backend="hopper_fused")
    dev = torch.device("cuda")
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/init", rank=0, world_size=1)
        mesh = make_ring_mesh(1, 1, 1)
        causal_order_ring(x, cfg, mesh=mesh, device=dev)
        times = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = causal_order_ring(x, cfg, mesh=mesh, device=dev)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        with CollectiveLedger() as ledger:
            causal_order_ring(x, cfg, mesh=mesh, device=dev)
        dist.destroy_process_group()
    print(f"[ring_ab] tree={label} order_s={','.join(f'{t:.4f}' for t in times)} "
          f"min_s={min(times):.4f} collectives={ledger.calls} order_head={res.order[:6]}",
          flush=True)


def main(parent: str) -> int:
    rc = 0
    for tree, label in ((parent, "parent"), (HERE, "change"), (HERE, "change"),
                        (parent, "parent")):
        r = subprocess.run([sys.executable, __file__, tree, label], capture_output=True,
                           text=True)
        print(r.stdout[-4000:], r.stderr[-2000:] if r.returncode else "", flush=True)
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    if len(sys.argv) == 3:
        one_run(sys.argv[1], sys.argv[2])
    elif len(sys.argv) == 2:
        sys.exit(main(sys.argv[1]))
    else:
        sys.exit(__doc__)
