"""gloo's collectives on CUDA tensors of ranks that share one card: the
milliseconds of one call and the GB/s per rank, by op and message size.

The sharded phases of ``chip_smoke.py`` run every rank on the one card
over gloo (NCCL refuses two ranks on one card); this probe gives the
transport's rate that their step times rest on: ``all_gather`` and
``all_gather_into_tensor`` (FSDP's forward), ``reduce_scatter`` and
``reduce_scatter_tensor`` (its backward), ``broadcast`` and
``all_reduce``, each at 1, 8, 64 and 256 MiB of float32 per rank, over 2
and then 4 ranks.

    python examples/torch_gloo_bandwidth.py

Needs a CUDA card; prints one ``[gloo_bw]`` line per (ranks, op, size).
"""

import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SIZES_MIB = (1, 8, 64, 256)


def rank_main(rank: int, world: int, init: str):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    dev = torch.device("cuda")
    rows = []
    for mib in SIZES_MIB:
        n = mib * (1 << 20) // 4
        x = torch.randn(n, device=dev)
        parts = [torch.empty(n, device=dev) for _ in range(world)]
        blocks = [torch.randn(n, device=dev) for _ in range(world)]
        out = torch.empty(n, device=dev)
        flat_out, flat_in = torch.empty(n * world, device=dev), torch.randn(n * world, device=dev)
        ops = {
            "all_gather": lambda: dist.all_gather(parts, x),
            "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(flat_out, x),
            "reduce_scatter": lambda: dist.reduce_scatter(out, blocks),
            "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(out, flat_in),
            "broadcast": lambda: dist.broadcast(x, src=0),
            "all_reduce": lambda: dist.all_reduce(x),
        }
        for name, op in ops.items():
            op()  # warm-up
            torch.cuda.synchronize()
            dist.barrier()
            reps = max(2, min(20, 512 // mib))
            t0 = time.perf_counter()
            for _ in range(reps):
                op()
            torch.cuda.synchronize()
            rows.append((name, mib, (time.perf_counter() - t0) / reps))
    if rank == 0:
        for name, mib, dt in rows:
            print(f"[gloo_bw] ranks={world} op={name} mib_per_rank={mib} ms={dt * 1e3:.2f} "
                  f"gb_per_s_per_rank={mib / 1024 / dt:.3f}", flush=True)
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), flush=True)
    for world in (2, 4):
        with tempfile.TemporaryDirectory() as tmp:
            mp.spawn(rank_main, args=(world, "file://" + os.path.join(tmp, "init")),
                     nprocs=world, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
