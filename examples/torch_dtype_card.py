"""The float64 phases of ``chip_smoke.py`` alone on one CUDA card:
``[fit_ecoli_core]`` (the float32 E. coli fits they are compared with),
then ``[fit_f64]`` and ``[fit_batch_f64]``, with the seconds of each.

    python examples/torch_dtype_card.py

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
    print(list(cs._build.build_all()), f"build {time.perf_counter() - t0:.1f}", flush=True)
    t = time.perf_counter()
    _, core = cs.phase_fit_core(dev, gpu)
    print(f"fit_ecoli_core {time.perf_counter() - t:.1f}", flush=True)
    for name, phase in (("fit_f64", lambda: cs.phase_fit_f64(dev, gpu, core)),
                        ("fit_batch_f64", lambda: cs.phase_fit_batch_f64(dev, gpu))):
        t = time.perf_counter()
        phase()
        print(f"{name} {time.perf_counter() - t:.1f}", flush=True)
    print(f"total {time.perf_counter() - t0:.1f}", flush=True)


if __name__ == "__main__":
    main()
