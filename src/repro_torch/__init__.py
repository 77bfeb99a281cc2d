"""repro_torch -- ParaLiNGAM in PyTorch, with hand-written CUDA kernels for
an NVIDIA H100 (Hopper, sm_90a).

The port of the JAX package ``repro``, slice by slice, with the same layout
(``core/``, ``kernels/``, ``serve/``, ``utils/``, ``models/``, ``configs/``,
``launch/``). It imports neither JAX nor ``repro``. Entry points (``fit``,
``fit_batch``, ``causal_order_batch``, the engines of ``repro_torch.serve``,
``models.lm.init_params`` and ``launch.serve``) run on the CUDA device
unless the caller asks for the CPU (``device="cpu"`` runs the plain torch
path).

Importing it does no work: kernels are compiled on first use
(``kernels/_build.py``).
"""

__version__ = "0.1.0"

from repro_torch.core.paralingam import (
    BatchFitResult,
    ParaLiNGAMConfig,
    ParaLiNGAMResult,
    causal_order_batch,
    fit,
    fit_batch,
)
from repro_torch.serve.async_engine import AsyncLingamEngine

__all__ = ["AsyncLingamEngine", "BatchFitResult", "ParaLiNGAMConfig",
           "ParaLiNGAMResult", "__version__", "causal_order_batch", "fit",
           "fit_batch"]
