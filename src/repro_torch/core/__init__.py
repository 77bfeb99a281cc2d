"""The paper's contribution: DirectLiNGAM + ParaLiNGAM causal discovery, in
PyTorch."""

from repro_torch.core.paralingam import (
    BatchFitResult,
    CompiledFitBatch,
    ParaLiNGAMConfig,
    ParaLiNGAMResult,
    aot_fit_batch,
    causal_order,
    causal_order_batch,
    causal_order_scan,
    find_root_dense,
    find_root_threshold,
    fit,
    fit_batch,
)

__all__ = ["BatchFitResult", "CompiledFitBatch", "ParaLiNGAMConfig",
           "ParaLiNGAMResult", "aot_fit_batch", "causal_order",
           "causal_order_batch", "causal_order_scan", "find_root_dense",
           "find_root_threshold", "fit", "fit_batch"]
