"""The paper's contribution: DirectLiNGAM + ParaLiNGAM causal discovery, in
PyTorch."""

from repro_torch.core import adjacency, direct_lingam, entropy, pairwise, pruning, sem
from repro_torch.core.covariance import cov_matrix, normalize, update_cov, update_data
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
from repro_torch.core.validate import (
    DatasetDiagnostics,
    DatasetError,
    require_valid,
    validate_dataset,
)

__all__ = ["BatchFitResult", "CompiledFitBatch", "DatasetDiagnostics",
           "DatasetError", "ParaLiNGAMConfig", "ParaLiNGAMResult", "adjacency",
           "aot_fit_batch", "causal_order", "causal_order_batch",
           "causal_order_scan", "cov_matrix", "direct_lingam", "entropy",
           "find_root_dense", "find_root_threshold", "fit", "fit_batch",
           "normalize", "pairwise", "pruning", "require_valid", "sem",
           "update_cov", "update_data", "validate_dataset"]
