"""The paper's own workload configs: ParaLiNGAM causal-discovery problems.

Sizes follow the paper's evaluations: the real metabolic-network datasets
(Table 1: p in [85, 2339], n = 10000) and the synthetic scalability sweep
(Fig. 4: p in {100, 200, 500, 1000} x n in {1024 .. 8192}); plus a
pod-scale extrapolation cell (p = 16384) for the distributed ring."""

from dataclasses import dataclass


@dataclass(frozen=True)
class LingamConfig:
    name: str
    p: int  # number of variables
    n: int  # number of samples
    density: str = "sparse"
    # distributed execution
    block_j: int = 128  # pair-tile width per ring hop


# Paper-representative cells
ECOLI_CORE = LingamConfig("lingam-ecoli-core", p=85, n=10000)
IJR904 = LingamConfig("lingam-ijr904", p=770, n=10000)
IML1515 = LingamConfig("lingam-iml1515", p=2326, n=10000)
FIG4_P1000 = LingamConfig("lingam-fig4-p1000", p=1000, n=8192)
POD_SCALE = LingamConfig("lingam-pod-16k", p=16384, n=10000)

ALL = {c.name: c for c in [ECOLI_CORE, IJR904, IML1515, FIG4_P1000, POD_SCALE]}
