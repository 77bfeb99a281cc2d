"""The paper's contribution: DirectLiNGAM + ParaLiNGAM causal discovery, in
PyTorch."""
