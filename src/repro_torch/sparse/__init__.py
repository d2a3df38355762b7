"""Sparse S-relations: padded COO storage, sparse contraction, the
density switch and the re-planning policy, and the staged and worklist
fixpoints."""

from repro_torch.sparse.adaptive import (DENSIFY_ABOVE, SPARSIFY_BELOW,
                                         ReplanPolicy, adapt_value, density)
from repro_torch.sparse.contract import mspm, spmm, spmspm, spmv, vspm
from repro_torch.sparse.coo import SparseRelation
# the fixpoint() *function* is not re-exported: binding that name here
# would shadow the ``repro_torch.sparse.fixpoint`` submodule
from repro_torch.sparse.fixpoint import (FixpointState, FrontierStats,
                                         resume_fixpoint,
                                         sparse_seminaive_fixpoint)

__all__ = [
    "SparseRelation", "spmv", "vspm", "spmm", "mspm", "spmspm",
    "FixpointState", "FrontierStats", "ReplanPolicy",
    "sparse_seminaive_fixpoint", "resume_fixpoint", "density",
    "adapt_value", "SPARSIFY_BELOW", "DENSIFY_ABOVE",
]
