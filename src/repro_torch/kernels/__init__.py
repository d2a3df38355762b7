"""Hand-written CUDA kernels of the main path, with plain PyTorch versions.

* ``coo_spmm.py`` — B1, fused batched COO semiring SpMM: the batched
  fixpoint's ``Δ ⊗ E`` advance (runner ``sparse_frontier_pallas``).
* ``semiring_matmul.py`` — B2, dense ⊕.⊗ product: the engine's dense
  rule-body joins and the ``vector_dense`` rounds.
* ``coo_segment.py`` — B3, segment ⊕-scatter: the reduce step of sparse
  contraction (``contract.spmv``/``spmm``).

``ref.py`` holds the plain versions, ``ops.py`` the device dispatch,
``cuda_lib.py`` the ``nvcc`` build and ``ctypes`` binding of
``csrc/*.cu``.  The reference's other two Pallas kernels (``ssm_scan``,
``flash_attention``) serve only its language-model code and are not
ported yet.
"""
