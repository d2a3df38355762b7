"""Hand-written CUDA kernels of the main path, with plain PyTorch versions.

* ``coo_spmm.py`` — B1, fused batched COO semiring SpMM: the batched
  fixpoint's ``Δ ⊗ E`` advance (runner ``sparse_frontier_pallas``).
* ``semiring_matmul.py`` — B2, dense ⊕.⊗ product: the engine's dense
  rule-body joins and the ``vector_dense`` rounds.
* ``coo_segment.py`` — B3, segment ⊕-scatter: the reduce step of sparse
  contraction (``contract.spmv``/``spmm``).
* ``ssm_scan.py`` — B4, the diagonal linear recurrence: the Mamba2
  prefill scan of the language-model serving path (``models/ssm.py``).
* ``flash_attention.py`` — B5, GQA attention forward: every
  self-attention of that path (``models/attention.py``), prefill and
  decode.

``ref.py`` holds the plain versions, ``ops.py`` the device dispatch,
``cuda_lib.py`` the ``nvcc`` build and ``ctypes`` binding of
``csrc/*.cu``.
"""
