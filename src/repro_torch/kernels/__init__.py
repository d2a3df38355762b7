"""Hand-written CUDA kernels of the main path, with plain PyTorch versions.

* ``coo_spmm.py`` — B1, fused batched COO semiring SpMM: the batched
  fixpoint's ``Δ ⊗ E`` advance (runner ``sparse_frontier_pallas``).
* ``semiring_matmul.py`` — B2, dense ⊕.⊗ product: the engine's dense
  rule-body joins and the ``vector_dense`` rounds.
* ``coo_segment.py`` — B3, segment ⊕-reduce: the reduce step of sparse
  contraction (``contract.spmv``/``spmm``), over the sorted runs of a
  cached segment plan, or a scatter for ids without one.
* ``ssm_scan.py`` — B4, the diagonal linear recurrence: the Mamba2
  and mLSTM scan of the language models (``models/ssm.py``), with its
  gradient ``ScanFn``.
* ``flash_attention.py`` — B5, GQA attention: every attention of the
  language models (``models/attention.py``), prefill and decode, with
  its gradient ``AttnFn`` (three backward kernels).

``ref.py`` holds the plain versions, ``ops.py`` the device dispatch,
``cuda_lib.py`` the ``nvcc`` build and ``ctypes`` binding of
``csrc/*.cu``.
"""
