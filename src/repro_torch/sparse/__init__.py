"""Sparse S-relations: padded COO storage, sparse contraction, the
density switch, and the staged sparse fixpoint."""
