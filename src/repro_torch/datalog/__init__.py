"""The paper's benchmark programs and their dataset generators."""
