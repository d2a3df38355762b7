"""The port's device rule: entry points run on the GPU unless asked not to.

``resolve(None)`` is ``cuda``; with no GPU it raises instead of quietly
moving to the CPU.  Callers that want the CPU (the parity tests) pass
``device="cpu"`` explicitly.  The database's device decides where every
relation, fixpoint carry and kernel of a run lives.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The device a run should use; raises when CUDA is asked for (or
    defaulted to) on a machine without a GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU by default and found no CUDA "
            "device; pass device='cpu' to run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_or_meta(device=None) -> torch.device:
    """:func:`resolve`, or the meta device where it is asked for (a dry
    run's tensors: shapes and dtypes, no storage, no GPU needed)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve(device)
