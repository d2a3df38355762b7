"""Data pipeline: synthetic and file-backed token streams (counterpart
of ``repro/data``)."""

from repro_torch.data.pipeline import (Batch, DataConfig, file_stream,
                                       make_train_iterator,
                                       synthetic_stream)

__all__ = ["DataConfig", "synthetic_stream", "file_stream",
           "make_train_iterator", "Batch"]
