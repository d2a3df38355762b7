"""Distributed runtime (counterpart of ``repro/distributed``): logical-
axis sharding (``sharding``), collectives and compressed gradient
reduction (``collectives``), GPipe pipelining (``pipeline``), the
fleet's fault tolerance (``fault_tolerance``) and graph-axis sharded
Datalog° fixpoints over ``torch.distributed`` (``datalog``).  The
``"model"`` axis's tensor-parallel operators live in ``collectives``
(an MoE layer's experts stay on their rank, ``models/moe.py``), and so
does ZeRO-3's gather of a parameter where it is used
(``collectives.gather_param``), which the sharded train step drives one
layer at a time through ``sharding.LayerGatherer``."""

from repro_torch.distributed import (  # noqa: F401
    collectives,
    pipeline,
    sharding,
)
from repro_torch.distributed.datalog import (  # noqa: F401
    GRAPH_AXIS,
    ShardedRelation,
    shard_relation,
    sharded_contract,
    sharded_resume_fixpoint,
    sharded_seminaive_fixpoint,
    unshard,
)
