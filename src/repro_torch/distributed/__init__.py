"""Graph-axis sharded Datalog° fixpoints over ``torch.distributed``
(the counterpart of ``repro/distributed``; its sharding rules,
collectives, pipeline and fault-tolerance modules are not ported yet,
ROADMAP A7)."""

from repro_torch.distributed.datalog import (  # noqa: F401
    GRAPH_AXIS,
    ShardedRelation,
    shard_relation,
    sharded_contract,
    sharded_resume_fixpoint,
    sharded_seminaive_fixpoint,
    unshard,
)
