"""Graph-axis sharded Datalog° fixpoints over ``torch.distributed`` and
the fleet's fault tolerance (``fault_tolerance``): the counterpart of
``repro/distributed``, whose sharding rules, collectives and pipeline
are not ported yet (ROADMAP A7)."""

from repro_torch.distributed.datalog import (  # noqa: F401
    GRAPH_AXIS,
    ShardedRelation,
    shard_relation,
    sharded_contract,
    sharded_resume_fixpoint,
    sharded_seminaive_fixpoint,
    unshard,
)
