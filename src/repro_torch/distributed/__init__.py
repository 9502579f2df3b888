"""Distributed runtime pieces of the port: the sharding rules over a mesh of
virtual ranks (``sharding``), the pipeline schedule (``pipeline``), the
elastic mesh (runtime grow/shrink of executor ranks, its autoscaling
policy and ``restore_elastic``) and gradient compression."""
from repro_torch.distributed.compression import compressed_grads, init_ef_state  # noqa: F401
from repro_torch.distributed.elastic import (  # noqa: F401
    ElasticPolicy,
    PlacedState,
    plan_reshard,
    repad_block,
    reshard_cached,
    restore_elastic,
)
from repro_torch.distributed.pipeline import pipeline_apply, reference_apply  # noqa: F401
from repro_torch.distributed.sharding import (  # noqa: F401
    PartitionSpec,
    Placement,
    batch_axes,
    cache_specs,
    input_specs_sharding,
    lead_axes,
    opt_specs,
    param_specs,
    rank_bytes,
    to_named,
)
