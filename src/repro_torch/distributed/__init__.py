"""Distributed runtime pieces of the port: the elastic mesh (runtime
grow/shrink of executor ranks and its autoscaling policy) and gradient
compression. The sharding rules and the pipeline schedule of the JAX
package's ``distributed/`` are not ported yet (ROADMAP: the rest of
``distributed/``)."""
from repro_torch.distributed.compression import compressed_grads, init_ef_state  # noqa: F401
from repro_torch.distributed.elastic import (  # noqa: F401
    ElasticPolicy,
    plan_reshard,
    repad_block,
    reshard_cached,
    restore_elastic,
)
