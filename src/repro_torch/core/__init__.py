"""IgnisHPC on torch: the core (paper's contribution), ported from the JAX
package ``repro.core``.

One communication fabric — ``p`` virtual executor ranks on one torch device,
collectives as tensor ops over the rank axis — under two programming models:

  * a Spark-inspired lazy dataflow API (``IDataFrame``) whose shuffles,
    sorts and reductions run on the device (no driver round-trips)
  * native SPMD "MPI" programs (``worker.call``) that receive the worker's
    communicator exactly like IgnisHPC hands MPI apps ``IGNIS_COMM_WORLD``

plus the lazy task-dependency graph with lineage-based fault tolerance and
the job-oriented driver layer (``IJob``/``IFuture``: every action submits
into a cross-worker job DAG; eager actions are facades).
"""
from repro_torch.core.properties import IProperties  # noqa: F401
from repro_torch.core.cluster import Ignis, ICluster, IWorker  # noqa: F401
from repro_torch.core.dataframe import IDataFrame  # noqa: F401
from repro_torch.core.context import IContext  # noqa: F401
from repro_torch.core.textlambda import ISource, text_lambda  # noqa: F401
from repro_torch.core.native import ignis_export  # noqa: F401
from repro_torch.core.job import IFuture, IJob, JobScheduler  # noqa: F401
from repro_torch.core.faults import FaultInjected, FaultPlan, Recoverable  # noqa: F401
