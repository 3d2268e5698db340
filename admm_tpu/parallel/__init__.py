"""Distributed execution over a jax.sharding Mesh.

A compiled re-design of the reference's MATLAB Parallel Computing Toolbox
layer (gcp/parfor; reference admm.m:343-467, getProxOps.m:367-442,
1217-1343, solvers/unwrappedadmm.m:96-141).  The reference crosses the
client->worker process boundary twice per prox per iteration (broadcast +
gather); here each distributed solver is ONE compiled XLA program per
solve — state lives sharded across devices, and the reference's
broadcast/gather/all-reduce patterns become psum/pmean collectives, which
XLA hands to NCCL between GPUs (multi-host: jax.distributed).

Three distributed forms, matching SURVEY.md section 2.7:

- consensus ADMM (global-variable LASSO): `consensus.consensus_lasso`
- transpose-reduction unwrapped ADMM (SVM): `transpose_reduction`
- exchange ADMM (sum-coupled agents, Boyd sec. 7.3.2 — beyond
  reference): `exchange.exchange_admm`
- engine-generic sliced proximal updates (even or uneven slices,
  'xminf'/'zming'/'both'): `sliced.make_sliced_prox`,
  `sliced.make_parallel_proxes`
"""

from .mesh import make_mesh, make_mesh2d, pad_rows, shard_rows
from .consensus import (consensus_admm, consensus_covsel,
                        consensus_covsel_batch,
                        consensus_elasticnet, consensus_elasticnet_batch,
                        consensus_lasso, consensus_lasso_batch,
                        consensus_logreg)
from .transpose_reduction import (unwrapped_admm_sharded,
                                  linearsvm_sharded, svm_batch_sharded)
from .exchange import exchange_admm, exchange_quadratic
from .sdp import sdp_sharded
from .sliced import make_parallel_proxes, make_sliced_prox
from .multihost import global_mesh, initialize_cluster

__all__ = [
    "initialize_cluster",
    "global_mesh",
    "make_mesh",
    "make_mesh2d",
    "pad_rows",
    "shard_rows",
    "consensus_admm",
    "consensus_covsel",
    "consensus_covsel_batch",
    "sdp_sharded",
    "exchange_admm",
    "exchange_quadratic",
    "consensus_elasticnet",
    "consensus_lasso",
    "consensus_lasso_batch",
    "consensus_elasticnet_batch",
    "consensus_logreg",
    "unwrapped_admm_sharded",
    "linearsvm_sharded",
    "svm_batch_sharded",
    "make_parallel_proxes",
    "make_sliced_prox",
]
