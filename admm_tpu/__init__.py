"""admm_tpu: an ADMM convex-optimization framework in JAX.

Brand-new JAX/XLA implementation of the full capability surface of the
MATLAB reference library PeterSutor/ADMM-Project (see SURVEY.md): a generic
scaled-dual ADMM engine (vanilla / relaxed / fast / accelerated-with-restart
/ adaptive-rho, Boyd + H-norm stopping, built-in divergence monitor), a
registry of proximal-operator problem definitions (model, lasso, basis
pursuit, total variation, LAD, Huber fitting, LP, QP, covariance selection,
linear SVM with hinge and 0-1 loss via unwrapped ADMM), and distributed
execution (consensus ADMM, sliced proximal updates, transpose reduction,
exchange ADMM)
over a jax.sharding Mesh with psum/pmean collectives.  Beyond the
reference: instance-batched (vmap) solvers, warm-startable path solvers,
and differentiable solves via implicit differentiation of the ADMM fixed
point (make_implicit_solver).
"""

from .config import ADMMConfig
from .engine import Constraint, Hooks, admm, make_admm_runner
from .linop import DenseOp, DiffOp, FnOp, ScaledIdentityOp, as_linop
from .results import ADMMResults
from .models import (
    basispursuit,
    covarianceselection,
    elasticnet,
    fusedlasso,
    quantile,
    rpca,
    sdp,
    matrixcompletion,
    get_prox_ops,
    grouplasso,
    huberfit,
    lad,
    lasso,
    logreg,
    linearprogram,
    linearsvm,
    model,
    nnls,
    quadraticprogram,
    totalvariation,
    totalvariation2d,
    unwrappedadmm,
)

from .diff import (make_implicit_batch_solver, make_implicit_consensus_solver,
                   make_implicit_solver, make_implicit_unwrapped_solver)
from .models.paths import covsel_path, lasso_path, linearsvm_c_path, tv_path
from .models.batch import (
    basispursuit_batch,
    covsel_batch,
    elasticnet_batch,
    grouplasso_batch,
    huberfit_batch,
    fusedlasso_batch,
    lad_batch,
    quantile_batch,
    rpca_batch,
    sdp_batch,
    matrixcompletion_batch,
    lasso_batch,
    logreg_batch,
    lp_batch,
    model_batch,
    nnls_batch,
    qp_batch,
    qp_structure,
    svm_batch,
    tv2d_batch,
    tv_batch,
)
from . import parallel, testers, utils  # noqa: F401  (subpackage access)

__version__ = "0.1.0"

__all__ = [
    "ADMMConfig",
    "ADMMResults",
    "Constraint",
    "Hooks",
    "admm",
    "make_admm_runner",
    "make_implicit_batch_solver",
    "make_implicit_consensus_solver",
    "make_implicit_solver",
    "make_implicit_unwrapped_solver",
    "DenseOp",
    "DiffOp",
    "FnOp",
    "ScaledIdentityOp",
    "as_linop",
    "get_prox_ops",
    "model",
    "lasso",
    "elasticnet",
    "fusedlasso",
    "quantile",
    "rpca",
    "sdp",
    "matrixcompletion",
    "logreg",
    "grouplasso",
    "nnls",
    "basispursuit",
    "totalvariation",
    "totalvariation2d",
    "lad",
    "huberfit",
    "linearprogram",
    "quadraticprogram",
    "covarianceselection",
    "linearsvm",
    "unwrappedadmm",
    "lasso_path",
    "covsel_path",
    "tv_path",
    "linearsvm_c_path",
    "lasso_batch",
    "logreg_batch",
    "elasticnet_batch",
    "grouplasso_batch",
    "nnls_batch",
    "tv_batch",
    "fusedlasso_batch",
    "lad_batch",
    "quantile_batch",
    "rpca_batch",
    "sdp_batch",
    "matrixcompletion_batch",
    "huberfit_batch",
    "basispursuit_batch",
    "covsel_batch",
    "svm_batch",
    "lp_batch",
    "qp_batch",
    "model_batch",
    "tv2d_batch",
    "qp_structure",
]
