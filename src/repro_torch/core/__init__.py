"""Solver core of the port: results, losses, projections, x-update
engines, the feature-split sub-solver, the reference Bi-cADMM engine, its
hyperparameter paths, the fleet driver, divergence recovery, the streaming
engine and the sharded engine on a torch.distributed grid."""
from . import (bilinear, fleet, path, prox, recovery, sharded, streaming,
               subsolver)
from .bicadmm import (BiCADMM, BiCADMMConfig, BiCADMMState, SolveParams,
                      reset_for_resume)
from .losses import (Loss, get_loss, hinge, logistic, make_softmax,
                     smoothed_hinge, squared)
from .fleet import (FleetBucket, bucket_problems, corrected_train_losses,
                    fit_many, fit_many_stacked)
from .path import fit_grid, fit_path, kappa_ladder
from .recovery import (RecoveryAttempt, RecoveryPolicy, SolveDiverged,
                       sanitize_state)
from .results import (FitResult, FleetResult, SolveStatus, SparsePath,
                      classify_status, divergence_probe, mark_aborted)
from .sharded import ShardedBiCADMM, ShardedGlobalState
from .streaming import StreamingBiCADMM
from .subsolver import SubsolverFactors, SubsolverState

__all__ = ["BiCADMM", "BiCADMMConfig", "BiCADMMState",
           "FitResult", "FleetBucket", "FleetResult", "Loss",
           "RecoveryAttempt", "RecoveryPolicy", "SolveDiverged",
           "ShardedBiCADMM", "ShardedGlobalState", "SolveParams",
           "SolveStatus", "SparsePath", "StreamingBiCADMM",
           "SubsolverFactors", "SubsolverState",
           "bilinear", "bucket_problems", "classify_status",
           "corrected_train_losses", "divergence_probe", "fit_grid",
           "fit_many", "fit_many_stacked", "fit_path", "fleet", "get_loss",
           "hinge", "kappa_ladder", "logistic", "make_softmax",
           "mark_aborted", "path", "prox", "recovery", "reset_for_resume",
           "sanitize_state", "sharded", "smoothed_hinge", "squared",
           "streaming",
           "subsolver"]
