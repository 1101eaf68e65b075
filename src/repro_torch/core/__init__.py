"""Solver core of the port: results, losses, projections, x-update
engines, the feature-split sub-solver, the reference Bi-cADMM engine, its
hyperparameter paths and the fleet driver."""
from . import bilinear, fleet, path, prox, subsolver
from .bicadmm import (BiCADMM, BiCADMMConfig, BiCADMMState, SolveParams,
                      reset_for_resume)
from .losses import (Loss, get_loss, hinge, logistic, make_softmax,
                     smoothed_hinge, squared)
from .fleet import (FleetBucket, bucket_problems, corrected_train_losses,
                    fit_many, fit_many_stacked)
from .path import fit_grid, fit_path, kappa_ladder
from .results import (FitResult, FleetResult, SolveStatus, SparsePath,
                      classify_status, divergence_probe, mark_aborted)
from .subsolver import SubsolverFactors, SubsolverState

__all__ = ["BiCADMM", "BiCADMMConfig", "BiCADMMState",
           "FitResult", "FleetBucket", "FleetResult", "Loss", "SolveParams",
           "SolveStatus", "SparsePath", "SubsolverFactors", "SubsolverState",
           "bilinear", "bucket_problems", "classify_status",
           "corrected_train_losses", "divergence_probe", "fit_grid",
           "fit_many", "fit_many_stacked", "fit_path", "fleet", "get_loss",
           "hinge", "kappa_ladder", "logistic", "make_softmax",
           "mark_aborted", "path", "prox", "reset_for_resume",
           "smoothed_hinge", "squared", "subsolver"]
