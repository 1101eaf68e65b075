"""Solver core of the port: results, losses, projections, x-update
engines, the feature-split sub-solver, the reference Bi-cADMM engine and
its hyperparameter paths."""
from . import bilinear, path, prox, subsolver
from .bicadmm import (BiCADMM, BiCADMMConfig, BiCADMMState, SolveParams,
                      reset_for_resume)
from .losses import (Loss, get_loss, hinge, logistic, make_softmax,
                     smoothed_hinge, squared)
from .path import fit_grid, fit_path, kappa_ladder
from .results import (FitResult, SolveStatus, SparsePath, classify_status,
                      divergence_probe)
from .subsolver import SubsolverFactors, SubsolverState

__all__ = ["BiCADMM", "BiCADMMConfig", "BiCADMMState",
           "FitResult", "Loss", "SolveParams", "SolveStatus", "SparsePath",
           "SubsolverFactors", "SubsolverState", "bilinear",
           "classify_status", "divergence_probe", "fit_grid", "fit_path",
           "get_loss", "hinge", "kappa_ladder", "logistic", "make_softmax",
           "path", "prox", "reset_for_resume", "smoothed_hinge", "squared",
           "subsolver"]
