"""Solver core of the port: results, losses, projections, x-update
engines, the feature-split sub-solver and the reference Bi-cADMM engine."""
from . import bilinear, prox, subsolver
from .bicadmm import (BiCADMM, BiCADMMConfig, BiCADMMState, SolveParams,
                      reset_for_resume)
from .losses import (Loss, get_loss, hinge, logistic, make_softmax,
                     smoothed_hinge, squared)
from .results import FitResult, SolveStatus, classify_status, divergence_probe
from .subsolver import SubsolverFactors, SubsolverState

__all__ = ["BiCADMM", "BiCADMMConfig", "BiCADMMState",
           "FitResult", "Loss", "SolveParams", "SolveStatus",
           "SubsolverFactors", "SubsolverState", "bilinear",
           "classify_status", "divergence_probe", "get_loss", "hinge",
           "logistic", "make_softmax", "prox", "reset_for_resume",
           "smoothed_hinge", "squared", "subsolver"]
