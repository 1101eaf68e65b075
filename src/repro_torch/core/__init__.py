"""Solver core of the port: results, losses, projections, x-update
engines and the reference Bi-cADMM engine."""
from . import bilinear, prox
from .bicadmm import (BiCADMM, BiCADMMConfig, BiCADMMState, SolveParams,
                      reset_for_resume)
from .losses import Loss, get_loss, squared
from .results import FitResult, SolveStatus, classify_status, divergence_probe

__all__ = ["BiCADMM", "BiCADMMConfig", "BiCADMMState",
           "FitResult", "Loss", "SolveParams", "SolveStatus", "bilinear",
           "classify_status", "divergence_probe", "get_loss", "prox",
           "reset_for_resume", "squared"]
