"""Losses of the port (counterpart of ``repro.core.losses``): the paper's
four models.

* SLinR  — squared loss;
* SLogR  — logistic loss, labels b in {-1, +1};
* SSVM   — smoothed (Huberized) hinge, and the plain hinge;
* SSR    — softmax over C classes, integer labels; pred is (m, C).

Each loss has ``value(pred, b)`` (summed over samples), ``grad(pred, b)``
(d value / d pred), ``prox_omega(q, b, c)`` (per sample
argmin_w l(w, b) + c/2 (w - q)^2, the omega-bar step (21) of the
feature-split sub-solver), and the inference maps ``decision`` and
``predict``. Every oracle is elementwise or acts on the trailing class axis,
so leading axes (the nodes) pass through. The per-sample Newton loops of
the logistic and softmax prox keep the JAX package's fixed iteration
counts (25 and 20).

The fleet maps ``value_many`` / ``decision_many`` / ``predict_many`` take a
leading problem axis (``(B, m)`` scores or ``(B, m, C)`` logits): each
registry loss sums its per-sample terms over every axis but the first
(each problem's sum over its own row, as ``value`` sums it), and the
inference maps act elementwise or on the trailing class axis already.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable

import torch
import torch.nn.functional as F


def _identity(pred: torch.Tensor) -> torch.Tensor:
    return pred


def _sign_predict(pred: torch.Tensor) -> torch.Tensor:
    """Margin scores -> {-1, +1} labels (ties broken toward +1)."""
    return torch.where(pred >= 0, 1.0, -1.0).to(pred.dtype)


def _argmax_predict(pred: torch.Tensor) -> torch.Tensor:
    """(m, C) logits -> integer class labels (first maximum on ties)."""
    return torch.argmax(pred, dim=-1)


@dataclasses.dataclass(frozen=True)
class Loss:
    """A loss and its oracles (see ``repro.core.losses.Loss``)."""
    name: str
    value: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    grad: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    prox_omega: Callable
    n_classes: int = 1
    decision: Callable[[torch.Tensor], torch.Tensor] = _identity
    predict: Callable[[torch.Tensor], torch.Tensor] = _identity

    def predict_dim(self, n_features: int) -> int:
        return n_features * self.n_classes

    def value_many(self, preds: torch.Tensor,
                   bs: torch.Tensor) -> torch.Tensor:
        """Per-problem training losses of a stacked fleet: ``preds`` (B, m)
        or (B, m, C), ``bs`` (B, m) -> (B,), ``value(preds[i], bs[i])``
        each. A loss whose ``value`` takes no ``many`` keyword is summed
        problem by problem."""
        if "many" in inspect.signature(self.value).parameters:
            return self.value(preds, bs, many=True)
        return torch.stack([self.value(p, b) for p, b in zip(preds, bs)])

    def decision_many(self, preds: torch.Tensor) -> torch.Tensor:
        """Batched ``decision`` map (it acts per score already)."""
        return self.decision(preds)

    def predict_many(self, preds: torch.Tensor) -> torch.Tensor:
        """Batched ``predict`` map: (B, m[, C]) scores to per-problem
        predicted targets."""
        return self.predict(preds)


def _total(x: torch.Tensor, many: bool) -> torch.Tensor:
    """The sum of x, or with ``many`` each problem's (the leading axis)."""
    return x.flatten(1).sum(1) if many else torch.sum(x)


# ----------------------------------------------------------------- squared --
def _sq_value(pred, b, many=False):
    return 0.5 * _total((pred - b) ** 2, many)


def _sq_grad(pred, b):
    return pred - b


def _sq_prox(q, b, c):
    # argmin_w 1/2 (w-b)^2 + c/2 (w-q)^2  = (b + c q) / (1 + c)
    return (b + c * q) / (1.0 + c)


squared = Loss("squared", _sq_value, _sq_grad, _sq_prox)


# ---------------------------------------------------------------- logistic --
def _log_value(pred, b, many=False):
    # labels b in {-1, +1}; sum_i log(1 + exp(-b_i pred_i))
    return _total(F.softplus(-b * pred), many)


def _log_grad(pred, b):
    return -b * torch.sigmoid(-b * pred)


def _log_prox(q, b, c, iters: int = 25):
    """Per-sample Newton for argmin_w softplus(-b w) + c/2 (w-q)^2: the
    objective is c-strongly convex, so the unit step converges; the step is
    clipped to +-1e3 as in the JAX package."""
    w = q
    for _ in range(iters):
        sig = torch.sigmoid(-b * w)
        g = -b * sig + c * (w - q)
        h = sig * (1.0 - sig) + c
        w = w - torch.clamp(g / h, -1e3, 1e3)
    return w


logistic = Loss("logistic", _log_value, _log_grad, _log_prox,
                predict=_sign_predict)


# ------------------------------------------------------------------- hinge --
def _hinge_value(pred, b, many=False):
    return _total(torch.clamp_min(1.0 - b * pred, 0.0), many)


def _hinge_grad(pred, b):
    return torch.where(b * pred < 1.0, -b, 0.0)


def _hinge_prox(q, b, c):
    """Closed-form prox of max(0, 1 - b w) in margin coordinates m = b w:
    m >= 1 -> m; m <= 1 - 1/c -> m + 1/c; else 1."""
    m = b * q
    out = torch.where(m >= 1.0, m,
                      torch.where(m <= 1.0 - 1.0 / c, m + 1.0 / c, 1.0))
    return b * out


hinge = Loss("hinge", _hinge_value, _hinge_grad, _hinge_prox,
             predict=_sign_predict)


# ---------------------------------------------------------- smoothed hinge --
def _shinge_value(pred, b, eps: float = 0.5, many=False):
    """Huberized hinge (quadratic smoothing on [1-eps, 1])."""
    m = b * pred
    quad = 0.5 / eps * (1.0 - m) ** 2
    lin = 1.0 - m - 0.5 * eps
    return _total(torch.where(m >= 1.0, 0.0,
                              torch.where(m >= 1.0 - eps, quad, lin)), many)


def _shinge_grad(pred, b, eps: float = 0.5):
    m = b * pred
    d = torch.where(m >= 1.0, 0.0,
                    torch.where(m >= 1.0 - eps, (m - 1.0) / eps, -1.0))
    return b * d


def _shinge_prox(q, b, c, eps: float = 0.5):
    """Exact prox of the Huberized hinge: solve each linear piece of the
    monotone derivative in the margin m = b w and select."""
    qm = b * q
    m2 = (1.0 / eps + c * qm) / (1.0 / eps + c)
    m3 = qm + 1.0 / c
    m = torch.where(qm >= 1.0, qm,
                    torch.where(m3 <= 1.0 - eps, m3,
                                torch.clamp(m2, 1.0 - eps, 1.0)))
    return b * m


smoothed_hinge = Loss("smoothed_hinge", _shinge_value, _shinge_grad,
                      _shinge_prox, predict=_sign_predict)


# ----------------------------------------------------------------- softmax --
def make_softmax(n_classes: int) -> Loss:
    """Multinomial logistic (softmax) regression with C classes:
    pred (..., m, C) logits, b (..., m) integer labels (any dtype)."""
    C = n_classes

    def onehot(b, like):
        return F.one_hot(b.long(), C).to(like.dtype)

    def value(pred, b, many=False):
        lse = torch.logsumexp(pred, dim=-1)
        picked = torch.gather(pred, -1, b.long()[..., None])[..., 0]
        return _total(lse - picked, many)

    def grad(pred, b):
        return torch.softmax(pred, dim=-1) - onehot(b, pred)

    def prox_omega(q, b, c, iters: int = 20):
        """Per-sample C-dim Newton: argmin_w lse(w) - w_b + c/2 ||w - q||^2.
        The Hessian diag(p) - p p^T + c I is inverted exactly per sample by
        Sherman-Morrison."""
        oh = onehot(b, q)
        w = q
        for _ in range(iters):
            p = torch.softmax(w, dim=-1)
            g = p - oh + c * (w - q)
            d = p + c
            ig, ip = g / d, p / d
            denom = 1.0 - torch.sum(p * ip, dim=-1, keepdim=True)
            corr = ip * (torch.sum(p * ig, dim=-1, keepdim=True)
                         / torch.clamp_min(denom, 1e-6))
            w = w - (ig + corr)
        return w

    return Loss(f"softmax{C}", value, grad, prox_omega, n_classes=C,
                predict=_argmax_predict)


REGISTRY: dict[str, Loss] = {
    "squared": squared,
    "logistic": logistic,
    "hinge": hinge,
    "smoothed_hinge": smoothed_hinge,
}


def get_loss(name: str, n_classes: int = 1) -> Loss:
    """The registry loss ``name``; ``"softmax"`` (or ``"softmaxC"``) builds
    the C-class softmax, C taken from ``n_classes`` first as in the JAX
    package."""
    if name.startswith("softmax"):
        c = n_classes or int(name.removeprefix("softmax") or "0")
        return make_softmax(c)
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown loss {name!r}; known: "
                       f"{sorted(REGISTRY)} and 'softmax'") from None
