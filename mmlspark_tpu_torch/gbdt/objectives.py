"""Boosting objectives: gradients/hessians, init scores, output transforms.

Port of ``mmlspark_tpu/gbdt/objectives.py``: the same nine objectives
plus softmax multiclass, with the same formulas. ``init_score`` stays
numpy float64 (it runs once on the host); ``grad_hess``, ``transform``
and ``loss`` are elementwise torch on whatever device the score tensor
lives on.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


class Objective:
    """Base objective. ``score`` tensors are raw (margin) predictions."""

    name = "base"
    num_class = 1
    is_classification = False

    def init_score(self, y: np.ndarray, w: np.ndarray) -> np.ndarray:
        """boost_from_average starting score(s), shape (num_class,)."""
        return np.zeros(self.num_class)

    def grad_hess(self, score: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
        raise NotImplementedError

    def transform(self, score: Tensor) -> Tensor:
        """Raw score -> user-facing prediction (probability / mean)."""
        return score

    def loss(self, score: Tensor, y: Tensor) -> Tensor:
        """Mean eval loss (the per-objective default metric)."""
        raise NotImplementedError


class RegressionL2(Objective):
    name = "regression"

    def init_score(self, y, w):
        return np.asarray([np.average(y, weights=w)])

    def grad_hess(self, score, y):
        return score - y, torch.ones_like(score)

    def loss(self, score, y):
        return torch.mean((score - y) ** 2)


class RegressionL1(Objective):
    name = "regression_l1"

    def init_score(self, y, w):
        return np.asarray([_weighted_quantile(y, w, 0.5)])

    def grad_hess(self, score, y):
        return torch.sign(score - y), torch.ones_like(score)

    def loss(self, score, y):
        return torch.mean(torch.abs(score - y))


class Huber(Objective):
    name = "huber"

    def __init__(self, alpha: float = 0.9):
        self.alpha = float(alpha)

    def init_score(self, y, w):
        return np.asarray([np.average(y, weights=w)])

    def grad_hess(self, score, y):
        d = score - y
        g = torch.clamp(d, -self.alpha, self.alpha)
        return g, torch.ones_like(score)

    def loss(self, score, y):
        d = torch.abs(score - y)
        return torch.mean(torch.where(d <= self.alpha, 0.5 * d * d,
                                      self.alpha * (d - 0.5 * self.alpha)))


class Quantile(Objective):
    name = "quantile"

    def __init__(self, alpha: float = 0.5):
        self.alpha = float(alpha)

    def init_score(self, y, w):
        return np.asarray([_weighted_quantile(y, w, self.alpha)])

    def grad_hess(self, score, y):
        # d/ds pinball loss: alpha-1 below the target, alpha above
        g = torch.where(score >= y, score.new_tensor(1.0 - self.alpha),
                        score.new_tensor(-self.alpha))
        return g, torch.ones_like(score)

    def loss(self, score, y):
        d = y - score
        return torch.mean(torch.maximum(self.alpha * d,
                                        (self.alpha - 1) * d))


class Poisson(Objective):
    name = "poisson"

    def init_score(self, y, w):
        mean = max(np.average(y, weights=w), 1e-9)
        return np.asarray([np.log(mean)])

    def grad_hess(self, score, y):
        e = torch.exp(score)
        return e - y, e

    def transform(self, score):
        return torch.exp(score)

    def loss(self, score, y):
        return torch.mean(torch.exp(score) - y * score)


class Tweedie(Objective):
    name = "tweedie"

    def __init__(self, rho: float = 1.5):
        self.rho = float(rho)  # variance power in (1, 2)

    def init_score(self, y, w):
        mean = max(np.average(y, weights=w), 1e-9)
        return np.asarray([np.log(mean)])

    def grad_hess(self, score, y):
        p = self.rho
        g = -y * torch.exp((1.0 - p) * score) + torch.exp((2.0 - p) * score)
        h = -y * (1.0 - p) * torch.exp((1.0 - p) * score) \
            + (2.0 - p) * torch.exp((2.0 - p) * score)
        return g, h

    def transform(self, score):
        return torch.exp(score)

    def loss(self, score, y):
        p = self.rho
        return torch.mean(torch.exp((2 - p) * score) / (2 - p)
                          - y * torch.exp((1 - p) * score) / (1 - p))


class Gamma(Tweedie):
    name = "gamma"

    def __init__(self):
        super().__init__(rho=2.0)

    def grad_hess(self, score, y):
        # rho=2 limit: grad = 1 - y*exp(-s), hess = y*exp(-s)
        e = y * torch.exp(-score)
        return 1.0 - e, e

    def loss(self, score, y):
        return torch.mean(score + y * torch.exp(-score))


class Binary(Objective):
    name = "binary"
    is_classification = True
    num_class = 1

    def init_score(self, y, w):
        p = np.clip(np.average(y, weights=w), 1e-12, 1 - 1e-12)
        return np.asarray([np.log(p / (1 - p))])

    def grad_hess(self, score, y):
        p = torch.clamp(1.0 / (1.0 + torch.exp(-score)), 1e-15, 1 - 1e-15)
        return p - y, p * (1.0 - p)

    def transform(self, score):
        return 1.0 / (1.0 + torch.exp(-score))

    def loss(self, score, y):
        p = torch.clamp(1.0 / (1.0 + torch.exp(-score)), 1e-15, 1 - 1e-15)
        return -torch.mean(y * torch.log(p) + (1 - y) * torch.log(1 - p))


class Multiclass(Objective):
    """Softmax cross-entropy; score shape (K, N), y integer labels (N,)."""

    name = "multiclass"
    is_classification = True

    def __init__(self, num_class: int):
        self.num_class = int(num_class)

    def init_score(self, y, w):
        counts = np.asarray([np.sum(w * (y == k))
                             for k in range(self.num_class)])
        p = np.clip(counts / counts.sum(), 1e-12, 1.0)
        return np.log(p)

    def grad_hess(self, score, y):
        # score: (K, N); softmax over K
        m = score - torch.amax(score, dim=0, keepdim=True)
        e = torch.exp(m)
        p = e / torch.sum(e, dim=0, keepdim=True)
        classes = torch.arange(self.num_class, device=score.device)
        onehot = (classes[:, None] == y[None, :]).to(p.dtype)
        g = p - onehot
        h = 2.0 * p * (1.0 - p)  # LightGBM's factor-2 multiclass hessian
        return g, h

    def transform(self, score):
        m = score - torch.amax(score, dim=0, keepdim=True)
        e = torch.exp(m)
        return e / torch.sum(e, dim=0, keepdim=True)

    def loss(self, score, y):
        m = score - torch.amax(score, dim=0, keepdim=True)
        logp = m - torch.log(torch.sum(torch.exp(m), dim=0, keepdim=True))
        picked = torch.gather(logp, 0, y[None, :].long())
        return -torch.mean(picked)


def _weighted_quantile(y, w, q):
    order = np.argsort(y)
    cw = np.cumsum(w[order])
    cut = q * cw[-1]
    i = int(np.searchsorted(cw, cut))
    return float(y[order[min(i, len(y) - 1)]])


_FACTORIES: Dict[str, Callable[..., Objective]] = {
    "regression": RegressionL2, "l2": RegressionL2, "mse": RegressionL2,
    "regression_l1": RegressionL1, "l1": RegressionL1, "mae": RegressionL1,
    "huber": Huber,
    "quantile": Quantile,
    "poisson": Poisson,
    "tweedie": Tweedie,
    "gamma": Gamma,
    "binary": Binary,
    "multiclass": Multiclass, "softmax": Multiclass,
}


def get_objective(name: str, num_class: int = 1, alpha: float = 0.9,
                  tweedie_variance_power: float = 1.5) -> Objective:
    key = name.lower()
    if key not in _FACTORIES:
        raise ValueError(f"unknown objective {name!r}; "
                         f"have {sorted(_FACTORIES)}")
    cls = _FACTORIES[key]
    if cls is Multiclass:
        return Multiclass(num_class)
    if cls is Quantile:
        return Quantile(alpha)
    if cls is Huber:
        return Huber(alpha)
    if cls is Tweedie:
        return Tweedie(tweedie_variance_power)
    return cls()
