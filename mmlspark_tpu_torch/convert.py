"""Forests across the two packages.

A forest trained by the JAX package (``mmlspark_tpu.gbdt.booster.
Booster``) is a set of plain numpy arrays plus a few scalars; these
functions build the port's ``Booster`` from them, so the same forest
scores in both packages. Nothing of the JAX package is imported: the
caller hands over its arrays (``jax_booster.trees`` etc.) or its model
string.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from mmlspark_tpu_torch.device import DeviceLike
from mmlspark_tpu_torch.gbdt.booster import Booster, _TREE_DTYPES
from mmlspark_tpu_torch.gbdt.objectives import get_objective


def booster_from_reference(trees: Dict[str, np.ndarray], init_score,
                           objective, num_class: int,
                           feature_names: List[str],
                           params: Dict[str, Any],
                           best_iteration: int = -1,
                           tree_depths: Optional[List[int]] = None,
                           device: DeviceLike = None) -> Booster:
    """The port's Booster over the JAX Booster's forest arrays.

    ``objective`` is the objective's name or any object with a ``name``
    (the JAX ``Objective``); its ``alpha`` / ``rho`` are read when present,
    else ``params['alpha']`` / ``params['tweedie_variance_power']``."""
    name = getattr(objective, "name", objective)
    alpha = getattr(objective, "alpha", params.get("alpha", 0.9))
    rho = getattr(objective, "rho", params.get("tweedie_variance_power", 1.5))
    obj = get_objective(name, num_class=num_class, alpha=alpha,
                        tweedie_variance_power=rho)
    arrs = {k: np.array(v, dtype=_TREE_DTYPES.get(k, np.float32))
            for k, v in trees.items()}
    return Booster(obj, arrs, np.asarray(init_score, np.float64), num_class,
                   feature_names, params, best_iteration=best_iteration,
                   tree_depths=tree_depths, device=device)


def booster_from_model_string(s: str, device: DeviceLike = None) -> Booster:
    """The port's Booster from a ``"mmlspark_tpu.booster.v1"`` model
    string written by either package."""
    return Booster.from_string(s, device=device)
