"""Models across the two packages.

A forest trained by the JAX package (``mmlspark_tpu.gbdt.booster.
Booster``) is a set of plain numpy arrays plus a few scalars;
``booster_from_reference`` / ``booster_from_model_string`` build the
port's ``Booster`` from them, so the same forest scores in both
packages. A flax network of the JAX zoo is a spec plus nested dicts of
arrays; ``module_from_flax`` builds the port's ``nn.Module`` from them.
Nothing of the JAX package is imported: the caller hands over its arrays
(``jax_booster.trees``, ``variables``) or its model string.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from mmlspark_tpu_torch.device import DeviceLike
from mmlspark_tpu_torch.gbdt.booster import Booster, _TREE_DTYPES
from mmlspark_tpu_torch.gbdt.objectives import get_objective
from mmlspark_tpu_torch.models import networks


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


# flax leaf name -> torch parameter name, by module type; a Dense kernel
# is (in, out) in flax and (out, in) in torch
_FLAX_LEAVES = {nn.Linear: (("kernel", "weight"), ("bias", "bias")),
                nn.LayerNorm: (("scale", "weight"), ("bias", "bias")),
                nn.Embedding: (("embedding", "weight"),)}


def module_from_flax(spec: Dict[str, Any], variables: Dict[str, Any],
                     device: DeviceLike = None) -> nn.Module:
    """The port's module of ``spec`` (the JAX zoo's spec) holding the flax
    ``variables`` (``{"params": {...}}`` or the params dict itself, nested
    dicts of arrays), on ``device``. Every flax leaf must land on exactly
    one torch parameter: a missing or extra leaf raises ``ValueError``."""
    params = variables.get("params", variables)
    spec = dict(spec)
    if spec["type"] == "mlp" and "in_features" not in spec:
        first = "dense_0" if "dense_0" in params else "head"
        spec["in_features"] = int(np.shape(params[first]["kernel"])[0])
    module = networks.make_network(spec, device)
    state: Dict[str, np.ndarray] = {}
    used = set()

    def leaf(path):
        node = params
        for p in path:
            if not isinstance(node, dict) or p not in node:
                raise ValueError(f"flax variables lack {'/'.join(path)}")
            node = node[p]
        used.add(tuple(path))
        return np.array(node, dtype=np.float32)   # a writable copy

    for name, mod in module.named_modules():
        for kind, pairs in _FLAX_LEAVES.items():
            if isinstance(mod, kind):
                path = name.split(".")
                for flax_name, torch_name in pairs:
                    arr = leaf(path + [flax_name])
                    state[f"{name}.{torch_name}"] = \
                        arr.T if flax_name == "kernel" else arr
    for name, _ in module.named_parameters(recurse=False):
        state[name] = leaf([name])

    def leaves(node, path=()):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from leaves(v, path + (k,))
        else:
            yield path
    extra = sorted("/".join(p) for p in leaves(params) if p not in used)
    if extra:
        raise ValueError(f"flax variables hold leaves the {spec['type']} "
                         f"module has no place for: {extra}")
    with torch.no_grad():
        module.load_state_dict(
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in state.items()}, strict=True)
    return module
