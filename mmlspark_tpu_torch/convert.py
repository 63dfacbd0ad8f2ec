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
# is (in, out) in flax and (out, in) in torch, a Conv kernel HWIO in flax
# and OIHW in torch
_FLAX_LEAVES = {nn.Linear: (("kernel", "weight"), ("bias", "bias")),
                nn.LayerNorm: (("scale", "weight"), ("bias", "bias")),
                nn.Embedding: (("embedding", "weight"),),
                networks.BatchNorm: (("scale", "weight"), ("bias", "bias"))}
_BN_STATS = (("mean", "running_mean"), ("var", "running_var"))
_GATES = ("i", "f", "g", "o")       # flax's and torch's LSTM gate order


def _flax_sizes(spec: Dict[str, Any], params: Dict[str, Any]
                ) -> Dict[str, Any]:
    """``spec`` with the sizes flax inferred at init (which torch must know
    to allocate) read from the weights; keys the spec has are kept."""
    spec = dict(spec)
    kind = spec["type"]

    def fan_in(name: str, axis: int = 0) -> int:
        return int(np.shape(params[name]["kernel"])[axis])

    if kind == "mlp":
        spec.setdefault("in_features",
                        fan_in("dense_0" if "dense_0" in params else "head"))
    elif kind == "convnet":
        if "conv_0" in params:
            spec.setdefault("in_channels", fan_in("conv_0", 2))
        spec.setdefault("flat_features",
                        fan_in("dense_0" if "dense_0" in params else "head"))
    elif kind == "resnet":
        spec.setdefault("in_channels", fan_in("stem", 2))
    return spec


def module_from_flax(spec: Dict[str, Any], variables: Dict[str, Any],
                     device: DeviceLike = None) -> nn.Module:
    """The port's module of ``spec`` (the JAX zoo's spec) holding the flax
    ``variables`` (``{"params": ..., "batch_stats": ...}`` or the params
    dict itself, nested dicts of arrays), on ``device``. Every flax leaf,
    ``batch_stats`` included, must land on exactly one torch parameter or
    buffer: a missing or extra leaf raises ``ValueError``. BatchNorm's
    ``scale`` / ``bias`` become its weight and bias, its ``batch_stats``
    ``mean`` / ``var`` its running buffers; an LSTM cell's gate kernels
    stack into torch's fused layout."""
    if "params" in variables:
        collections = dict(variables)
        unknown = sorted(set(collections) - {"params", "batch_stats"})
        if unknown:
            raise ValueError(f"flax variables hold collections the port "
                             f"has no place for: {unknown}")
    else:
        collections = {"params": variables}
    params = collections["params"]
    collections.setdefault("batch_stats", {})
    module = networks.make_network(_flax_sizes(spec, params), device)
    state: Dict[str, np.ndarray] = {}
    used = set()

    def leaf(path, collection="params"):
        node = collections[collection]
        for p in path:
            if not isinstance(node, dict) or p not in node:
                raise ValueError(f"flax variables lack {collection}/"
                                 f"{'/'.join(path)}")
            node = node[p]
        used.add((collection,) + tuple(path))
        return np.array(node, dtype=np.float32)   # a writable copy

    for name, mod in module.named_modules():
        path = name.split(".") if name else []
        if isinstance(mod, networks.Conv):
            state[f"{name}.weight"] = leaf(path + ["kernel"]).transpose(
                3, 2, 0, 1)
            if mod.bias is not None:
                state[f"{name}.bias"] = leaf(path + ["bias"])
            continue
        if isinstance(mod, networks.LSTMCell):
            state[f"{name}.weight_ih"] = np.concatenate(
                [leaf(path + ["i" + g, "kernel"]).T for g in _GATES])
            state[f"{name}.weight_hh"] = np.concatenate(
                [leaf(path + ["h" + g, "kernel"]).T for g in _GATES])
            state[f"{name}.bias_hh"] = np.concatenate(
                [leaf(path + ["h" + g, "bias"]) for g in _GATES])
            continue
        for kind, pairs in _FLAX_LEAVES.items():
            if isinstance(mod, kind):
                for flax_name, torch_name in pairs:
                    arr = leaf(path + [flax_name])
                    state[f"{name}.{torch_name}"] = \
                        arr.T if flax_name == "kernel" else arr
        if isinstance(mod, networks.BatchNorm):
            for flax_name, torch_name in _BN_STATS:
                state[f"{name}.{torch_name}"] = leaf(path + [flax_name],
                                                     "batch_stats")
    for name, _ in module.named_parameters(recurse=False):
        state[name] = leaf([name])

    def leaves(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from leaves(v, path + (k,))
        else:
            yield path
    extra = sorted("/".join(p) for c, tree in collections.items()
                   for p in leaves(tree, (c,)) if p not in used)
    if extra:
        raise ValueError(f"flax variables hold leaves the {spec['type']} "
                         f"module has no place for: {extra}")
    with torch.no_grad():
        module.load_state_dict(
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in state.items()}, strict=True)
    return module
