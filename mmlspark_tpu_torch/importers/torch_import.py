"""torch state_dict -> flax-layout variables importer of the PyTorch port
(see ``mmlspark_tpu/importers/torch_import.py``).

Weights trained outside this framework become the flax-layout variables
tree of the zoo's network specs (``models/networks.build_network``): the
same nested dicts of float32 numpy arrays, under the same names, that the
JAX package's importer returns, so ``LocalRepo.publish`` stores them in
the format both packages read, and ``convert.module_from_flax`` /
``ImageFeaturizer`` run them here (ref: CNTKModel.scala:147,
ModelDownloader.scala:209).

Layout conversions (torch -> flax):
  - Conv2d weight  (O, I, kH, kW) -> kernel (kH, kW, I, O)
  - Linear weight  (O, I)         -> kernel (I, O)
  - BatchNorm weight/bias         -> scale/bias params;
    running_mean/running_var      -> batch_stats mean/var
  - Embedding weight              -> embedding (unchanged)

Name conventions accepted per family:
  - resnet: torchvision naming — ``conv1``/``bn1`` stem,
    ``layer{s+1}.{b}.conv1/bn1/conv2/bn2[/downsample.0/.1]``, ``fc``
    head (``import_torchvision_resnet`` validates a resnet18/34 file
    against the exact key/shape manifest; .pth and .safetensors both
    load — see load_checkpoint_file).
  - convnet: ``conv{i}``, ``dense{i}``, ``head``.
  - mlp: ``dense{i}``, ``head``.
  - bilstm: ``embed``, ``lstm`` (bidirectional), ``head``.
  - transformer: GPT-2-shaped blocks (``_import_transformer``).

Where the port departs from the JAX package's code: a bfloat16 tensor
(in a .pth or a BF16 .safetensors entry) is widened to float32 by torch
(the JAX package reads BF16 safetensors through ``ml_dtypes``, which
ships with jax), and ``validate_input_shape`` checks the tree against
the port module's parameter names and shapes
(``convert.check_flax_variables``) where the JAX package inits a flax
module.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from mmlspark_tpu_torch import convert


def _to_numpy(t: Any) -> np.ndarray:
    if isinstance(t, torch.Tensor):   # bfloat16 has no numpy dtype
        t = t.detach().cpu().to(torch.float32).numpy()
    return np.asarray(t, dtype=np.float32)


def _conv_kernel(t: Any) -> np.ndarray:
    """torch OIHW -> flax HWIO."""
    return np.transpose(_to_numpy(t), (2, 3, 1, 0))


def _linear_kernel(t: Any) -> np.ndarray:
    """torch (out, in) -> flax (in, out)."""
    return np.transpose(_to_numpy(t))


def load_torch_file(path: str) -> Dict[str, Any]:
    """Load a .pt/.pth checkpoint to a flat state_dict (CPU tensors)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj


_SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}


def load_safetensors_file(path: str) -> Dict[str, np.ndarray]:
    """Dependency-free safetensors reader (the format hugging-face zoo
    checkpoints ship in): u64-LE header length, JSON header mapping
    tensor name -> {dtype, shape, data_offsets}, then raw little-endian
    tensor bytes. BF16 decodes through torch's bfloat16."""
    import json
    import struct
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode("utf-8"))
        blob = f.read()
    out: Dict[str, np.ndarray] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        lo, hi = meta["data_offsets"]
        dt = meta["dtype"]
        if dt == "BF16":
            bits = np.frombuffer(blob[lo:hi], dtype=np.int16).copy()
            arr = torch.from_numpy(bits).view(torch.bfloat16).float().numpy()
        elif dt in _SAFETENSORS_DTYPES:
            arr = np.frombuffer(blob[lo:hi], dtype=_SAFETENSORS_DTYPES[dt])
        else:
            raise ValueError(f"unsupported safetensors dtype {dt!r}")
        if dt in ("F16", "BF16"):
            out[name] = arr.reshape(meta["shape"]).astype(np.float32)
        else:
            # frombuffer views are read-only; downstream in-place edits
            # of imported tensors would raise — hand out owned arrays
            out[name] = arr.reshape(meta["shape"]).copy()
    return out


def load_checkpoint_file(path: str) -> Dict[str, Any]:
    """Extension-dispatched checkpoint reader: .safetensors or torch
    .pt/.pth/.bin."""
    if path.endswith(".safetensors"):
        return load_safetensors_file(path)
    return load_torch_file(path)


class _TreeBuilder:
    """Accumulates nested params/batch_stats trees and tracks which
    state_dict keys were consumed (unused keys are an import error —
    silent drops are how weight-porting bugs hide)."""

    def __init__(self, sd: Dict[str, Any]):
        self.sd = dict(sd)
        self.used: set = set()
        self.params: Dict[str, Any] = {}
        self.stats: Dict[str, Any] = {}

    def take(self, key: str) -> Any:
        if key not in self.sd:
            raise KeyError(
                f"torch checkpoint is missing {key!r}; available keys "
                f"include {sorted(self.sd)[:8]}...")
        self.used.add(key)
        return self.sd[key]

    def has(self, key: str) -> bool:
        return key in self.sd

    def _set(self, tree: Dict[str, Any], path: List[str], val: np.ndarray):
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = val

    def conv(self, flax_path: List[str], torch_name: str,
             bias: bool = False):
        self._set(self.params, flax_path + ["kernel"],
                  _conv_kernel(self.take(f"{torch_name}.weight")))
        if bias:
            self._set(self.params, flax_path + ["bias"],
                      _to_numpy(self.take(f"{torch_name}.bias")))

    def linear(self, flax_path: List[str], torch_name: str):
        self._set(self.params, flax_path + ["kernel"],
                  _linear_kernel(self.take(f"{torch_name}.weight")))
        self._set(self.params, flax_path + ["bias"],
                  _to_numpy(self.take(f"{torch_name}.bias")))

    def layernorm(self, flax_path: List[str], torch_name: str):
        self._set(self.params, flax_path + ["scale"],
                  _to_numpy(self.take(f"{torch_name}.weight")))
        self._set(self.params, flax_path + ["bias"],
                  _to_numpy(self.take(f"{torch_name}.bias")))

    def batchnorm(self, flax_path: List[str], torch_name: str):
        self._set(self.params, flax_path + ["scale"],
                  _to_numpy(self.take(f"{torch_name}.weight")))
        self._set(self.params, flax_path + ["bias"],
                  _to_numpy(self.take(f"{torch_name}.bias")))
        self._set(self.stats, flax_path + ["mean"],
                  _to_numpy(self.take(f"{torch_name}.running_mean")))
        self._set(self.stats, flax_path + ["var"],
                  _to_numpy(self.take(f"{torch_name}.running_var")))

    def finish(self, strict: bool = True) -> Dict[str, Any]:
        if strict:
            unused = [k for k in self.sd
                      if k not in self.used
                      and not k.endswith("num_batches_tracked")]
            if unused:
                raise ValueError(
                    f"torch checkpoint keys not consumed by the import "
                    f"(shape/name mismatch?): {sorted(unused)}")
        out: Dict[str, Any] = {"params": self.params}
        if self.stats:
            out["batch_stats"] = self.stats
        return out


def _import_resnet(sd: Dict[str, Any], spec: Dict[str, Any],
                   strict: bool,
                   input_shape: Optional[List[int]]) -> Dict[str, Any]:
    b = _TreeBuilder(sd)
    b.conv(["stem"], "conv1")
    b.batchnorm(["BatchNorm_0"], "bn1")
    stage_sizes = list(spec.get("stage_sizes", (3, 3, 3)))
    for s, n_blocks in enumerate(stage_sizes):
        for blk in range(n_blocks):
            t = f"layer{s + 1}.{blk}"
            fx = f"stage{s}_block{blk}"
            b.conv([fx, "Conv_0"], f"{t}.conv1")
            b.batchnorm([fx, "BatchNorm_0"], f"{t}.bn1")
            b.conv([fx, "Conv_1"], f"{t}.conv2")
            b.batchnorm([fx, "BatchNorm_1"], f"{t}.bn2")
            if b.has(f"{t}.downsample.0.weight"):
                b.conv([fx, "proj"], f"{t}.downsample.0")
                b.batchnorm([fx, "BatchNorm_2"], f"{t}.downsample.1")
    b.linear(["head"], "fc")
    return b.finish(strict)


def _import_convnet(sd: Dict[str, Any], spec: Dict[str, Any],
                    strict: bool,
                    input_shape: Optional[List[int]]) -> Dict[str, Any]:
    b = _TreeBuilder(sd)
    conv_features = list(spec.get("conv_features", (64, 64, 64)))
    pool_every = int(spec.get("pool_every", 1))
    for i in range(len(conv_features)):
        b.conv([f"conv_{i}"], f"conv{i}", bias=True)
    for i in range(len(spec.get("dense_features", (256,)))):
        b.linear([f"dense_{i}"], f"dense{i}")
    b.linear(["head"], "head")
    out = b.finish(strict)

    # flatten-boundary fix: torch flattens NCHW (C,H,W order), flax
    # flattens NHWC (H,W,C order) — permute the input dim of the first
    # Dense after the flatten (dense_0, or the head when there are no
    # dense layers). Needs the conv-stack output spatial shape, so
    # input_shape is mandatory for convnet imports: skipping the
    # permutation would load cleanly and predict garbage.
    if input_shape is None:
        raise ValueError(
            "convnet imports require validate_input_shape (e.g. "
            "[32, 32, 3]): the flatten-boundary NCHW->NHWC kernel "
            "permutation needs the conv-stack output shape")
    h, w, _ = input_shape
    for i in range(len(conv_features)):
        if (i + 1) % pool_every == 0:
            h, w = h // 2, w // 2
    c = conv_features[-1]
    first_dense = "dense_0" if "dense_0" in out["params"] else "head"
    k = out["params"][first_dense]["kernel"]          # (C*H*W, O)
    if k.shape[0] != c * h * w:
        raise ValueError(
            f"{first_dense} kernel input dim {k.shape[0]} != "
            f"C*H*W={c * h * w} from input_shape {input_shape}")
    k = k.reshape(c, h, w, -1).transpose(1, 2, 0, 3).reshape(h * w * c, -1)
    out["params"][first_dense]["kernel"] = k
    return out


def _import_mlp(sd: Dict[str, Any], spec: Dict[str, Any],
                strict: bool,
                input_shape: Optional[List[int]]) -> Dict[str, Any]:
    b = _TreeBuilder(sd)
    for i in range(len(spec.get("features", (256, 128)))):
        b.linear([f"dense_{i}"], f"dense{i}")
    b.linear(["head"], "head")
    return b.finish(strict)


def _import_bilstm(sd: Dict[str, Any], spec: Dict[str, Any],
                   strict: bool,
                   input_shape: Optional[List[int]]) -> Dict[str, Any]:
    """torch bidirectional ``nn.LSTM`` -> BiLSTMTagger variables
    (the notebook-304 pretrained Bi-LSTM ingestion path).

    Expected torch names: ``embed`` (nn.Embedding), ``lstm``
    (nn.LSTM(bidirectional=True, batch_first=True)), ``head``
    (nn.Linear). torch packs gates (i, f, g, o) along dim 0 of
    ``weight_ih/hh``; flax's OptimizedLSTMCell keeps one Dense per gate
    with the bias only on the recurrent half, so torch's two biases are
    summed."""
    h = int(spec.get("hidden", 128))
    b = _TreeBuilder(sd)
    b._set(b.params, ["embed", "embedding"],
           _to_numpy(b.take("embed.weight")))
    # forward cell = OptimizedLSTMCell_0, reverse = _1 (creation order
    # in BiLSTMTagger.__call__)
    for suffix, cell in (("", "OptimizedLSTMCell_0"),
                         ("_reverse", "OptimizedLSTMCell_1")):
        wih = _to_numpy(b.take(f"lstm.weight_ih_l0{suffix}"))   # (4H, E)
        whh = _to_numpy(b.take(f"lstm.weight_hh_l0{suffix}"))   # (4H, H)
        bias = (_to_numpy(b.take(f"lstm.bias_ih_l0{suffix}"))
                + _to_numpy(b.take(f"lstm.bias_hh_l0{suffix}")))
        for gi, gate in enumerate("ifgo"):
            sl = slice(gi * h, (gi + 1) * h)
            b._set(b.params, [cell, f"i{gate}", "kernel"], wih[sl].T)
            b._set(b.params, [cell, f"h{gate}", "kernel"], whh[sl].T)
            b._set(b.params, [cell, f"h{gate}", "bias"], bias[sl])
    b.linear(["head"], "head")
    return b.finish(strict)


def _import_transformer(sd: Dict[str, Any], spec: Dict[str, Any],
                        strict: bool,
                        input_shape: Optional[List[int]]) -> Dict[str, Any]:
    """GPT-2-shaped torch decoder -> Transformer variables.

    Expected torch names (the GPT-2 block structure with fused qkv):
    ``embed`` (nn.Embedding), ``pos_embed`` (nn.Parameter (max_len, D)),
    ``block_{i}.ln1/qkv/proj/ln2/mlp_up/mlp_down``, ``ln_f``, and
    ``lm_head`` (or ``head`` when num_classes > 0). qkv packs q|k|v
    along the output dim, matching TransformerBlock's fused Dense."""
    b = _TreeBuilder(sd)
    b._set(b.params, ["embed", "embedding"],
           _to_numpy(b.take("embed.weight")))
    b._set(b.params, ["pos_embed"], _to_numpy(b.take("pos_embed")))
    for i in range(int(spec.get("depth", 4))):
        t = f"block_{i}"
        for ln in ("ln1", "ln2"):
            b.layernorm([t, ln], f"{t}.{ln}")
        for lin in ("qkv", "proj", "mlp_up", "mlp_down"):
            b.linear([t, lin], f"{t}.{lin}")
    b.layernorm(["ln_f"], "ln_f")
    head = "head" if int(spec.get("num_classes", 0)) > 0 else "lm_head"
    b.linear([head], head)
    return b.finish(strict)


_IMPORTERS = {
    "resnet": _import_resnet,
    "convnet": _import_convnet,
    "mlp": _import_mlp,
    "bilstm": _import_bilstm,
    "transformer": _import_transformer,
}


def import_torch_checkpoint(state_dict: Any, network_spec: Dict[str, Any],
                            strict: bool = True,
                            validate_input_shape: Optional[List[int]] = None
                            ) -> Dict[str, Any]:
    """Convert a torch ``state_dict`` (dict or .pt path) to flax variables
    for ``network_spec`` (a models/networks.build_network spec).

    strict: fail on unconsumed checkpoint keys.
    validate_input_shape: when given (e.g. [32, 32, 3]), verify every
    imported array against the port module's parameter names and shapes
    for rows of that shape. Also required for
    convnet imports (the flatten-boundary NCHW->NHWC permutation of the
    first dense kernel needs the conv-stack output shape).
    """
    if isinstance(state_dict, str):
        state_dict = load_checkpoint_file(state_dict)
    kind = network_spec.get("type")
    if kind not in _IMPORTERS:
        raise NotImplementedError(
            f"no torch importer for network type {kind!r}; "
            f"have {sorted(_IMPORTERS)}")
    variables = _IMPORTERS[kind](state_dict, network_spec, strict,
                                 validate_input_shape)

    if validate_input_shape is not None:
        _validate(variables, network_spec, validate_input_shape)
    return variables


def _validate(variables: Dict[str, Any], network_spec: Dict[str, Any],
              input_shape: List[int]) -> None:
    """The imported tree holds exactly the port module's leaves and
    shapes for ``input_shape`` rows (``ValueError`` naming the missing,
    extra and mis-shaped ones)."""
    convert.check_flax_variables(network_spec, variables, input_shape)


# ---------------------------------------------------------------------------
# published torchvision ImageNet ResNets (BasicBlock family)
# ---------------------------------------------------------------------------

# the exact spec whose zoo network (models/networks.ResNet stem='imagenet')
# reproduces torchvision.models.resnet18 numerics
TORCHVISION_RESNET18_SPEC: Dict[str, Any] = {
    "type": "resnet", "stem": "imagenet", "stage_sizes": [2, 2, 2, 2],
    "width": 64, "num_classes": 1000,
}
TORCHVISION_RESNET34_SPEC: Dict[str, Any] = {
    "type": "resnet", "stem": "imagenet", "stage_sizes": [3, 4, 6, 3],
    "width": 64, "num_classes": 1000,
}


def _torchvision_manifest(stage_sizes: List[int], num_classes: int
                          ) -> Dict[str, tuple]:
    """Key -> shape manifest of a torchvision BasicBlock ResNet
    state_dict (the published resnet18/34 layout: ``conv1``/``bn1``
    stem, ``layer{1-4}.{b}.conv1/bn1/conv2/bn2[.downsample.0/.1]``,
    ``fc``; ref: ModelDownloader.scala:209 — zoo ingestion is anchored
    on real published checkpoints)."""
    m: Dict[str, tuple] = {"conv1.weight": (64, 3, 7, 7)}
    for tag, c in (("bn1", 64),):
        m[f"{tag}.weight"] = (c,)
        m[f"{tag}.bias"] = (c,)
        m[f"{tag}.running_mean"] = (c,)
        m[f"{tag}.running_var"] = (c,)
    cin = 64
    for s, n_blocks in enumerate(stage_sizes):
        cout = 64 * (2 ** s)
        for blk in range(n_blocks):
            t = f"layer{s + 1}.{blk}"
            stride_block = blk == 0 and s > 0
            m[f"{t}.conv1.weight"] = (cout, cin if blk == 0 else cout,
                                      3, 3)
            m[f"{t}.conv2.weight"] = (cout, cout, 3, 3)
            for bn in ("bn1", "bn2"):
                for suffix in ("weight", "bias", "running_mean",
                               "running_var"):
                    m[f"{t}.{bn}.{suffix}"] = (cout,)
            if blk == 0 and (stride_block or cin != cout):
                m[f"{t}.downsample.0.weight"] = (cout, cin, 1, 1)
                for suffix in ("weight", "bias", "running_mean",
                               "running_var"):
                    m[f"{t}.downsample.1.{suffix}"] = (cout,)
        cin = cout
    m["fc.weight"] = (num_classes, cin)
    m["fc.bias"] = (num_classes,)
    return m


def import_torchvision_resnet(source: Any,
                              spec: Optional[Dict[str, Any]] = None
                              ) -> Dict[str, Any]:
    """Import a PUBLISHED torchvision BasicBlock-ResNet checkpoint
    (resnet18 by default; pass TORCHVISION_RESNET34_SPEC for resnet34).

    ``source`` is a state_dict, .pth, or .safetensors path. The
    checkpoint is validated against the torchvision key/shape manifest
    BEFORE conversion, so a wrong or truncated download fails with the
    offending keys rather than a cryptic import error. Returns the
    flax-layout variables of ``spec`` — run them through
    ``convert.module_from_flax`` / ImageFeaturizer like any zoo model
    (examples/301, 305)."""
    spec = dict(spec or TORCHVISION_RESNET18_SPEC)
    if isinstance(source, str):
        source = load_checkpoint_file(source)
    manifest = _torchvision_manifest(list(spec["stage_sizes"]),
                                     int(spec["num_classes"]))
    got = {k: tuple(np.asarray(_to_numpy(v)).shape)
           for k, v in source.items()
           if not k.endswith("num_batches_tracked")}
    missing = sorted(set(manifest) - set(got))
    extra = sorted(set(got) - set(manifest))
    bad = [(k, got[k], manifest[k]) for k in got
           if k in manifest and got[k] != manifest[k]]
    if missing or extra or bad:
        raise ValueError(
            f"not a torchvision ResNet{'18' if spec['stage_sizes'] == [2, 2, 2, 2] else ''} "
            f"state_dict:\n  missing: {missing[:6]}\n"
            f"  unexpected: {extra[:6]}\n"
            f"  shape mismatches (key, got, want): {bad[:6]}")
    return import_torch_checkpoint(source, spec, strict=True,
                                   validate_input_shape=[224, 224, 3])
