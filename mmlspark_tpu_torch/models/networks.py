"""Network zoo of the PyTorch port (see ``mmlspark_tpu/models/networks.py``).

The same modules, spec keys and parameter names as the flax zoo, as
``torch.nn.Module``s: ``MLP`` and the decoder-only ``Transformer`` (with
``TransformerBlock``). ``dtype`` is the compute type and ``head_dtype``
the output head's, as in flax: parameters stay float32 and each dense
layer casts its input, kernel and bias to the compute type. Every module
names its intermediate activations in ``feature_layers()``; pass
``capture=<name>`` to ``forward`` to get one instead of the head output.

``build_network(spec, device=None, seed=0)`` builds a module from the
JAX package's JSON-able spec and draws its weights from ``seed`` with
the distributions of flax's defaults: Dense kernels lecun-normal
(truncated normal), biases zero, embeddings normal with variance
1 / features, the positional table normal(0.02), LayerNorm ones and
zeros. The draws are torch's, so they do not repeat flax's numbers; to
run the JAX package's weights, use ``convert.module_from_flax``.

``make_network`` returns a module in inference mode; ``.train()`` (the
learner) turns on the ``MLP``'s dropout, drawn from the module's
``dropout_generator`` (an explicit ``torch.Generator``; its bits cannot
repeat flax's). The ``Transformer`` has no dropout in either package.

Not ported yet, and raising ``NotImplementedError``: ``seq_axis``
(ROADMAP.md, 'Long context') and the ``convnet`` / ``resnet`` /
``bilstm`` types (ROADMAP.md, 'Zoo networks beyond Transformer/MLP').
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch.device import DeviceLike, resolve_device
from mmlspark_tpu_torch.parallel import ring_attention as ra

LN_EPS = 1e-6             # flax LayerNorm's epsilon
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(d: Any) -> torch.dtype:
    if isinstance(d, torch.dtype) and d in _DTYPES.values():
        return d
    if isinstance(d, str) and d in _DTYPES:
        return _DTYPES[d]
    raise ValueError(f"dtype {d!r} not supported; use one of "
                     f"{sorted(_DTYPES)}")


def _dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype
           ) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: input, kernel and bias in ``dtype``."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def _norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype
          ) -> torch.Tensor:
    """flax ``LayerNorm(dtype=...)``: statistics in at least float32."""
    return ln(x.float()).to(dtype)


class MLP(nn.Module):
    """Plain MLP over flat feature vectors. ``in_features`` is the input
    width, which flax infers at init and torch must know to allocate;
    ``convert.module_from_flax`` reads it from the weights. In train mode,
    ``dropout > 0`` zeroes each hidden activation with that probability
    and scales the rest by ``1 / (1 - dropout)``, as flax's ``Dropout``,
    with bits from ``dropout_generator`` (torch's default generator when
    it is None)."""

    int_input = False

    def __init__(self, features: Sequence[int] = (256, 128),
                 num_classes: int = 10, dtype: Any = "float32",
                 dropout: float = 0.0, in_features: Optional[int] = None):
        super().__init__()
        if in_features is None:
            raise ValueError(
                "an MLP spec needs 'in_features' in the PyTorch port (flax "
                "infers it at init); convert.module_from_flax reads it "
                "from the weights")
        self.features = tuple(features)
        self.num_classes = num_classes
        self.dtype = _dtype(dtype)
        self.dropout = dropout
        self.dropout_generator: Optional[torch.Generator] = None
        width = in_features
        for i, f in enumerate(self.features):
            self.add_module(f"dense_{i}", nn.Linear(width, f))
            width = f
        self.head = nn.Linear(width, num_classes)

    def forward(self, x: torch.Tensor, capture: Optional[str] = None
                ) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(len(self.features)):
            x = F.relu(_dense(x, getattr(self, f"dense_{i}"), self.dtype))
            if self.training and self.dropout > 0:
                x = self._drop(x)
            if capture == f"dense_{i}":
                return x
        return _dense(x, self.head, torch.float32)

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        keep = 1.0 - self.dropout
        if keep <= 0.0:
            return torch.zeros_like(x)      # flax's rate 1.0
        u = torch.rand(x.shape, generator=self.dropout_generator,
                       device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))

    def feature_layers(self) -> List[str]:
        return [f"dense_{i}" for i in range(len(self.features))]


class TransformerBlock(nn.Module):
    """Pre-LN decoder block. Attention goes through
    ``ring_attention.attention``: the flash kernel at L >= 512."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 causal: bool = True, seq_axis: Optional[str] = None,
                 seq_impl: str = "ring", dtype: Any = "float32"):
        super().__init__()
        if seq_axis is not None:
            raise NotImplementedError(
                "seq_axis (sequence-sharded attention) is not ported yet: "
                "ROADMAP.md, 'Long context'")
        self.dim, self.heads, self.causal = dim, heads, causal
        self.dtype = _dtype(dtype)
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp_up = nn.Linear(dim, mlp_ratio * dim)
        self.mlp_down = nn.Linear(mlp_ratio * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        h = self.heads
        hd = self.dim // h
        qkv = _dense(_norm(x, self.ln1, self.dtype), self.qkv, self.dtype)
        # flax's jnp.split(qkv, 3, -1) + (b, l, h, hd) reshape; views of
        # the projection, which the flash kernel reads through strides
        q, k, v = (t.view(b, l, h, hd) for t in qkv.split(self.dim, dim=-1))
        attn = ra.attention(q, k, v, causal=self.causal)
        x = x + _dense(attn.reshape(b, l, self.dim), self.proj, self.dtype)
        y = _dense(_norm(x, self.ln2, self.dtype), self.mlp_up, self.dtype)
        y = F.gelu(y, approximate="tanh")      # flax nn.gelu's default
        return x + _dense(y, self.mlp_down, self.dtype)


class Transformer(nn.Module):
    """Decoder-only transformer LM / sequence classifier."""

    int_input = True  # consumes token ids, not float features

    def __init__(self, vocab_size: int = 32000, dim: int = 256,
                 depth: int = 4, heads: int = 8, max_len: int = 2048,
                 num_classes: int = 0, causal: bool = True,
                 seq_axis: Optional[str] = None, seq_impl: str = "ring",
                 dtype: Any = "float32", head_dtype: Any = "float32"):
        super().__init__()
        if seq_axis is not None:
            raise NotImplementedError(
                "seq_axis (sequence-sharded attention) is not ported yet: "
                "ROADMAP.md, 'Long context'")
        self.vocab_size, self.dim, self.depth = vocab_size, dim, depth
        self.max_len, self.num_classes = max_len, num_classes
        self.dtype, self.head_dtype = _dtype(dtype), _dtype(head_dtype)
        self.embed = nn.Embedding(vocab_size, dim)
        self.pos_embed = nn.Parameter(torch.empty(max_len, dim))
        for i in range(depth):
            self.add_module(f"block_{i}", TransformerBlock(
                dim, heads, causal=causal, dtype=dtype))
        self.ln_f = nn.LayerNorm(dim, eps=LN_EPS)
        if num_classes > 0:
            self.head = nn.Linear(dim, num_classes)
        else:
            self.lm_head = nn.Linear(dim, vocab_size)

    def forward(self, tokens: torch.Tensor, capture: Optional[str] = None
                ) -> torch.Tensor:
        b, l = tokens.shape
        if l > self.max_len:
            raise ValueError(f"sequence {l} exceeds max_len={self.max_len}")
        x = F.embedding(tokens.long(), self.embed.weight.to(self.dtype))
        x = x + self.pos_embed[:l][None].to(self.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
            if capture == f"block_{i}":
                return x
        x = _norm(x, self.ln_f, self.dtype)
        if capture == "final":
            return x
        if self.num_classes > 0:
            # classify from the mean token representation
            return _dense(x.mean(dim=1), self.head, self.head_dtype)
        return _dense(x, self.lm_head, self.head_dtype)

    def feature_layers(self) -> List[str]:
        return [f"block_{i}" for i in range(self.depth)] + ["final"]


# ---------------------------------------------------------------------------
# seeded initialization with flax's default distributions
# ---------------------------------------------------------------------------

# lecun_normal: a standard normal truncated to [-2, 2], scaled so its
# variance is 1 / fan_in (jax.nn.initializers.variance_scaling)
_TRUNC = 2.0
_TRUNC_STD = 0.87962566103423978    # std of N(0, 1) truncated to [-2, 2]


def _trunc_normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    lo = math.erf(-_TRUNC / math.sqrt(2.0))
    t.uniform_(lo, -lo, generator=g)
    t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-_TRUNC, _TRUNC).mul_(std)


@torch.no_grad()
def init_weights(module: nn.Module, seed: int = 0) -> nn.Module:
    """Draw every weight of ``module`` from ``seed`` on the module's
    device, in a fixed order, with flax's default initializers."""
    dev = next(module.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    for mod in module.modules():
        if isinstance(mod, nn.Linear):
            _trunc_normal_(mod.weight, (1.0 / mod.in_features) ** 0.5
                           / _TRUNC_STD, g)
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, mod.embedding_dim ** -0.5, generator=g)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    if isinstance(module, Transformer):
        module.pos_embed.normal_(0.0, 0.02, generator=g)
    return module


# ---------------------------------------------------------------------------
# registry + spec construction
# ---------------------------------------------------------------------------

def _not_ported(kind: str) -> Callable[..., nn.Module]:
    def build(**_):
        raise NotImplementedError(
            f"network type {kind!r} is not ported yet: ROADMAP.md, 'Zoo "
            "networks beyond Transformer/MLP'")
    return build


NETWORK_REGISTRY: Dict[str, Callable[..., nn.Module]] = {
    "mlp": MLP,
    "convnet": _not_ported("convnet"),
    "resnet": _not_ported("resnet"),
    "bilstm": _not_ported("bilstm"),
    "transformer": Transformer,
}


def make_network(spec: Dict[str, Any], device: DeviceLike = None
                 ) -> nn.Module:
    """The module of ``spec`` on ``device`` in inference mode (``.train()``
    turns on training mode), built in
    place there; its weights hold torch's default draws until
    ``init_weights`` or ``convert.module_from_flax`` fill them. (Built on
    the meta device instead, the first build in a process pays seconds of
    one-time set-up.)"""
    spec = dict(spec)
    kind = spec.pop("type")
    if kind not in NETWORK_REGISTRY:
        raise KeyError(f"unknown network type {kind!r}; "
                       f"have {sorted(NETWORK_REGISTRY)}")
    dev = resolve_device(device)
    with dev:
        module = NETWORK_REGISTRY[kind](**spec)
    return module.eval()


def build_network(spec: Dict[str, Any], device: DeviceLike = None,
                  seed: int = 0) -> nn.Module:
    """Build a module from a JSON-able spec (the JAX package's keys),
    with weights drawn from ``seed``. Example::

        {"type": "transformer", "vocab_size": 32000, "dim": 2048,
         "depth": 8, "heads": 16, "max_len": 1024,
         "head_dtype": "bfloat16"}
    """
    return init_weights(make_network(spec, device), seed)
