"""Network zoo of the PyTorch port (see ``mmlspark_tpu/models/networks.py``).

The same modules, spec keys and parameter names as the flax zoo, as
``torch.nn.Module``s: ``MLP``, the CIFAR ``ConvNet``, ``ResNet`` (with
``ResNetBlock``; the ``'cifar'`` and ``'imagenet'`` stems), the
``BiLSTMTagger`` and the decoder-only ``Transformer`` (with
``TransformerBlock``). ``dtype`` is the compute type and ``head_dtype``
the output head's, as in flax: parameters stay float32 and each dense or
conv layer casts its input, kernel and bias to the compute type. Every
module names its intermediate activations in ``feature_layers()``; pass
``capture=<name>`` to ``forward`` to get one instead of the head output.

Image networks take NHWC input, as the flax zoo does, and return NHWC
activations from ``capture``. Inside they run on the NCHW view of it
(``permute``, no copy), which is ``torch.channels_last`` in memory: the
layout cuDNN's tensor-core convolutions want. The ConvNet flattens in
NHWC order before ``dense_0``, so a flax ``dense_0`` kernel loads as it
is. Padding is explicit: flax's ``'SAME'`` puts the odd pad of an even
kernel at the end, which torch's symmetric ``padding=`` cannot.

Sizes that flax infers from the input at init are spec keys here:
``in_features`` (MLP), ``in_channels`` and ``flat_features`` (ConvNet;
without them, a 32 x 32 x 3 input), ``in_channels`` (ResNet; default 3).
``sized_spec(spec, row_shape)`` fills them in from a row's shape (the
learner does); ``convert.module_from_flax`` reads them from the weights.

``BatchNorm`` is flax's: momentum 0.99, epsilon 1e-5, the biased batch
variance taken as E[x^2] - E[x]^2 in at least float32. In train mode it
normalizes with the batch statistics and updates its running buffers in
place on the device; in eval mode it reads them. cuDNN runs float32
convolutions and RNNs in TF32 unless told not to, so every forward here
runs under ``strict_f32()`` (the learner's backward too).

``build_network(spec, device=None, seed=0)`` builds a module from the
JAX package's JSON-able spec and draws its weights from ``seed`` with
the distributions of flax's defaults: Dense and Conv kernels lecun-normal
(truncated normal over the fan-in), biases zero, embeddings normal with
variance 1 / features, the positional table normal(0.02), LayerNorm and
BatchNorm ones and zeros (the second BatchNorm of a ``ResNetBlock`` has
scale zeros), LSTM input kernels lecun-normal and recurrent kernels
orthogonal, gate by gate. The draws are torch's, so they do not repeat
flax's numbers; to run the JAX package's weights, use
``convert.module_from_flax``.

``make_network`` returns a module in inference mode; ``.train()`` (the
learner) turns on the ``MLP``'s and ``ConvNet``'s dropout, drawn from
the module's ``dropout_generator`` (an explicit ``torch.Generator``; its
bits cannot repeat flax's), and BatchNorm's batch statistics. The
``Transformer`` has no dropout in either package.

Not ported yet, and raising ``NotImplementedError``: ``seq_axis``
(ROADMAP.md, 'Long context').
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, \
    Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch.device import DeviceLike, resolve_device
from mmlspark_tpu_torch.parallel import ring_attention as ra

LN_EPS = 1e-6             # flax LayerNorm's epsilon
BN_MOMENTUM = 0.99        # flax BatchNorm's defaults
BN_EPS = 1e-5
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(d: Any) -> torch.dtype:
    if isinstance(d, torch.dtype) and d in _DTYPES.values():
        return d
    if isinstance(d, str) and d in _DTYPES:
        return _DTYPES[d]
    raise ValueError(f"dtype {d!r} not supported; use one of "
                     f"{sorted(_DTYPES)}")


# the interceptor of one forward, set by core/quantize.py (calibration, or
# an int8 model's forward): called as hook(x, lin, dtype), it returns the
# layer's output, or None for the float path. Every dense layer of the
# zoo goes through _dense, as every flax one through nn.Dense.
DENSE_HOOK: contextvars.ContextVar = contextvars.ContextVar(
    "dense_hook", default=None)


def _dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype
           ) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: input, kernel and bias in ``dtype``."""
    hook = DENSE_HOOK.get()
    if hook is not None:
        out = hook(x, lin, dtype)
        if out is not None:
            return out
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def _norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype
          ) -> torch.Tensor:
    """flax ``LayerNorm(dtype=...)``: statistics in at least float32."""
    return ln(x.float()).to(dtype)


def _dropout(x: torch.Tensor, rate: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``Dropout``: zero with probability ``rate``, scale the rest by
    ``1 / (1 - rate)``; bits from ``generator``."""
    keep = 1.0 - rate
    if keep <= 0.0:
        return torch.zeros_like(x)      # flax's rate 1.0
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


# cuDNN's float32 convolutions and RNNs: torch lets them run in TF32 by
# default (``torch.backends.cudnn.allow_tf32``, unlike its matmul flag).
# The flag is global, so the regions are counted: it is off while any
# region of any thread is open and comes back when the last one closes.
_STRICT = threading.Lock()
_strict_open = 0
_strict_saved = True


@contextlib.contextmanager
def strict_f32() -> Iterator[None]:
    """Run cuDNN's float32 convolutions and RNNs in IEEE float32 (TF32
    off) inside the block; the caller's setting is restored after it.
    bfloat16 work is unaffected."""
    global _strict_open, _strict_saved
    with _STRICT:
        if _strict_open == 0:
            _strict_saved = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
        _strict_open += 1
    try:
        yield
    finally:
        with _STRICT:
            _strict_open -= 1
            if _strict_open == 0:
                torch.backends.cudnn.allow_tf32 = _strict_saved


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
                x = _dropout(x, self.dropout, self.dropout_generator)
            if capture == f"dense_{i}":
                return x
        return _dense(x, self.head, torch.float32)

    def feature_layers(self) -> List[str]:
        return [f"dense_{i}" for i in range(len(self.features))]


def _same_pads(kernel: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """XLA's ``'SAME'`` at stride 1: ``k - 1`` in all per spatial dim, the
    odd one at the end."""
    return tuple(((k - 1) // 2, k - 1 - (k - 1) // 2) for k in kernel)


class Conv(nn.Conv2d):
    """flax ``Conv`` over NCHW activations: explicit ``(lo, hi)`` pads per
    spatial dim (``'SAME'`` when None), and the input, kernel and bias
    cast to the compute type. The kernel is OIHW, flax's is HWIO."""

    def __init__(self, in_channels: int, features: int,
                 kernel: Sequence[int], stride: int = 1,
                 pads: Optional[Sequence[Tuple[int, int]]] = None,
                 bias: bool = True):
        super().__init__(in_channels, features, tuple(kernel), stride,
                         padding=0, bias=bias)
        self.pads = tuple(map(tuple, pads)) if pads is not None \
            else _same_pads(self.kernel_size)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        (top, bottom), (left, right) = self.pads
        ph, pw = min(top, bottom), min(left, right)
        x = x.to(dtype)
        if (top, left) != (bottom, right):
            # the asymmetric rest, zeros as XLA pads; cuDNN takes the rest
            x = F.pad(x, (left - pw, right - pw, top - ph, bottom - ph))
        y = F.conv2d(x, self.weight.to(dtype), None, self.stride, (ph, pw))
        if self.bias is None:
            return y
        # flax adds the bias to the rounded product, in the compute type
        return y + self.bias.to(dtype)[:, None, None]


class _BatchNormTrain(torch.autograd.Function):
    """flax's train-mode BatchNorm over the channels of NCHW ``x``, as one
    autograd node: the batch mean and biased variance E[x^2] - E[x]^2
    (clipped at 0) in float32, ``y = (x - mean) * rstd * scale + bias``
    cast to ``x``'s type, and the closed-form gradient of that function
    (the chain rule through the statistics, which JAX's autodiff takes
    step by step). Returns ``(y, mean, var)``; mean and var take no
    gradient. The arithmetic runs on the NHWC view, where the channel
    is the innermost dim of a channels_last tensor: per-channel vectors
    broadcast along it and the reductions run over the leading dims."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.set_materialize_grads(False)     # mean and var take none
        x32 = _nhwc(x).float()
        mean = x32.mean(dim=(0, 1, 2))
        var = torch.clamp((x32 * x32).mean(dim=(0, 1, 2)) - mean * mean,
                          min=0.0)
        rstd = torch.rsqrt(var + BN_EPS)
        y = (x32 - mean) * (rstd * weight) + bias
        ctx.save_for_backward(x, mean, rstd, weight)
        ctx.mark_non_differentiable(mean, var)
        return _nchw_view(y.to(x.dtype)), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        if dy is None:
            return None, None, None
        x, mean, rstd, weight = ctx.saved_tensors
        n = x.numel() // x.shape[1]
        dy32 = _nhwc(dy).float()
        xhat = (_nhwc(x).float() - mean) * rstd
        dbias = dy32.sum(dim=(0, 1, 2))
        dscale = (dy32 * xhat).sum(dim=(0, 1, 2))
        dx = (dy32 - dbias / n - xhat * (dscale / n)) * (rstd * weight)
        return _nchw_view(dx.to(x.dtype)), dscale, dbias


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` over the channels of NCHW activations.

    Statistics in at least float32. Train mode: the batch mean and
    biased variance E[x^2] - E[x]^2 (``_BatchNormTrain``), and ``running
    = 0.99 running + 0.01 batch`` set in place on the device (no host
    read). Eval mode: the running buffers. Then ``(x - mean) * scale /
    sqrt(var + 1e-5) + bias`` in float32, cast to the compute type.
    ``scale_init`` is the scale's initial value (0 for the second
    BatchNorm of a ``ResNetBlock``)."""

    def __init__(self, features: int, scale_init: float = 1.0):
        super().__init__()
        self.scale_init = scale_init
        self.weight = nn.Parameter(torch.full((features,), scale_init))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.training:
            y, mean, var = _BatchNormTrain.apply(x.to(dtype), self.weight,
                                                 self.bias)
            with torch.no_grad():
                for buf, stat in ((self.running_mean, mean),
                                  (self.running_var, var)):
                    buf.copy_(BN_MOMENTUM * buf + (1.0 - BN_MOMENTUM) * stat)
            return y
        mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        y = (_nhwc(x).float() - self.running_mean) * mul + self.bias
        return _nchw_view(y.to(dtype))


def _nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An NHWC batch as the NCHW view cuDNN takes (channels_last in
    memory), in the compute type."""
    if x.ndim != 4:
        raise ValueError(f"image networks take NHWC batches, got shape "
                         f"{tuple(x.shape)}")
    return x.to(dtype).permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """The NHWC view of an NCHW tensor (contiguous if it is channels_last)."""
    return x.permute(0, 2, 3, 1)


def _nchw_view(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def conv_flat_features(conv_features: Sequence[int], pool_every: int,
                       row_shape: Sequence[int]) -> int:
    """The width a ConvNet flattens to before ``dense_0`` on NHWC rows of
    ``row_shape``: 'SAME' convolutions keep H and W, each 2 x 2 'VALID'
    max-pool floors them to half."""
    h, w, c = row_shape
    for i, f in enumerate(conv_features):
        c = f
        if (i + 1) % pool_every == 0:
            h, w = h // 2, w // 2
    return h * w * c


class ConvNet(nn.Module):
    """The CIFAR ConvNet family: stacked conv-relu(-pool) blocks, then
    dense layers. ``flat_features`` is the width ``dense_0`` (or the head)
    takes; None sizes it for a 32 x 32 input. In train mode, ``dropout``
    acts after each dense layer, as the ``MLP``'s."""

    def __init__(self, conv_features: Sequence[int] = (64, 64, 64),
                 kernel: Sequence[int] = (3, 3), pool_every: int = 1,
                 dense_features: Sequence[int] = (256,),
                 num_classes: int = 10, dtype: Any = "float32",
                 dropout: float = 0.0, in_channels: int = 3,
                 flat_features: Optional[int] = None):
        super().__init__()
        self.conv_features = tuple(conv_features)
        self.dense_features = tuple(dense_features)
        self.pool_every = pool_every
        self.num_classes = num_classes
        self.dtype = _dtype(dtype)
        self.dropout = dropout
        self.dropout_generator: Optional[torch.Generator] = None
        cin = in_channels
        for i, f in enumerate(self.conv_features):
            self.add_module(f"conv_{i}", Conv(cin, f, kernel))
            cin = f
        if flat_features is None:
            flat_features = conv_flat_features(
                self.conv_features, pool_every, (32, 32, in_channels))
        width = flat_features
        for i, f in enumerate(self.dense_features):
            self.add_module(f"dense_{i}", nn.Linear(width, f))
            width = f
        self.head = nn.Linear(width, num_classes)

    def forward(self, x: torch.Tensor, capture: Optional[str] = None
                ) -> torch.Tensor:
        x = _nchw(x, self.dtype)
        with strict_f32():
            for i in range(len(self.conv_features)):
                x = F.relu(getattr(self, f"conv_{i}")(x, self.dtype))
                if (i + 1) % self.pool_every == 0:
                    x = F.max_pool2d(x, 2, 2)
                if capture == f"conv_{i}":
                    return _nhwc(x)
        x = _nhwc(x).reshape(x.shape[0], -1)     # flax flattens NHWC
        for i in range(len(self.dense_features)):
            x = F.relu(_dense(x, getattr(self, f"dense_{i}"), self.dtype))
            if self.training and self.dropout > 0:
                x = _dropout(x, self.dropout, self.dropout_generator)
            if capture == f"dense_{i}":
                return x
        return _dense(x, self.head, torch.float32)

    def feature_layers(self) -> List[str]:
        return ([f"conv_{i}" for i in range(len(self.conv_features))]
                + [f"dense_{i}" for i in range(len(self.dense_features))])


class ResNetBlock(nn.Module):
    """Basic block: two 3 x 3 convolutions with explicit (1, 1) padding
    (torch's padding=1, also at stride 2), each followed by BatchNorm
    (the second with scale zeros), and a 1 x 1 projection with its own
    BatchNorm where the shape changes. Submodules carry flax's names."""

    def __init__(self, in_channels: int, features: int, strides: int = 1,
                 dtype: Any = "float32"):
        super().__init__()
        self.dtype = _dtype(dtype)
        pad = ((1, 1), (1, 1))
        self.Conv_0 = Conv(in_channels, features, (3, 3), strides, pad,
                           bias=False)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = Conv(features, features, (3, 3), 1, pad, bias=False)
        self.BatchNorm_1 = BatchNorm(features, scale_init=0.0)
        # flax projects where the residual's shape differs from y's: the
        # channels change at every stage entry, and only there is the
        # stride 2
        if in_channels != features or strides != 1:
            self.proj = Conv(in_channels, features, (1, 1), strides,
                             ((0, 0), (0, 0)), bias=False)
            self.BatchNorm_2 = BatchNorm(features)
        else:
            self.proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.relu(self.BatchNorm_0(self.Conv_0(x, dt), dt))
        y = self.BatchNorm_1(self.Conv_1(y, dt), dt)
        residual = x
        if self.proj is not None:
            residual = self.BatchNorm_2(self.proj(x, dt), dt)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet family. ``stem='cifar'`` (default, and any value but
    'imagenet', as in flax): a 3 x 3 stem,
    stage_sizes=(3, 3, 3) -> ResNet-20. ``stem='imagenet'``: torchvision's
    7 x 7 / stride 2 / pad 3 stem, BatchNorm, ReLU and a 3 x 3 / stride 2
    max-pool padded by 1 with -inf; stage_sizes=(2, 2, 2, 2), width=64,
    num_classes=1000 -> resnet18."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 3, 3),
                 width: int = 16, num_classes: int = 10,
                 stem: str = "cifar", dtype: Any = "float32",
                 in_channels: int = 3):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.width, self.num_classes, self.stem_kind = width, num_classes, stem
        self.dtype = _dtype(dtype)
        if stem == "imagenet":
            self.stem = Conv(in_channels, width, (7, 7), 2,
                             ((3, 3), (3, 3)), bias=False)
        else:
            self.stem = Conv(in_channels, width, (3, 3), bias=False)
        self.BatchNorm_0 = BatchNorm(width)
        cin = width
        for s, n_blocks in enumerate(self.stage_sizes):
            for b in range(n_blocks):
                features = width * 2 ** s
                self.add_module(f"stage{s}_block{b}", ResNetBlock(
                    cin, features, 2 if (s > 0 and b == 0) else 1, dtype))
                cin = features
        self.head = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor, capture: Optional[str] = None
                ) -> torch.Tensor:
        dt = self.dtype
        x = _nchw(x, dt)
        with strict_f32():
            x = F.relu(self.BatchNorm_0(self.stem(x, dt), dt))
            if self.stem_kind == "imagenet":
                x = F.max_pool2d(x, 3, 2, padding=1)   # pads with -inf
            for s, n_blocks in enumerate(self.stage_sizes):
                for b in range(n_blocks):
                    x = getattr(self, f"stage{s}_block{b}")(x)
                if capture == f"stage{s}":
                    return _nhwc(x)
        # jnp.mean over H, W: accumulated in float32, in the compute type
        x = x.float().mean(dim=(2, 3)).to(dt)
        if capture == "pool":
            return x
        return _dense(x, self.head, torch.float32)

    def feature_layers(self) -> List[str]:
        return [f"stage{s}" for s in range(len(self.stage_sizes))] + ["pool"]

    def numerics_markers(self) -> Dict[str, str]:
        """Saved-stage numerics versioning (``core/serialize.py``): the
        explicit (1, 1) padding of the JAX package's ResNet."""
        return {"resnet_padding": "explicit11-torch-compat"}


class LSTMCell(nn.Module):
    """The weights of flax's ``OptimizedLSTMCell`` in the layout of
    torch's fused LSTM: the gates (i, f, g, o) stacked on the first axis
    of ``weight_ih`` (flax's ``ii``.. ``io``, no bias) and ``weight_hh``
    (``hi``.. ``ho``), and one bias per gate, flax's recurrent one."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, in_features))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden))


# flops of the LSTM products that FlopCounterMode cannot see on the card
# (cuDNN's RNN op has no formula there): counted where the forward is
# queued on a CUDA tensor, with its backward's (twice the forward) when
# grad is on; readers take differences
RNN_FLOPS: Dict[str, int] = {"lstm": 0}


class BiLSTMTagger(nn.Module):
    """Bidirectional LSTM sequence tagger. Input: token ids [B, T];
    output: per-token logits [B, T, num_tags]. An embedding in the compute
    type, then one cuDNN LSTM call over both directions in float32 (the
    flax cells have no dtype, so they promote the embedding to float32):
    ``OptimizedLSTMCell_0`` reads the sequence forward,
    ``OptimizedLSTMCell_1`` the whole fixed-length sequence reversed with
    its outputs kept in order; zero initial carries, no lengths. torch's
    second bias per gate is held at zero and takes no gradient. The
    weights are separate tensors, so cuDNN packs them into its own buffer
    at each call (torch warns of that once per process); there are
    2 x 4 x hidden x (embed_dim + hidden + 1) of them."""

    int_input = True  # consumes token ids, not float features

    def __init__(self, vocab_size: int = 10000, embed_dim: int = 128,
                 hidden: int = 128, num_tags: int = 8,
                 dtype: Any = "float32"):
        super().__init__()
        self.vocab_size, self.embed_dim = vocab_size, embed_dim
        self.hidden, self.num_tags = hidden, num_tags
        self.dtype = _dtype(dtype)
        self.embed = nn.Embedding(vocab_size, embed_dim)
        self.OptimizedLSTMCell_0 = LSTMCell(embed_dim, hidden)   # forward
        self.OptimizedLSTMCell_1 = LSTMCell(embed_dim, hidden)   # backward
        self.head = nn.Linear(2 * hidden, num_tags)

    def forward(self, tokens: torch.Tensor, capture: Optional[str] = None
                ) -> torch.Tensor:
        b, t = tokens.shape
        emb = F.embedding(tokens.long(), self.embed.weight.to(self.dtype))
        x = emb.float()
        h0 = x.new_zeros(2, b, self.hidden)
        params = []
        for cell in (self.OptimizedLSTMCell_0, self.OptimizedLSTMCell_1):
            params += [cell.weight_ih, cell.weight_hh,
                       torch.zeros_like(cell.bias_hh), cell.bias_hh]
        with strict_f32():
            h, _, _ = torch.lstm(x, (h0, h0), params, True, 1, 0.0,
                                 self.training, True, True)
        if x.is_cuda:
            fwd = 2 * 2 * t * b * (self.embed_dim + self.hidden) \
                * 4 * self.hidden
            RNN_FLOPS["lstm"] += fwd * (3 if torch.is_grad_enabled() else 1)
        if capture == "lstm":
            return h
        return _dense(h, self.head, torch.float32)

    def feature_layers(self) -> List[str]:
        return ["lstm"]


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


def _orthogonal_(t: torch.Tensor, g: torch.Generator) -> None:
    """jax's ``orthogonal()`` of a square block: Q of the QR of a normal
    draw, its columns' signs set by R's diagonal."""
    q, r = torch.linalg.qr(torch.randn(t.shape, generator=g,
                                       device=t.device))
    t.copy_(q * torch.sign(torch.diagonal(r))[None, :])


@torch.no_grad()
def init_weights(module: nn.Module, seed: int = 0) -> nn.Module:
    """Draw every weight of ``module`` from ``seed`` on the module's
    device, in a fixed order, with flax's default initializers."""
    dev = next(module.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)

    def lecun_(t: torch.Tensor, fan_in: int) -> None:
        _trunc_normal_(t, (1.0 / fan_in) ** 0.5 / _TRUNC_STD, g)

    for mod in module.modules():
        if isinstance(mod, nn.Linear):
            lecun_(mod.weight, mod.in_features)
            mod.bias.zero_()
        elif isinstance(mod, Conv):
            kh, kw = mod.kernel_size
            lecun_(mod.weight, kh * kw * mod.in_channels)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.weight.fill_(mod.scale_init)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
        elif isinstance(mod, LSTMCell):
            # flax draws each gate's kernel on its own: the input ones
            # lecun-normal over their fan-in, the recurrent ones orthogonal
            lecun_(mod.weight_ih, mod.weight_ih.shape[1])
            for block in mod.weight_hh.split(mod.hidden):
                _orthogonal_(block, g)
            mod.bias_hh.zero_()
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

NETWORK_REGISTRY: Dict[str, Callable[..., nn.Module]] = {
    "mlp": MLP,
    "convnet": ConvNet,
    "resnet": ResNet,
    "bilstm": BiLSTMTagger,
    "transformer": Transformer,
}


def sized_spec(spec: Dict[str, Any], row_shape: Sequence[int]
               ) -> Dict[str, Any]:
    """``spec`` with the sizes flax infers at init filled in from the
    shape of one input row (keys the spec already has are kept): an
    MLP's ``in_features`` (the last dim), a ConvNet's ``in_channels``
    and ``flat_features`` (NHWC rows), a ResNet's ``in_channels``."""
    spec = dict(spec)
    kind = spec.get("type")
    row_shape = tuple(int(d) for d in row_shape)
    if kind == "mlp":
        spec.setdefault("in_features", row_shape[-1])
    elif kind in ("convnet", "resnet"):
        if len(row_shape) != 3:
            raise ValueError(f"a {kind} takes NHWC image rows; got rows of "
                             f"shape {row_shape} (set inputShape)")
        spec.setdefault("in_channels", row_shape[-1])
        if kind == "convnet":
            spec.setdefault("flat_features", conv_flat_features(
                spec.get("conv_features", (64, 64, 64)),
                spec.get("pool_every", 1), row_shape))
    return spec


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
