"""Image operations of the PyTorch port (see ``mmlspark_tpu/ops/image_ops.py``):
a host half (numpy, one image, any size) and a batch half (torch tensors,
NHWC, on the tensors' device) of each op.

Analog of the reference's OpenCV op set
(ref: src/image-transformer/src/main/scala/ImageTransformer.scala:34-205:
ResizeImage, CropImage, ColorFormat, Flip, Blur, Threshold,
GaussianKernel). Uniform-size batches run as one composed torch function
on the card (``stages/image.ImageTransformer``); ragged inputs run per
image on the host. BGR is the storage order (ref: ImageSchema.scala:12-22).

Where the port departs from the JAX package's code, and why:

- **Resize.** The JAX package calls ``jax.image.resize(method='bilinear')``,
  an antialiased triangle filter that drops taps outside the image and
  renormalizes. Its torch counterpart is ``F.interpolate(mode='bilinear',
  antialias=True, align_corners=False)`` on the NCHW view, the same
  filter summed in another order (within 5e-4 on 0-255 images). A uint8
  host image keeps the native kernel of both packages
  (``csrc/image.cpp``, bit for bit the JAX package's); every other dtype
  takes the float path.
- **Blur.** The batch half edge-pads asymmetrically (``k // 2`` before,
  ``(k - 1) // 2`` after) and runs two VALID depthwise convolutions, as
  the JAX package does, under ``networks.strict_f32()``: cuDNN would run
  them in TF32 otherwise, and the uint8 rounding after them would flip
  pixels. The host half stays scipy's ``convolve1d(mode='nearest')``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.io import native_image
from mmlspark_tpu_torch.models.networks import strict_f32

# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------


def _interpolate_nhwc(x: torch.Tensor, height: int, width: int
                      ) -> torch.Tensor:
    """``jax.image.resize(method='bilinear')`` of an NHWC float batch."""
    out = F.interpolate(x.permute(0, 3, 1, 2), size=(int(height), int(width)),
                        mode="bilinear", antialias=True, align_corners=False)
    return out.permute(0, 2, 3, 1)


def resize_host(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Antialiased bilinear resize. uint8 images take the native kernel
    (raises if it does not build); other dtypes the float path, whose
    float32 result is rounded and clipped back for integer dtypes."""
    if img.ndim == 2:
        img = img[:, :, None]
    if img.dtype == np.uint8:
        return native_image.resize_u8(img, height, width)
    x = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32))
    out = _interpolate_nhwc(x[None], height, width)[0].numpy()
    if np.issubdtype(img.dtype, np.integer):
        out = np.clip(np.round(out), 0, 255).astype(img.dtype)
    return out


def resize_batch(imgs: torch.Tensor, height: int, width: int) -> torch.Tensor:
    return _interpolate_nhwc(imgs.float(), height, width)


# ---------------------------------------------------------------------------
# crop
# ---------------------------------------------------------------------------


def crop_host(img: np.ndarray, x: int, y: int,
              height: int, width: int) -> np.ndarray:
    return img[y:y + height, x:x + width]


def crop_batch(imgs: torch.Tensor, x: int, y: int,
               height: int, width: int) -> torch.Tensor:
    return imgs[:, y:y + height, x:x + width, :]


def center_crop_host(img: np.ndarray, height: int, width: int) -> np.ndarray:
    h, w = img.shape[:2]
    y = max(0, (h - height) // 2)
    x = max(0, (w - width) // 2)
    return img[y:y + height, x:x + width]


# ---------------------------------------------------------------------------
# color conversion
# ---------------------------------------------------------------------------

# ITU-R BT.601 luma weights in BGR order
_BGR_LUMA = np.array([0.114, 0.587, 0.299], dtype=np.float32)


def color_convert_host(img: np.ndarray, conversion: str) -> np.ndarray:
    conversion = conversion.upper()
    if conversion in ("BGR2GRAY", "RGB2GRAY"):
        w = _BGR_LUMA if conversion.startswith("BGR") else _BGR_LUMA[::-1]
        gray = (img[..., :3].astype(np.float32) @ w)
        return np.clip(np.round(gray), 0, 255).astype(img.dtype)[..., None]
    if conversion in ("BGR2RGB", "RGB2BGR"):
        return img[..., ::-1]
    if conversion in ("GRAY2BGR", "GRAY2RGB"):
        return np.repeat(img[..., :1], 3, axis=-1)
    raise ValueError(f"unsupported color conversion {conversion!r}")


def color_convert_batch(imgs: torch.Tensor, conversion: str) -> torch.Tensor:
    conversion = conversion.upper()
    if conversion in ("BGR2GRAY", "RGB2GRAY"):
        w = _BGR_LUMA if conversion.startswith("BGR") else _BGR_LUMA[::-1]
        w = torch.tensor(w.copy(), device=imgs.device)
        return (imgs[..., :3].float() @ w)[..., None]
    if conversion in ("BGR2RGB", "RGB2BGR"):
        return torch.flip(imgs, dims=[-1])
    if conversion in ("GRAY2BGR", "GRAY2RGB"):
        return imgs[..., :1].expand(*imgs.shape[:-1], 3)
    raise ValueError(f"unsupported color conversion {conversion!r}")


# ---------------------------------------------------------------------------
# flip (flip_code semantics match OpenCV: 0=vertical, >0=horizontal, <0=both)
# ---------------------------------------------------------------------------


def flip_host(img: np.ndarray, flip_code: int = 1) -> np.ndarray:
    if flip_code == 0:
        return img[::-1, :, :]
    if flip_code > 0:
        return img[:, ::-1, :]
    return img[::-1, ::-1, :]


def flip_batch(imgs: torch.Tensor, flip_code: int = 1) -> torch.Tensor:
    if flip_code == 0:
        return torch.flip(imgs, dims=[1])
    if flip_code > 0:
        return torch.flip(imgs, dims=[2])
    return torch.flip(imgs, dims=[1, 2])


# ---------------------------------------------------------------------------
# blur: normalized box filter (ref Blur op) via separable convolution
# ---------------------------------------------------------------------------


def _separable_conv_host(img: np.ndarray, kx: np.ndarray,
                         ky: np.ndarray) -> np.ndarray:
    """Separable 2D convolution with edge ("replicate") padding."""
    from scipy.ndimage import convolve1d
    out = img.astype(np.float32)
    out = convolve1d(out, ky, axis=0, mode="nearest")
    out = convolve1d(out, kx, axis=1, mode="nearest")
    return out


def box_blur_host(img: np.ndarray, height: int, width: int) -> np.ndarray:
    ky = np.full(int(height), 1.0 / height, dtype=np.float32)
    kx = np.full(int(width), 1.0 / width, dtype=np.float32)
    out = _separable_conv_host(img, kx, ky)
    if np.issubdtype(img.dtype, np.integer):
        out = np.clip(np.round(out), 0, 255).astype(img.dtype)
    return out


def _separable_conv_batch(imgs: torch.Tensor, kx: np.ndarray,
                          ky: np.ndarray) -> torch.Tensor:
    """Depthwise separable convolution of an NHWC batch: edge padding
    (the host half's mode='nearest'), then a vertical and a horizontal
    VALID pass with one group per channel, in IEEE float32."""
    x = imgs.float().permute(0, 3, 1, 2)
    c = x.shape[1]
    kh, kw = len(ky), len(kx)
    x = F.pad(x, (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2),
              mode="replicate")
    kv = torch.tensor(np.asarray(ky, np.float32), device=x.device)
    kz = torch.tensor(np.asarray(kx, np.float32), device=x.device)
    with strict_f32():
        x = F.conv2d(x, kv.reshape(1, 1, kh, 1).expand(c, 1, kh, 1),
                     groups=c)
        x = F.conv2d(x, kz.reshape(1, 1, 1, kw).expand(c, 1, 1, kw),
                     groups=c)
    return x.permute(0, 2, 3, 1)


def box_blur_batch(imgs: torch.Tensor, height: int, width: int
                   ) -> torch.Tensor:
    ky = np.full(int(height), 1.0 / height, dtype=np.float32)
    kx = np.full(int(width), 1.0 / width, dtype=np.float32)
    return _separable_conv_batch(imgs, kx, ky)


# ---------------------------------------------------------------------------
# gaussian blur / kernel (ref GaussianKernel op)
# ---------------------------------------------------------------------------


def gaussian_kernel_1d(aperture: int, sigma: float) -> np.ndarray:
    if sigma <= 0:
        # OpenCV convention: derive sigma from aperture
        sigma = 0.3 * ((aperture - 1) * 0.5 - 1) + 0.8
    half = (aperture - 1) / 2.0
    xs = np.arange(aperture, dtype=np.float64) - half
    k = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur_host(img: np.ndarray, aperture: int,
                       sigma: float) -> np.ndarray:
    k = gaussian_kernel_1d(aperture, sigma)
    out = _separable_conv_host(img, k, k)
    if np.issubdtype(img.dtype, np.integer):
        out = np.clip(np.round(out), 0, 255).astype(img.dtype)
    return out


def gaussian_blur_batch(imgs: torch.Tensor, aperture: int,
                        sigma: float) -> torch.Tensor:
    k = gaussian_kernel_1d(aperture, sigma)
    return _separable_conv_batch(imgs, k, k)


# ---------------------------------------------------------------------------
# threshold (ref Threshold op; OpenCV THRESH_* semantics)
# ---------------------------------------------------------------------------

THRESH_BINARY = "binary"
THRESH_BINARY_INV = "binary_inv"
THRESH_TRUNC = "trunc"
THRESH_TOZERO = "tozero"
THRESH_TOZERO_INV = "tozero_inv"


def _threshold_host(img, threshold: float, max_val: float, kind: str):
    mask = img > threshold
    if kind == THRESH_BINARY:
        return np.where(mask, max_val, 0)
    if kind == THRESH_BINARY_INV:
        return np.where(mask, 0, max_val)
    if kind == THRESH_TRUNC:
        return np.where(mask, threshold, img)
    if kind == THRESH_TOZERO:
        return np.where(mask, img, 0)
    if kind == THRESH_TOZERO_INV:
        return np.where(mask, 0, img)
    raise ValueError(f"unknown threshold type {kind!r}")


def threshold_host(img: np.ndarray, threshold: float, max_val: float,
                   kind: str = THRESH_BINARY) -> np.ndarray:
    out = _threshold_host(img.astype(np.float32), threshold, max_val, kind)
    if np.issubdtype(img.dtype, np.integer):
        out = np.clip(out, 0, 255).astype(img.dtype)
    return out


def threshold_batch(imgs: torch.Tensor, threshold: float, max_val: float,
                    kind: str = THRESH_BINARY) -> torch.Tensor:
    x = imgs.float()
    mask = x > threshold
    top = torch.full_like(x, float(max_val))
    zero = torch.zeros_like(x)
    if kind == THRESH_BINARY:
        return torch.where(mask, top, zero)
    if kind == THRESH_BINARY_INV:
        return torch.where(mask, zero, top)
    if kind == THRESH_TRUNC:
        return torch.where(mask, torch.full_like(x, float(threshold)), x)
    if kind == THRESH_TOZERO:
        return torch.where(mask, x, zero)
    if kind == THRESH_TOZERO_INV:
        return torch.where(mask, zero, x)
    raise ValueError(f"unknown threshold type {kind!r}")


# ---------------------------------------------------------------------------
# unroll: HWC-BGR image -> flat CHW float vector
# (ref: src/image-transformer/src/main/scala/UnrollImage.scala:16-43)
# ---------------------------------------------------------------------------


def unroll_host(img: np.ndarray) -> np.ndarray:
    """HWC -> CHW-flattened float64 vector, reference byte order; uint8
    through the native kernel (``csrc/image.cpp``, ``mml_unroll_chw``)."""
    if img.ndim == 2:
        img = img[:, :, None]
    if img.dtype == np.uint8:
        return native_image.unroll_chw(img)
    return img.transpose(2, 0, 1).astype(np.float64).ravel()


def unroll_batch(imgs: torch.Tensor) -> torch.Tensor:
    n = imgs.shape[0]
    return imgs.permute(0, 3, 1, 2).reshape(n, -1).float()


def roll_host(vec: np.ndarray, height: int, width: int,
              channels: int) -> np.ndarray:
    """Inverse of unroll_host."""
    return (vec.reshape(channels, height, width)
            .transpose(1, 2, 0).astype(np.float64))


# ---------------------------------------------------------------------------
# normalization (mean/std, common for model input prep)
# ---------------------------------------------------------------------------


def normalize_batch(imgs: torch.Tensor, mean, std) -> torch.Tensor:
    mean = torch.as_tensor(np.asarray(mean, np.float32), device=imgs.device)
    std = torch.as_tensor(np.asarray(std, np.float32), device=imgs.device)
    return (imgs.float() - mean) / std
