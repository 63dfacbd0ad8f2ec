"""PyTorch port: the image readers, the host image library, the image ops
and the image stages against the JAX package, on the CPU.

The same seeded numpy images go through ``mmlspark_tpu`` and
``mmlspark_tpu_torch``: the scenarios of ``tests/test_image_pipeline.py``
and of ``tests/test_native.py`` (``TestNativeImageOps``,
``TestNativeDecode``), run through both packages.

Tolerances, stated:
- bitwise: the native uint8 resize (``csrc/image.cpp`` is the JAX
  package's ``mml_resize_bilinear_u8``), unroll, PNG and JPEG decode
  (the same libjpeg / libpng calls), flip, crop, threshold, the uint8
  host resize, ``read_binary_files`` and ``read_images``.
- float resize: within 1e-3 absolute on 0-255 images (torch's
  antialiased bilinear filter is jax.image.resize's, summed in another
  order; measured 4.4e-4 at 375 x 500 -> 224 x 224).
- box and Gaussian blur: rtol 1e-5 / atol 1e-3 on 0-255 (measured 3e-5).
- ImageTransformer's uint8 outputs: the host (ragged) path bitwise; the
  batch (uniform) path at most 1 apart in at most 0.1 % of the pixels of
  photo-sized images, and at the reference scenarios' toy sizes, which
  land on exact .5 ties (a 2x downscale of integer pixels), at most 1
  apart and only where the JAX package's float is within 1e-3 of a tie.
"""

import io
import os
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.core.schema import ImageSchema as JImageSchema
from mmlspark_tpu.core.table import DataTable as JTable
from mmlspark_tpu.io.binary import read_binary_files as jread_binary
from mmlspark_tpu.io.image import decode_image as jdecode
from mmlspark_tpu.io.image import read_images as jread_images
from mmlspark_tpu.native import loader as jnative
from mmlspark_tpu.ops import image_ops as J
from mmlspark_tpu.stages.image import (
    ImageSetAugmenter as JAugmenter, ImageTransformer as JTransformer,
    UnrollImage as JUnroll,
)

import mmlspark_tpu_torch as mtt
from mmlspark_tpu_torch import _build
from mmlspark_tpu_torch.core.schema import ImageSchema
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.io import native_image
from mmlspark_tpu_torch.io.binary import read_binary_files
from mmlspark_tpu_torch.io.image import decode_image, read_images
from mmlspark_tpu_torch.ops import image_ops as P
from mmlspark_tpu_torch.stages.image import (
    ImageSetAugmenter, ImageTransformer, UnrollImage,
)

REPO = Path(__file__).resolve().parent.parent


def _img(shape=(37, 53, 3), seed=0):
    return np.random.default_rng(seed).integers(0, 255, shape).astype(
        np.uint8)


def _tables(n=4, h=16, w=20, c=3, seed=0, ragged=False):
    """The same image column as a JAX-package table and a port table."""
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 256, ((10 + i) if ragged else h, w, c),
                         dtype=np.uint8) for i in range(n)]
    jt = JTable({"image": [JImageSchema.make_row(f"img_{i}.png", im)
                           for i, im in enumerate(imgs)]})
    pt = DataTable({"image": [ImageSchema.make_row(f"img_{i}.png", im)
                              for i, im in enumerate(imgs)]})
    return jt, pt


def _images(table, col="image"):
    return [None if r is None else r[ImageSchema.DATA] for r in table[col]]


def _assert_u8_close(got, want):
    """At most 1 apart, in at most 0.1 % of the pixels."""
    got = np.concatenate([g.ravel() for g in got]).astype(int)
    want = np.concatenate([w.ravel() for w in want]).astype(int)
    d = np.abs(got - want)
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= 1e-3, (d > 0).mean()


# ---------------------------------------------------------------------------
# the host image library (csrc/image.cpp, csrc/imgcodec.cpp)
# ---------------------------------------------------------------------------


def test_build_all_builds_the_image_library_not_the_codecs():
    assert _build.HOST_SOURCES["image"] == "image.cpp"
    assert "imgcodec" not in _build.HOST_SOURCES
    assert _build.source_of("imgcodec") == "imgcodec.cpp"
    # the codecs' link flags are part of their library's name
    assert _build.library_path("imgcodec") != _build.library_path("image")


@pytest.mark.parametrize("shape,out", [
    ((37, 53, 3), (16, 24)),          # downscale
    ((16, 20, 1), (32, 48)),          # upscale, one channel
    ((375, 500, 3), (224, 224)),      # a Flowers-sized photo to ResNet's
    ((33, 47, 3), (20, 61)),          # down in one axis, up in the other
])
def test_native_resize_bitwise_the_jax_packages(shape, out):
    img = _img(shape)
    got = native_image.resize_u8(img, *out)
    np.testing.assert_array_equal(got, jnative.resize_u8(img, *out))
    # the uint8 host resize of both packages
    np.testing.assert_array_equal(P.resize_host(img, *out),
                                  J.resize_host(img, *out))
    # and within 1 of jax.image.resize rounded (test_native's rule)
    want = np.clip(np.round(np.asarray(J.resize_host(
        img.astype(np.float32), *out))), 0, 255)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_native_unroll_exact():
    img = _img()
    ref = img.transpose(2, 0, 1).astype(np.float64).ravel()
    np.testing.assert_array_equal(native_image.unroll_chw(img), ref)
    np.testing.assert_array_equal(P.unroll_host(img), J.unroll_host(img))
    assert P.unroll_host(img).dtype == np.float64


def test_native_decode_png_jpeg_and_garbage():
    from PIL import Image
    img = _img((24, 31, 3))
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    png = buf.getvalue()
    np.testing.assert_array_equal(native_image.decode_image(png), img)
    np.testing.assert_array_equal(native_image.decode_image(png),
                                  jnative.decode_image(png))
    yy, xx = np.mgrid[0:64, 0:64]
    smooth = np.stack([yy * 2, xx * 2, yy + xx], -1).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(smooth).save(buf, format="JPEG", quality=95)
    jpg = buf.getvalue()
    dec = native_image.decode_image(jpg)
    np.testing.assert_array_equal(dec, jnative.decode_image(jpg))
    assert np.abs(dec.astype(int) - smooth.astype(int)).mean() < 3
    assert native_image.decode_image(b"not an image at all") is None
    # io.image.decode_image: BGR, as the JAX package's
    np.testing.assert_array_equal(decode_image(png), img[:, :, ::-1])
    np.testing.assert_array_equal(decode_image(png), jdecode(png))
    assert decode_image(b"not an image at all") is None


# ---------------------------------------------------------------------------
# image ops, host and batch halves, against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,out", [((375, 500, 3), (224, 224)),
                                       ((32, 32, 3), (224, 224)),
                                       ((240, 320, 3), (32, 32)),
                                       ((33, 47, 1), (20, 61))])
def test_float_resize_within_1e3(shape, out):
    img = _img(shape, seed=3).astype(np.float32)
    got = P.resize_host(img, *out)
    assert got.dtype == np.float32 and got.shape == out + (shape[2],)
    np.testing.assert_allclose(got, J.resize_host(img, *out), rtol=0,
                               atol=1e-3)
    batch = np.stack([img, img[::-1]])
    np.testing.assert_allclose(
        P.resize_batch(torch.from_numpy(batch), *out).numpy(),
        np.asarray(J.resize_batch(jnp.asarray(batch), *out)), rtol=0,
        atol=1e-3)
    # an integer dtype other than uint8 rounds the float path
    i32 = img.astype(np.int32)
    d = P.resize_host(i32, *out).astype(int) - J.resize_host(i32, *out)
    assert P.resize_host(i32, *out).dtype == np.int32
    assert np.abs(d).max() <= 1


@pytest.mark.parametrize("op,args", [
    ("box_blur", (5, 5)), ("box_blur", (4, 3)), ("box_blur", (1, 6)),
    ("gaussian_blur", (5, 0.0)), ("gaussian_blur", (5, 1.0)),
    ("gaussian_blur", (4, 1.5))])
def test_blur_host_and_batch(op, args):
    imgs = np.stack([_img((16, 20, 3), seed=s) for s in range(3)])
    for x in (imgs, imgs.astype(np.float32)):
        np.testing.assert_allclose(
            getattr(P, f"{op}_host")(x[0], *args),
            getattr(J, f"{op}_host")(x[0], *args), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(
            getattr(P, f"{op}_batch")(torch.from_numpy(x), *args).numpy(),
            np.asarray(getattr(J, f"{op}_batch")(jnp.asarray(x), *args)),
            rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(P.gaussian_kernel_1d(*args),
                                  J.gaussian_kernel_1d(*args)) \
        if op == "gaussian_blur" else None


@pytest.mark.parametrize("kind", ["binary", "binary_inv", "trunc", "tozero",
                                  "tozero_inv"])
def test_threshold_bitwise(kind):
    imgs = np.stack([_img((9, 11, 3), seed=s) for s in range(2)])
    np.testing.assert_array_equal(P.threshold_host(imgs[0], 128, 200, kind),
                                  J.threshold_host(imgs[0], 128, 200, kind))
    got = P.threshold_batch(torch.from_numpy(imgs), 127.5, 200.0, kind)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(J.threshold_batch(jnp.asarray(imgs), 127.5,
                                                  200.0, kind)))
    with pytest.raises(ValueError, match="threshold type"):
        P.threshold_batch(torch.from_numpy(imgs), 1, 2, "nope")


@pytest.mark.parametrize("code", [0, 1, -1])
def test_flip_and_crop_bitwise(code):
    imgs = np.stack([_img((9, 11, 3), seed=s) for s in range(2)])
    np.testing.assert_array_equal(P.flip_host(imgs[0], code),
                                  J.flip_host(imgs[0], code))
    np.testing.assert_array_equal(
        P.flip_batch(torch.from_numpy(imgs), code).numpy(),
        np.asarray(J.flip_batch(jnp.asarray(imgs), code)))
    np.testing.assert_array_equal(P.crop_host(imgs[0], 2, 3, 5, 6),
                                  J.crop_host(imgs[0], 2, 3, 5, 6))
    np.testing.assert_array_equal(
        P.crop_batch(torch.from_numpy(imgs), 2, 3, 5, 6).numpy(),
        np.asarray(J.crop_batch(jnp.asarray(imgs), 2, 3, 5, 6)))
    np.testing.assert_array_equal(P.center_crop_host(imgs[0], 4, 20),
                                  J.center_crop_host(imgs[0], 4, 20))


@pytest.mark.parametrize("conv", ["BGR2GRAY", "RGB2GRAY", "BGR2RGB",
                                  "GRAY2BGR"])
def test_color_convert(conv):
    imgs = np.stack([_img((9, 11, 3), seed=s) for s in range(2)])
    np.testing.assert_array_equal(P.color_convert_host(imgs[0], conv),
                                  J.color_convert_host(imgs[0], conv))
    got = P.color_convert_batch(torch.from_numpy(imgs), conv).numpy()
    want = np.asarray(J.color_convert_batch(jnp.asarray(imgs), conv))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    with pytest.raises(ValueError, match="color conversion"):
        P.color_convert_host(imgs[0], "BGR2HSV")


def test_unroll_roll_normalize():
    imgs = np.stack([_img((5, 7, 3), seed=s) for s in range(2)])
    np.testing.assert_array_equal(
        P.unroll_batch(torch.from_numpy(imgs)).numpy(),
        np.asarray(J.unroll_batch(jnp.asarray(imgs))))
    vec = P.unroll_host(imgs[0])
    np.testing.assert_array_equal(P.roll_host(vec, 5, 7, 3),
                                  J.roll_host(vec, 5, 7, 3))
    np.testing.assert_array_equal(P.roll_host(vec, 5, 7, 3), imgs[0])
    mean, std = [10.0, 20.0, 30.0], [2.0, 4.0, 8.0]
    np.testing.assert_allclose(
        P.normalize_batch(torch.from_numpy(imgs), mean, std).numpy(),
        np.asarray(J.normalize_batch(jnp.asarray(imgs), mean, std)),
        rtol=1e-6)


# ---------------------------------------------------------------------------
# ImageTransformer, UnrollImage, ImageSetAugmenter: the scenarios of
# tests/test_image_pipeline.py through both packages
# ---------------------------------------------------------------------------


PIPELINES = {
    "resize": lambda t: t.resize(8, 8),
    "resize-flip": lambda t: t.resize(8, 10).flip(1),
    "crop": lambda t: t.crop(2, 3, 6, 8),
    "flip": lambda t: t.flip(1),
    "threshold": lambda t: t.threshold(128, 255),
    "gray": lambda t: t.color_format("BGR2GRAY"),
    "blur": lambda t: t.blur(5, 5),
    "gaussian": lambda t: t.gaussian_kernel(5, 1.0),
    "resize-gaussian-flip": lambda t: t.resize(12, 9).gaussian_kernel(5, 0)
    .flip(-1),
    "host-only": lambda t: t.resize(8, 10).flip(1).center_crop(8, 10),
}


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_image_transformer_matches_jax(name, ragged):
    """The ragged (host) path is bitwise the JAX package's: the same
    native resize, scipy blur and numpy ops. The uniform (batch) path
    differs only where a float output sits on a rounding tie: a pixel
    that rounds differently is 1 apart, and there the JAX package's
    float is within 1e-3 of k + 0.5 (these toy sizes hit exact ties: a
    2x downscale of integer pixels lands on .5)."""
    jt, pt = _tables(ragged=ragged)
    jstage = PIPELINES[name](JTransformer())
    stage = PIPELINES[name](ImageTransformer(device="cpu"))
    want = jstage.transform(jt)
    got = stage.transform(pt)
    for g, w in zip(got["image"], want["image"]):
        assert g[ImageSchema.MODE] == w[ImageSchema.MODE]
        assert g[ImageSchema.CHANNELS] == w[ImageSchema.CHANNELS]
        assert g[ImageSchema.DATA].dtype == np.uint8
    if ragged or name == "host-only":
        for g, w in zip(_images(got), _images(want)):
            np.testing.assert_array_equal(g, w)
        return
    batch = np.stack(_images(pt))
    jf = np.asarray(jstage._apply_batch_fn()(jnp.asarray(batch)))
    d = np.stack(_images(got)).astype(int) - np.stack(_images(want))
    assert np.abs(d).max() <= 1
    off = np.abs(jf[d != 0] - np.floor(jf[d != 0]) - 0.5)
    assert (off <= 1e-3).all(), off.max()
    with torch.no_grad():
        pf = stage._apply_batch(torch.from_numpy(batch)).numpy()
    np.testing.assert_allclose(pf, jf, rtol=1e-5, atol=1e-3)


def test_image_transformer_at_photo_size_within_tolerance():
    """chip_smoke.py phase 10(a)'s op list on 375 x 500 photos: uint8
    outputs at most 1 apart in at most 0.1 % of the pixels."""
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (375, 500, 3), dtype=np.uint8)
            for _ in range(4)]
    jt = JTable({"image": [JImageSchema.make_row(f"p{i}", im)
                           for i, im in enumerate(imgs)]})
    pt = DataTable({"image": [ImageSchema.make_row(f"p{i}", im)
                              for i, im in enumerate(imgs)]})
    got = ImageTransformer(device="cpu").resize(224, 224) \
        .gaussian_kernel(5, 0).flip().transform(pt)
    want = JTransformer().resize(224, 224).gaussian_kernel(5, 0).flip() \
        .transform(jt)
    _assert_u8_close(_images(got), _images(want))


def test_uniform_and_ragged_paths_agree():
    _, pt = _tables()
    stage = ImageTransformer(device="cpu").resize(8, 10).flip(1)
    host = ImageTransformer(device="cpu").resize(8, 10).flip(1) \
        .center_crop(8, 10)                      # forces the host path
    for rb, rh in zip(_images(stage.transform(pt)),
                      _images(host.transform(pt))):
        np.testing.assert_allclose(rb.astype(int), rh.astype(int), atol=1)
    # an op added later runs on the uniform path too
    stage.flip(0)
    host.flip(0)
    for rb, rh in zip(_images(stage.transform(pt)),
                      _images(host.transform(pt))):
        np.testing.assert_allclose(rb.astype(int), rh.astype(int), atol=1)


def test_transformer_keeps_null_rows_and_validates_schema():
    _, pt = _tables(n=3)
    rows = list(pt["image"])
    rows[1] = None
    out = ImageTransformer(device="cpu").resize(4, 4).transform(
        DataTable({"image": rows}))
    assert out["image"][1] is None
    assert out["image"][0][ImageSchema.DATA].shape == (4, 4, 3)
    with pytest.raises((TypeError, KeyError)):
        ImageTransformer().resize(4, 4).transform_schema(
            DataTable({"x": [1, 2, 3]}).schema)


def test_image_stages_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pt = _tables(n=2)
    for stage in (ImageTransformer().resize(4, 4),
                  ImageTransformer().center_crop(4, 4)):   # host path too
        with pytest.raises(RuntimeError, match="device='cpu'"):
            stage.transform(pt)


def test_unroll_and_augmenter_match_jax():
    jt, pt = _tables(n=3, h=2, w=3)
    want = JUnroll().transform(jt)["unrolled"]
    got = UnrollImage().transform(pt)["unrolled"]
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_array_equal(g, w)
    for lr, ud, n in ((True, False, 6), (True, True, 12), (False, True, 6)):
        a = ImageSetAugmenter(flipLeftRight=lr, flipUpDown=ud).transform(pt)
        b = JAugmenter(flipLeftRight=lr, flipUpDown=ud).transform(jt)
        assert len(a) == len(b) == n
        for g, w in zip(_images(a), _images(b)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("stage", ["transformer", "unroll", "augmenter"])
def test_image_stages_save_and_load_across_packages(stage, tmp_path):
    """A stage saved by either package loads in the other and gives the
    same images."""
    from mmlspark_tpu.core.stage import load_stage as jload
    jt, pt = _tables(n=3)
    make = {"transformer": (
                lambda: ImageTransformer(device="cpu").resize(8, 6).flip(0),
                lambda: JTransformer().resize(8, 6).flip(0)),
            "unroll": (UnrollImage, JUnroll),
            "augmenter": (lambda: ImageSetAugmenter(flipUpDown=True),
                          lambda: JAugmenter(flipUpDown=True))}[stage]
    col = "unrolled" if stage == "unroll" else "image"

    def values(table):
        return [np.asarray(v if stage == "unroll" else v[ImageSchema.DATA])
                for v in table[col]]
    port, ref = make[0](), make[1]()
    port.save(str(tmp_path / "port"))
    ref.save(str(tmp_path / "ref"))
    from_ref = mtt.load_stage(str(tmp_path / "ref"))
    assert type(from_ref).__module__.startswith("mmlspark_tpu_torch.")
    if stage == "transformer":
        from_ref.set("device", "cpu")
    from_port = jload(str(tmp_path / "port"))
    assert type(from_port).__module__.startswith("mmlspark_tpu.")
    for a, b in zip(values(from_ref.transform(pt)),
                    values(port.transform(pt))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(values(from_port.transform(jt)),
                    values(ref.transform(jt))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# readers (test_image_pipeline's io tests through both packages)
# ---------------------------------------------------------------------------


def _image_dir(tmp_path):
    import cv2
    d = tmp_path / "imgs"
    (d / "sub").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(3):
        cv2.imwrite(str(d / f"a_{i}.png"),
                    rng.integers(0, 256, (10, 12, 3), dtype=np.uint8))
    yy, xx = np.mgrid[0:16, 0:16]
    cv2.imwrite(str(d / "sub" / "b.jpg"),
                np.stack([yy * 9, xx * 9, yy + xx], -1).astype(np.uint8))
    (d / "junk.txt").write_text("not an image")
    (d / "broken.png").write_bytes(b"\x89PNG but not really")
    img_path = tmp_path / "x.png"
    cv2.imwrite(str(img_path), rng.integers(0, 256, (8, 8, 3),
                                            dtype=np.uint8))
    with zipfile.ZipFile(d / "arch.zip", "w") as zf:
        zf.write(img_path, "inner/y.png")
        zf.writestr("inner/z.txt", "text")
    return d


def _same_table(got, want, col, fields):
    assert len(got) == len(want)
    for g, w in zip(got[col], want[col]):
        if w is None:
            assert g is None
            continue
        for f in fields:
            if isinstance(w[f], np.ndarray):
                assert g[f].dtype == w[f].dtype
                np.testing.assert_array_equal(g[f], w[f])
            else:
                assert g[f] == w[f]


def test_read_images_and_binary_files_match_jax(tmp_path):
    d = str(_image_dir(tmp_path))
    fields = list(ImageSchema.FIELDS)
    names = [f.name for f in fields]
    for kw in ({}, {"recursive": False}, {"inspect_zip": False},
               {"drop_undecodable": False},
               {"sample_ratio": 0.5, "seed": 3}):
        got, want = read_images(d, **kw), jread_images(d, **kw)
        _same_table(got, want, "image", names)
    t = read_images(d)
    assert len(t) == 5                 # 3 png + sub/b.jpg + zipped y.png
    assert t["image"][0][ImageSchema.MODE] == "BGR"
    for kw in ({}, {"pattern": "*.txt"}, {"recursive": False},
               {"inspect_zip": False}, {"sample_ratio": 0.5, "seed": 1},
               {"column_name": "v"}):
        col = kw.get("column_name", "value")
        got, want = read_binary_files(d, **kw), jread_binary(d, **kw)
        _same_table(got, want, col, ["path", "bytes"])
    assert len(read_binary_files(d, pattern="*.txt")) == 2
    assert len(read_binary_files("file://" + d)) == len(
        read_binary_files(d))
    empty = read_binary_files(d, pattern="*.nothing")
    assert len(empty) == 0 and "value" in empty.schema.names
    # a scheme with no registered filesystem: the same refusal in both
    with pytest.raises(KeyError, match="register_filesystem"):
        read_binary_files("s3://bucket/imgs")
    with pytest.raises(KeyError, match="register_filesystem"):
        jread_binary("s3://bucket/imgs")


def test_write_images_round_trip(tmp_path):
    from mmlspark_tpu_torch.io.image import write_images
    _, pt = _tables(n=3)
    write_images(pt, str(tmp_path / "out"))
    back = read_images(str(tmp_path / "out"))
    assert sorted(os.listdir(tmp_path / "out")) == [
        "img_0.png", "img_1.png", "img_2.png"]
    for r in back["image"]:
        i = int(Path(r[ImageSchema.PATH]).stem.split("_")[1])
        np.testing.assert_array_equal(r[ImageSchema.DATA],
                                      pt["image"][i][ImageSchema.DATA])


# ---------------------------------------------------------------------------
# rules of the port
# ---------------------------------------------------------------------------


def test_image_path_runs_with_jax_flax_and_msgpack_blocked(tmp_path):
    """The readers, the image stages, the zoo and the featurizer in a
    process where jax, flax, msgpack, ml_dtypes and the JAX package
    cannot be imported."""
    code = f"""
import sys
for m in ("jax", "jaxlib", "flax", "msgpack", "ml_dtypes", "mmlspark_tpu"):
    sys.modules[m] = None
import numpy as np, torch
import mmlspark_tpu_torch as mtt
from mmlspark_tpu_torch.importers.torch_import import (
    TORCHVISION_RESNET18_SPEC, _torchvision_manifest, import_torchvision_resnet)
from PIL import Image
d = {str(tmp_path)!r}
rng = np.random.default_rng(0)
for i in range(4):
    Image.fromarray(rng.integers(0, 256, (20 + i, 24, 3), dtype=np.uint8)
                    ).save(f"{{d}}/im{{i}}.png")
t = mtt.read_images(d)
assert len(t) == 4
t = mtt.ImageTransformer(device="cpu").resize(16, 16).flip().transform(t)
g = torch.Generator().manual_seed(0)
sd = {{k: torch.randn(s, generator=g) * 0.05 if len(s) > 1 else
       torch.rand(s, generator=g) + 0.5
       for k, s in _torchvision_manifest([2, 2, 2, 2], 1000).items()}}
v = import_torchvision_resnet(sd)
repo = mtt.LocalRepo(d + "/repo")
schema = repo.publish("r18", TORCHVISION_RESNET18_SPEC, v,
                      input_shape=[32, 32, 3])
dl = mtt.ModelDownloader(d + "/cache", repo=repo)
f = mtt.ImageFeaturizer.from_model_schema(schema, dl, device="cpu",
                                          batchSize=4).transform(t)
assert f["features"].shape == (4, 512) and np.isfinite(f["features"]).all()
assert not any(m.split(".")[0] in ("jax", "flax", "msgpack", "ml_dtypes",
                                   "mmlspark_tpu")
               for m, v in sys.modules.items() if v is not None)
print("OK")
"""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(REPO), timeout=300)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
