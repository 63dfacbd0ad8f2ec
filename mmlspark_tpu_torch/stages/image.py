"""Image pipeline stages of the PyTorch port: ImageTransformer,
UnrollImage, ImageSetAugmenter (see ``mmlspark_tpu/stages/image.py``).

Analog of the reference's image-transformer component
(ref: src/image-transformer/src/main/scala/ImageTransformer.scala:34-370,
UnrollImage.scala:16-43, ImageSetAugmenter.scala).

``ImageTransformer`` stacks a uniform-size image column into one NHWC
uint8 batch, uploads it once, runs the whole op list on the device,
rounds and clips to uint8 there and reads the result back once. A ragged
column, or an op list with a host-only op, runs per image on the host
(numpy). The ``device`` param is the card by default (``None`` = cuda):
without one the stage raises, whichever path the column takes, unless
``device='cpu'`` was asked for. The op list is a plain JSON-able param,
so the stage saves and loads in either package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.params import (
    BoolParam, HasInputCol, HasOutputCol, ListParam, StringParam,
)
from mmlspark_tpu_torch.core.schema import Field, ImageSchema, Schema, VECTOR
from mmlspark_tpu_torch.core.stage import Transformer
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.device import resolve_device
from mmlspark_tpu_torch.ops import image_ops as ops

# op name -> (host_fn(img, **kw), batch_fn(imgs, **kw) or None)
_OP_TABLE = {
    "resize": (lambda im, **k: ops.resize_host(im, k["height"], k["width"]),
               lambda b, **k: ops.resize_batch(b, k["height"], k["width"])),
    "crop": (lambda im, **k: ops.crop_host(im, k["x"], k["y"],
                                           k["height"], k["width"]),
             lambda b, **k: ops.crop_batch(b, k["x"], k["y"],
                                           k["height"], k["width"])),
    "center_crop": (lambda im, **k: ops.center_crop_host(
                        im, k["height"], k["width"]), None),
    "color_format": (lambda im, **k: ops.color_convert_host(im, k["format"]),
                     lambda b, **k: ops.color_convert_batch(b, k["format"])),
    "flip": (lambda im, **k: ops.flip_host(im, k["flip_code"]),
             lambda b, **k: ops.flip_batch(b, k["flip_code"])),
    "blur": (lambda im, **k: ops.box_blur_host(im, k["height"], k["width"]),
             lambda b, **k: ops.box_blur_batch(b, k["height"], k["width"])),
    "threshold": (lambda im, **k: ops.threshold_host(
                      im, k["threshold"], k["max_val"], k["kind"]),
                  lambda b, **k: ops.threshold_batch(
                      b, k["threshold"], k["max_val"], k["kind"])),
    "gaussian_kernel": (lambda im, **k: ops.gaussian_blur_host(
                            im, k["aperture"], k["sigma"]),
                        lambda b, **k: ops.gaussian_blur_batch(
                            b, k["aperture"], k["sigma"])),
}


def _op_kwargs(spec: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in spec.items() if k != "op"}


class ImageTransformer(Transformer, HasInputCol, HasOutputCol):
    """Apply a pipeline of image ops to an image column.

    Builder-style API mirroring the reference stage
    (ref: ImageTransformer.scala:208-370)::

        ImageTransformer(inputCol="image").resize(32, 32).flip()
    """

    stages = ListParam("ordered list of image op descriptors", default=None)
    device = StringParam(
        "torch device of the uniform-batch path: None = 'cuda' (raises "
        "when no card is present) or 'cpu' (explicit opt-in)", default=None)

    def __init__(self, **kw):
        kw.setdefault("inputCol", "image")
        kw.setdefault("outputCol", "image")
        super().__init__(**kw)

    # builder methods -------------------------------------------------------

    def _add(self, op: str, **kw) -> "ImageTransformer":
        lst = list(self.get("stages") or [])
        lst.append({"op": op, **kw})
        self.set("stages", lst)
        return self

    def resize(self, height: int, width: int) -> "ImageTransformer":
        return self._add("resize", height=int(height), width=int(width))

    def crop(self, x: int, y: int, height: int, width: int) -> "ImageTransformer":
        return self._add("crop", x=int(x), y=int(y),
                         height=int(height), width=int(width))

    def center_crop(self, height: int, width: int) -> "ImageTransformer":
        return self._add("center_crop", height=int(height), width=int(width))

    def color_format(self, fmt: str) -> "ImageTransformer":
        return self._add("color_format", format=fmt)

    def flip(self, flip_code: int = 1) -> "ImageTransformer":
        return self._add("flip", flip_code=int(flip_code))

    def blur(self, height: int, width: int) -> "ImageTransformer":
        return self._add("blur", height=int(height), width=int(width))

    def threshold(self, threshold: float, max_val: float = 255.0,
                  kind: str = "binary") -> "ImageTransformer":
        return self._add("threshold", threshold=float(threshold),
                         max_val=float(max_val), kind=kind)

    def gaussian_kernel(self, aperture: int, sigma: float = 0.0
                        ) -> "ImageTransformer":
        return self._add("gaussian_kernel", aperture=int(aperture),
                         sigma=float(sigma))

    # execution -------------------------------------------------------------

    def _apply_host(self, img: np.ndarray) -> np.ndarray:
        for spec in self.get("stages") or []:
            img = _OP_TABLE[spec["op"]][0](img, **_op_kwargs(spec))
        return img

    def _batchable(self) -> bool:
        return all(_OP_TABLE[s["op"]][1] is not None
                   for s in (self.get("stages") or []))

    def _apply_batch(self, batch: torch.Tensor) -> torch.Tensor:
        """The op list on an NHWC batch."""
        for spec in self.get("stages") or []:
            batch = _OP_TABLE[spec["op"]][1](batch, **_op_kwargs(spec))
        return batch

    def _run_batch(self, batch: np.ndarray, dev: torch.device) -> np.ndarray:
        """One upload, the composed op list, uint8 rounding and one
        readback."""
        x = torch.from_numpy(batch).to(dev)
        with torch.inference_mode():
            out = self._apply_batch(x)
            out = torch.round(out.float()).clamp_(0, 255).to(torch.uint8)
        return out.cpu().numpy()

    def transform(self, table: DataTable) -> DataTable:
        dev = resolve_device(self.get("device"))
        in_col = self.get_input_col()
        out_col = self.get_output_col()
        rows = list(table[in_col])

        shapes = {None if r is None else
                  np.asarray(r[ImageSchema.DATA]).shape for r in rows}
        shapes.discard(None)
        uniform = len(shapes) == 1 and self._batchable() and len(rows) > 0 \
            and all(r is not None for r in rows)

        out_rows: List[Optional[Dict[str, Any]]] = []
        if uniform:
            result = self._run_batch(np.stack(
                [np.asarray(r[ImageSchema.DATA]) for r in rows]), dev)
            for r, img in zip(rows, result):
                out_rows.append(ImageSchema.make_row(
                    r[ImageSchema.PATH], img,
                    self._out_mode(r[ImageSchema.MODE])))
        else:
            for r in rows:
                if r is None:
                    out_rows.append(None)
                    continue
                img = self._apply_host(np.asarray(r[ImageSchema.DATA]))
                img = np.clip(np.round(img), 0, 255).astype(np.uint8)
                out_rows.append(ImageSchema.make_row(
                    r[ImageSchema.PATH], img,
                    self._out_mode(r[ImageSchema.MODE])))
        return table.with_column(out_col, out_rows,
                                 ImageSchema.field(out_col))

    def _out_mode(self, mode: str) -> str:
        for spec in self.get("stages") or []:
            if spec["op"] == "color_format":
                fmt = spec["format"].upper()
                if fmt.endswith("GRAY"):
                    mode = "GRAY"
                elif fmt.endswith("RGB"):
                    mode = "RGB"
                elif fmt.endswith("BGR"):
                    mode = "BGR"
        return mode

    def transform_schema(self, schema: Schema) -> Schema:
        f = schema[self.get_input_col()]
        if not ImageSchema.is_image(f):
            raise TypeError(
                f"column {self.get_input_col()!r} is not an image column")
        return schema.add_or_replace(ImageSchema.field(self.get_output_col()))


class UnrollImage(Transformer, HasInputCol, HasOutputCol):
    """Image struct column -> flat CHW float vector column
    (ref: UnrollImage.scala:16-43 byte order). Host only."""

    def __init__(self, **kw):
        kw.setdefault("inputCol", "image")
        kw.setdefault("outputCol", "unrolled")
        super().__init__(**kw)

    def transform(self, table: DataTable) -> DataTable:
        vecs = []
        for r in table[self.get_input_col()]:
            if r is None:
                vecs.append(None)
            else:
                vecs.append(ops.unroll_host(np.asarray(r[ImageSchema.DATA])))
        return table.with_column(self.get_output_col(), vecs,
                                 Field(self.get_output_col(), VECTOR))

    def transform_schema(self, schema: Schema) -> Schema:
        f = schema[self.get_input_col()]
        if not ImageSchema.is_image(f):
            raise TypeError(
                f"column {self.get_input_col()!r} is not an image column")
        return schema.add_or_replace(Field(self.get_output_col(), VECTOR))


class ImageSetAugmenter(Transformer, HasInputCol, HasOutputCol):
    """Augment an image dataset with flipped copies
    (ref: ImageSetAugmenter.scala — flipLeftRight doubles rows,
    flipUpDown doubles again). Host only."""

    flipLeftRight = BoolParam("emit left-right flipped copies", default=True)
    flipUpDown = BoolParam("emit up-down flipped copies", default=False)

    def __init__(self, **kw):
        kw.setdefault("inputCol", "image")
        kw.setdefault("outputCol", "image")
        super().__init__(**kw)

    def transform(self, table: DataTable) -> DataTable:
        in_col = self.get_input_col()
        out_col = self.get_output_col()
        base = table
        if out_col != in_col:
            base = table.with_column(out_col, table[in_col],
                                     ImageSchema.field(out_col))
        parts = [base]
        if self.get("flipLeftRight"):
            parts.append(self._flipped(base, out_col, 1))
        if self.get("flipUpDown"):
            parts = parts + [self._flipped(p, out_col, 0) for p in list(parts)]
        return DataTable.concat(parts)

    def _flipped(self, table: DataTable, col: str, code: int) -> DataTable:
        rows = []
        for r in table[col]:
            if r is None:
                rows.append(None)
            else:
                img = ops.flip_host(np.asarray(r[ImageSchema.DATA]), code)
                rows.append(ImageSchema.make_row(
                    r[ImageSchema.PATH], img, r[ImageSchema.MODE]))
        return table.with_column(col, rows, ImageSchema.field(col))

    def transform_schema(self, schema: Schema) -> Schema:
        return schema.add_or_replace(ImageSchema.field(self.get_output_col()))
