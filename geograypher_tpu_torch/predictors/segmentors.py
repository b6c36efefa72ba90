"""Segmentor input adapters: the port's own copies of the segmentors of
``geograypher_tpu/predictors/segmentors.py`` (numpy only: no pandas, no
cv2).

A :class:`Segmentor` turns a camera's raw image into per-pixel prediction
data (one-hot class maps, detection-index rasters, image-id rasters), so
the aggregation engine stays agnostic to the prediction source.  The
detection segmentors read CSV tables with the stdlib ``csv`` module
(:class:`Table`, the few parts of a DataFrame they use) and fill polygons
with :func:`~geograypher_tpu_torch.utils.polyfill.fill_poly`, cv2's
``fillPoly`` in numpy.
"""

from __future__ import annotations

import csv
import json
import typing
from pathlib import Path

import numpy as np

from geograypher_tpu_torch.constants import PATH_TYPE
from geograypher_tpu_torch.utils.io import read_image_or_numpy, resize_nearest


class Segmentor:
    """Abstract per-image predictor (reference segmentor.py:6-69)."""

    # does segment_image consume the raw pixels?  The segmentor camera
    # set skips the disk read + resize entirely when False (the
    # reference's dont_load_base_image=True default) — only pixel-driven
    # segmentors (brightness-style) set this True
    needs_image = False

    def __init__(self, num_classes: typing.Optional[int] = None):
        self.num_classes = num_classes

    def segment_image(
        self, image: np.ndarray, filename=None, image_scale: float = 1.0, **kwargs
    ) -> np.ndarray:
        raise NotImplementedError()

    def segment_images_batch(self, images, filenames=None, **kwargs):
        filenames = filenames or [None] * len(images)
        return [
            self.segment_image(im, filename=fn, **kwargs)
            for im, fn in zip(images, filenames)
        ]

    @staticmethod
    def inds_to_one_hot(
        inds: np.ndarray, num_classes: typing.Optional[int] = None
    ) -> np.ndarray:
        """Integer class map -> (H, W, C) float one-hot with NaN for
        out-of-range (reference segmentor.py:37-69)."""
        if num_classes is None:
            num_classes = int(np.nanmax(inds)) + 1
        inds = np.asarray(inds)
        one_hot = np.stack(
            [(inds == c).astype(float) for c in range(num_classes)], axis=-1
        )
        invalid = ~np.isfinite(inds) | (inds < 0) | (inds >= num_classes)
        one_hot[invalid] = np.nan
        return one_hot


class LookUpSegmentor(Segmentor):
    """Loads precomputed label images from a parallel folder tree
    (reference derived_segmentors.py:32-51) — the standard vehicle for
    'aggregate ML predictions onto the mesh'."""

    def __init__(self, base_folder: PATH_TYPE, lookup_folder: PATH_TYPE,
                 num_classes: int = 10):
        super().__init__(num_classes=num_classes)
        self.base_folder = Path(base_folder)
        self.lookup_folder = Path(lookup_folder)

    def segment_image(self, image, filename=None, image_scale: float = 1.0, **kw):
        try:
            rel = Path(filename).relative_to(self.base_folder)
        except ValueError:
            try:  # mixed absolute/relative bases resolve the same tree
                rel = (
                    Path(filename)
                    .resolve()
                    .relative_to(self.base_folder.resolve())
                )
            except ValueError:
                rel = Path(Path(filename).name)
        candidates = [
            self.lookup_folder / rel.with_suffix(suffix)
            for suffix in (".png", ".npy", ".tif", Path(filename).suffix)
        ]
        path = next((c for c in candidates if c.exists()), None)
        if path is None:
            raise FileNotFoundError(f"No label file for {filename}")
        labels = read_image_or_numpy(path)
        if labels.ndim == 3:
            labels = labels[..., 0]
        if image is not None:
            h, w = np.asarray(image).shape[:2]  # already at image_scale
        else:
            # no raw image on disk (or loading skipped): scale the label
            # raster itself so output resolution matches image_scale —
            # otherwise mixed-availability surveys return mixed shapes
            h = int(round(labels.shape[0] * image_scale))
            w = int(round(labels.shape[1] * image_scale))
        if labels.shape != (h, w):
            labels = resize_nearest(labels.astype(np.float32), w, h)
        return self.inds_to_one_hot(labels.astype(float), self.num_classes)


class BrightnessSegmentor(Segmentor):
    """Toy threshold segmentor (reference derived_segmentors.py:19-29)."""

    needs_image = True

    def __init__(self, brightness_threshold: float = np.sqrt(0.75)):
        super().__init__(num_classes=2)
        self.brightness_threshold = brightness_threshold

    def segment_image(self, image, filename=None, image_scale: float = 1.0, **kw):
        img = np.asarray(image, dtype=float)
        if img.max() > 1.0:
            img = img / 255.0
        brightness = np.linalg.norm(img, axis=-1) if img.ndim == 3 else img
        inds = (brightness > self.brightness_threshold).astype(int)
        return self.inds_to_one_hot(inds, 2)


class ArraySegmentor(Segmentor):
    """In-memory label images by camera index (test/pipeline building
    block; plays the role of LookUpSegmentor without touching disk)."""

    def __init__(self, label_images, num_classes: int):
        super().__init__(num_classes=num_classes)
        self.label_images = list(label_images)

    def segment_image(self, image, filename=None, image_scale: float = 1.0,
                      index: typing.Optional[int] = None, **kw):
        labels = np.asarray(self.label_images[index], dtype=float)
        return self.inds_to_one_hot(labels, self.num_classes)


class ImageIDSegmentor(Segmentor):
    """Returns an image filled with the camera's index: face x image
    visibility matrices for set-cover image selection (reference
    derived_segmentors.py:54-81)."""

    def __init__(self, image_shape: typing.Tuple[int, int], num_images: int):
        super().__init__(num_classes=num_images)
        self.image_shape = image_shape

    def segment_image(self, image, filename=None, image_scale: float = 1.0,
                      index: typing.Optional[int] = None, **kw):
        if image is not None:
            # provided images already arrive at image_scale
            h, w = np.asarray(image).shape[:2]
        else:
            h, w = self.image_shape
            h, w = int(h * image_scale), int(w * image_scale)
        return np.full((h, w), float(index))


def _parse_column(values: typing.List[str]):
    """A CSV column as ``pd.read_csv`` types it: int64 when every cell is
    an integer, float64 when every cell is a number or empty (NaN), else
    the strings."""
    try:
        return np.array([int(v) for v in values], dtype=np.int64)
    except ValueError:
        pass
    try:
        return np.array([float(v) if v.strip() else np.nan for v in values],
                        dtype=np.float64)
    except ValueError:
        return list(values)


class Table:
    """A column table: the parts of a pandas DataFrame the detection
    workflow reads (``len``, ``in``, a column by name, a row as a dict
    through ``iloc``)."""

    def __init__(self, columns: typing.Optional[dict] = None):
        self.data = dict(columns or {})

    def __len__(self) -> int:
        return len(next(iter(self.data.values()))) if self.data else 0

    def __contains__(self, column) -> bool:
        return column in self.data

    def __getitem__(self, column):
        return self.data[column]

    def __setitem__(self, column, values) -> None:
        self.data[column] = values

    def row(self, i: int) -> dict:
        return {k: v[i] for k, v in self.data.items()}

    @property
    def iloc(self):
        table = self

        class _Rows:
            def __getitem__(self, i):
                return table.row(int(i))

        return _Rows()

    @staticmethod
    def read_csv(paths: typing.Sequence[PATH_TYPE]) -> "Table":
        """The rows of every CSV file in turn (``pd.concat`` of
        ``pd.read_csv``); a column missing from a file is empty (NaN)
        there."""
        header: typing.List[str] = []
        rows: typing.List[dict] = []
        for path in paths:
            with open(path, newline="") as fh:
                reader = csv.DictReader(fh)
                header += [c for c in (reader.fieldnames or []) if c not in header]
                rows += list(reader)
        return Table({c: _parse_column([r.get(c) or "" for r in rows])
                      for c in header})


class TabularRectangleSegmentor(Segmentor):
    """Detection bounding boxes from CSV files (DeepForest format),
    painted as per-detection-index rectangles (reference
    derived_segmentors.py:84-306)."""

    def __init__(
        self,
        pred_folder_or_file: PATH_TYPE,
        image_folder: typing.Optional[PATH_TYPE] = None,
        label_key: str = "label",
        image_path_key: str = "image_path",
        imin_key: str = "ymin",
        imax_key: str = "ymax",
        jmin_key: str = "xmin",
        jmax_key: str = "xmax",
        image_shape: typing.Tuple[int, int] = (4008, 6016),
    ):
        path = Path(pred_folder_or_file)
        files = sorted(path.glob("*.csv")) if path.is_dir() else [path]
        self.df = Table.read_csv(files)
        self.image_path_key = image_path_key
        self.label_key = label_key
        self.keys = (imin_key, imax_key, jmin_key, jmax_key)
        self.image_shape = image_shape
        # unpack packed "bbox" columns like "[x0, y0, x1, y1]"
        if "bbox" in self.df and jmin_key not in self.df:
            vals = np.array(
                [
                    json.loads(str(b).replace("(", "[").replace(")", "]"))
                    for b in self.df["bbox"]
                ]
            )
            self.df[jmin_key], self.df[imin_key] = vals[:, 0], vals[:, 1]
            self.df[jmax_key], self.df[imax_key] = vals[:, 2], vals[:, 3]
        self.df["_det_index"] = np.arange(len(self.df))
        super().__init__(num_classes=len(self.df))
        # row indices by the image path's file name, in file order
        groups: typing.Dict[str, list] = {}
        if len(self.df):
            for i, p in enumerate(self.df[image_path_key]):
                groups.setdefault(Path(str(p)).name, []).append(i)
        self.grouped = {k: np.array(v) for k, v in groups.items()}

    def _rows(self, filename) -> typing.Optional[np.ndarray]:
        return self.grouped.get(Path(str(filename)).name)

    def get_detection_centers(self, filename) -> np.ndarray:
        """(N, 2) detection centers (i, j) for an image file
        (reference derived_segmentors.py:278-306)."""
        rows = self._rows(filename)
        if rows is None:
            return np.zeros((0, 2))
        imin, imax, jmin, jmax = (np.asarray(self.df[k])[rows] for k in self.keys)
        return np.stack([(imin + imax) / 2, (jmin + jmax) / 2], axis=1)

    def segment_image(self, image, filename=None, image_scale: float = 1.0, **kw):
        if image is not None:
            # the provided image already arrives at image_scale
            h, w = np.asarray(image).shape[:2]
        else:
            h = int(self.image_shape[0] * image_scale)
            w = int(self.image_shape[1] * image_scale)
        out = np.full((h, w), np.nan)
        rows = self._rows(filename)
        if rows is not None:
            for r in rows:
                row = self.df.row(int(r))
                i0 = int(row[self.keys[0]] * image_scale)
                i1 = int(row[self.keys[1]] * image_scale)
                j0 = int(row[self.keys[2]] * image_scale)
                j1 = int(row[self.keys[3]] * image_scale)
                out[max(i0, 0) : i1, max(j0, 0) : j1] = row["_det_index"]
        return out


class RegionDetectionSegmentor(Segmentor):
    """Per-image polygon detections from vector files matched by filename
    (reference derived_segmentors.py:309-462)."""

    def __init__(
        self,
        detection_folder: PATH_TYPE,
        image_folder: typing.Optional[PATH_TYPE] = None,
        image_shape: typing.Tuple[int, int] = (4008, 6016),
    ):
        from geograypher_tpu_torch.utils.vector import VectorData

        self.files = {}
        det_index = 0
        for f in sorted(Path(detection_folder).glob("*")):
            if f.suffix.lower() in (".geojson", ".json", ".gpkg", ".shp"):
                vd = VectorData.read_file(f)
                self.files[f.stem] = (vd, det_index)
                det_index += len(vd)
        self.image_shape = image_shape
        super().__init__(num_classes=det_index)

    def _lookup(self, filename):
        return self.files.get(Path(str(filename)).stem)

    def get_detection_centers(self, filename) -> np.ndarray:
        entry = self._lookup(filename)
        if entry is None:
            return np.zeros((0, 2))
        vd, _ = entry
        centers = []
        for g in vd.geometries:
            cx, cy = g.centroid  # (x=j, y=i) pixel coords in vector files
            centers.append((cy, cx))
        return np.asarray(centers)

    def segment_image(self, image, filename=None, image_scale: float = 1.0, **kw):
        from geograypher_tpu_torch.utils.polyfill import fill_poly

        if image is not None:
            # the provided image already arrives at image_scale
            h, w = np.asarray(image).shape[:2]
        else:
            h = int(self.image_shape[0] * image_scale)
            w = int(self.image_shape[1] * image_scale)
        out = np.full((h, w), np.nan, dtype=np.float64)
        entry = self._lookup(filename)
        if entry is not None:
            vd, base = entry
            buf = np.full((h, w), -1, np.int32)
            for k, g in enumerate(vd.geometries):
                pts = np.round(g.exterior * image_scale).astype(np.int32)
                fill_poly(buf, pts, base + k)
            out[buf >= 0] = buf[buf >= 0]
        return out
