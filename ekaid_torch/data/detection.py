"""Detection-annotation loaders: Chest ImaGenome silver/gold + VinDr CSVs
(counterpart of `ekaid_tpu/data/detection.py`). pandas and PIL are
imported by the functions that need them, not by the module.

Parity targets:
  * get_mimic_ana_dicts (train_anatomy.py:148-232): the silver scene-
    graph directory — one JSON per image with `image_id` and `objects`
    whose x1/y1/x2/y2 are in the 224-resize-with-padding frame; boxes
    are mapped back to original-pixel coordinates (undoing the pad+
    resize, get_Ratio/get_Original_Coordinates, train_anatomy.py:105-134)
    then rescaled to the 1024² PNGs. This is the reference's PRIMARY
    anatomy-training data path (thousands of images); gold is stage 2.
  * get_mimic_ana_gold_dicts (train_anatomy.py:257-345): the gold 1000-
    image CSV with columns image_id (with extension), bbox_name,
    original_x1/y1/x2/y2, coordinates rescaled to the 1024² PNGs by the
    original image shape; 26 anatomy classes from get_kg2 order.
  * get_vindr_dicts (train_vindr.py:65-130): annotations_<split>.csv with
    image_id, class_name, x_min/y_min/x_max/y_max (empty for
    'No finding' rows), rescaled to 1024²; 22 disease classes.

DOCUMENTED DEVIATION: the reference's silver loader assigns category ids
in first-seen order over the JSON stream (train_anatomy.py:212-214),
which need not agree with the gold/extraction class order from get_kg2.
Here both stages use the fixed ANATOMY_DETECTOR_CLASSES order so silver-
pretrained and gold-finetuned checkpoints share one label space.

Output is the padded-array contract used by DetectorTrainer:
(file_names, boxes [N, G, 4], classes [N, G], valid [N, G]).
Rows with malformed coordinates (x1 > x2 etc.) are dropped, as the
reference does (train_anatomy.py:320-322).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ekaid_torch.data.knowledge import ANATOMY_CLASSES, DISEASE_CLASSES

# the 26 detector classes exclude the KG's stray 'edema' entry
ANATOMY_DETECTOR_CLASSES = [c for c in ANATOMY_CLASSES if c != "edema"]


def _pack(records: Dict[str, List[Tuple[List[float], int]]],
          max_gt: int):
    names = sorted(records)
    n = len(names)
    boxes = np.zeros((n, max_gt, 4), np.float32)
    classes = np.zeros((n, max_gt), np.int32)
    valid = np.zeros((n, max_gt), bool)
    for i, name in enumerate(names):
        for j, (bb, cls) in enumerate(records[name][:max_gt]):
            boxes[i, j] = bb
            classes[i, j] = cls
            valid[i, j] = True
    return names, boxes, classes, valid


def _scale_box(x1, y1, x2, y2, w, h, size):
    sx, sy = size / float(w), size / float(h)
    return [float(x1) * sx, float(y1) * sy, float(x2) * sx,
            float(y2) * sy]


def load_imagenome_gold(csv_path: str,
                        shapes: Optional[Dict[str, Tuple[int, int]]] = None,
                        image_size: int = 1024, max_gt: int = 32):
    """Gold anatomy annotations. `shapes`: image_id -> (width, height)
    originals (mimic_shape_full equivalent); identity scaling if None."""
    import pandas as pd
    df = pd.read_csv(csv_path)
    label2id = {c: i for i, c in enumerate(ANATOMY_DETECTOR_CLASSES)}
    recs: Dict[str, List] = {}
    for row in df.itertuples(index=False):
        image_id = os.path.splitext(str(row.image_id))[0]
        name = str(row.bbox_name).lower()
        if name not in label2id:
            continue
        x1 = getattr(row, "original_x1", None)
        if x1 is None or (isinstance(x1, float) and np.isnan(x1)):
            continue
        w, h = (shapes or {}).get(image_id, (image_size, image_size))
        bb = _scale_box(row.original_x1, row.original_y1,
                        row.original_x2, row.original_y2, w, h,
                        image_size)
        if bb[0] > bb[2] or bb[1] > bb[3]:
            continue                      # train_anatomy.py:320-322
        recs.setdefault(image_id, []).append((bb, label2id[name]))
    return _pack(recs, max_gt)


def load_shapes(pkl_path: str) -> Dict[str, Tuple[int, int]]:
    """mimic_shape_full.pkl → {image_id: (height, width)}. Accepts both
    the reference layout ({'image','height','width'},
    train_anatomy.py:97-103 convert_shape) and ours
    ({'image','shape': (h, w)}, data/images.py)."""
    import pickle
    with open(pkl_path, "rb") as f:
        items = pickle.load(f)
    out = {}
    for it in items:
        if "shape" in it:
            out[it["image"]] = tuple(it["shape"])
        else:
            out[it["image"]] = (it["height"], it["width"])
    return out


def _unpad_224(x1, y1, x2, y2, orig_h: int, orig_w: int):
    """Map a box from the 224×224 resize-with-padding frame back to
    original pixels (train_anatomy.py:105-134 get_Ratio +
    get_Original_Coordinates, including the int() truncations)."""
    ratio = 224.0 / max(orig_h, orig_w)
    new_h, new_w = int(orig_h * ratio), int(orig_w * ratio)
    top = (224 - new_h) // 2
    left = (224 - new_w) // 2
    scale = 1.0 / ratio
    ox1 = int(scale * (x1 - left))
    ox2 = int(scale * (x2 - left))
    oy1 = int(scale * (y1 - top))
    oy2 = int(scale * (y2 - top))
    return ox1, oy1, ox2, oy2


def load_imagenome_silver(scene_graph_dir: str,
                          shapes: Dict[str, Tuple[int, int]],
                          image_size: int = 1024, max_gt: int = 32,
                          limit: Optional[int] = None):
    """Silver scene-graph loader (get_mimic_ana_dicts parity,
    train_anatomy.py:148-232).

    scene_graph_dir: directory of per-image `<dicom>_SceneGraph.json`
    files with {'image_id', 'objects': [{'name', 'x1','y1','x2','y2'}]}.
    shapes: image_id -> (height, width) of the ORIGINAL image
    (mimic_shape_full.pkl equivalent; note (h, w) order,
    train_anatomy.py:97-103). Images whose shape is unknown are skipped,
    as the reference does (train_anatomy.py:188-191).
    """
    import json
    label2id = {c: i for i, c in enumerate(ANATOMY_DETECTOR_CLASSES)}
    recs: Dict[str, List] = {}
    files = sorted(os.listdir(scene_graph_dir))
    if limit is not None:
        files = files[:limit]
    skipped = 0
    for fname in files:
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(scene_graph_dir, fname)) as f:
            data = json.load(f)
        image_id = str(data["image_id"])
        if image_id not in shapes:
            skipped += 1
            continue
        h, w = shapes[image_id]
        objs = recs.setdefault(image_id, [])
        for obj in data.get("objects", []):
            name = str(obj["name"]).lower()
            if name not in label2id:
                continue
            ox1, oy1, ox2, oy2 = _unpad_224(
                obj["x1"], obj["y1"], obj["x2"], obj["y2"], h, w)
            bb = [ox1 * (image_size / w), oy1 * (image_size / h),
                  ox2 * (image_size / w), oy2 * (image_size / h)]
            if bb[0] > bb[2] or bb[1] > bb[3]:
                continue
            objs.append((bb, label2id[name]))
    if skipped:
        print(f"load_imagenome_silver: skipped {skipped} images with "
              f"unknown original shape")
    return _pack(recs, max_gt)


def load_vindr(csv_path: str,
               shapes: Optional[Dict[str, Tuple[int, int]]] = None,
               image_size: int = 1024, max_gt: int = 32):
    """VinDr-CXR annotations; 'No finding' rows (empty x_min) skipped."""
    import pandas as pd
    df = pd.read_csv(csv_path)
    label2id = {c: i for i, c in enumerate(DISEASE_CLASSES)}
    recs: Dict[str, List] = {}
    for row in df.itertuples(index=False):
        image_id = str(row.image_id)
        name = str(row.class_name).lower()
        if name not in label2id:
            continue
        if row.x_min is None or (isinstance(row.x_min, float)
                                 and np.isnan(row.x_min)):
            continue
        w, h = (shapes or {}).get(image_id, (image_size, image_size))
        bb = _scale_box(row.x_min, row.y_min, row.x_max, row.y_max, w, h,
                        image_size)
        if bb[0] > bb[2] or bb[1] > bb[3]:
            continue
        recs.setdefault(image_id, []).append((bb, label2id[name]))
    return _pack(recs, max_gt)


class ImageBoxDataset:
    """On-the-fly PNG loader over packed annotations (for
    DetectorTrainer.fit via `materialize`)."""

    def __init__(self, names, boxes, classes, valid, image_dir: str,
                 image_size: int):
        self.names = names
        self.boxes = boxes
        self.classes = classes
        self.valid = valid
        self.image_dir = image_dir
        self.image_size = image_size

    def load_images(self, idxs) -> np.ndarray:
        from PIL import Image
        out = []
        for i in idxs:
            p = os.path.join(self.image_dir, self.names[i] + ".png")
            img = Image.open(p).convert("RGB")
            if img.size != (self.image_size, self.image_size):
                img = img.resize((self.image_size, self.image_size))
            out.append(np.asarray(img, np.float32) / 255.0)
        return np.stack(out)

    def materialize(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
        """Load every image into RAM (fine for the 1000-image gold set)."""
        imgs = self.load_images(range(len(self.names)))
        return imgs, self.boxes, self.classes, self.valid
