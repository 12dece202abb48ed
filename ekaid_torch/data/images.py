"""Raw-image ingest: DICOM/JPG/PNG -> fixed-size PNG (counterpart of
`ekaid_tpu/data/images.py`).

`convert_tree` resizes every image under a directory to a square PNG
named after its stem, on a thread pool, and writes two index files
beside them:
  * `mimic_shape_full.pkl`: [{'image': stem, 'shape': (height, width)}]
    in file order (the original sizes, which the detector's silver
    labels are scaled from);
  * `dicom2id.pkl`: {stem: i}, the file's position in that order.

The order is `os.walk`'s: each directory's names sorted, the files of a
directory before those of its subdirectories, and the subdirectories in
the order the file system lists them. The extraction runner writes its
HDF5 rows in the sorted order of the PNG names (`extract/runner.py::
list_images`), so for a flat directory of unique stems row i is
`dicom2id` i; for nested directories the two orders can differ, as in
the reference.

Host only: PIL decodes and resizes (imported when used). DICOM needs
pydicom, and without it `read_xray` raises the reference's ImportError.
"""

from __future__ import annotations

import argparse
import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np


def read_xray(path: str, voi_lut: bool = True,
              fix_monochrome: bool = True) -> np.ndarray:
    """A DICOM file -> uint8 array: the VOI LUT applied, MONOCHROME1
    inverted, then scaled to 0..255."""
    try:
        import pydicom
        from pydicom.pixel_data_handlers.util import apply_voi_lut
    except ImportError as e:
        raise ImportError(
            "pydicom is not installed; DICOM ingest is unavailable in "
            "this environment (JPG/PNG paths work)") from e
    dicom = pydicom.read_file(path)
    data = (apply_voi_lut(dicom.pixel_array, dicom) if voi_lut
            else dicom.pixel_array)
    if fix_monochrome and dicom.PhotometricInterpretation == "MONOCHROME1":
        data = np.amax(data) - data
    data = data - np.min(data)
    data = (data / np.max(data) * 255).astype(np.uint8)
    return data


def resize_image(img, size: int = 1024):
    """A PIL image (or an array) resized to size x size with PIL's
    default filter."""
    from PIL import Image
    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    return img.resize((size, size))


def convert_tree(in_dir: str, out_dir: str, size: int = 1024,
                 exts: Tuple[str, ...] = (".jpg", ".jpeg", ".png",
                                          ".dcm"),
                 workers: int = 8,
                 limit: Optional[int] = None) -> int:
    """Convert every image under in_dir to out_dir/<stem>.png (grayscale,
    size x size) and write the two index files; returns the count."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    files: List[str] = []
    for root, _, names in os.walk(in_dir):
        for n in sorted(names):
            if n.lower().endswith(exts):
                files.append(os.path.join(root, n))
    if limit:
        files = files[:limit]

    shapes = [None] * len(files)
    dicom2id = {}

    def one(i_path):
        i, path = i_path
        stem = os.path.splitext(os.path.basename(path))[0]
        if path.lower().endswith(".dcm"):
            img = Image.fromarray(read_xray(path))
        else:
            img = Image.open(path).convert("L")
        orig = (img.height, img.width)
        resize_image(img, size).save(os.path.join(out_dir, stem + ".png"))
        return i, stem, orig

    with ThreadPoolExecutor(max_workers=workers) as pool:
        for i, stem, orig in pool.map(one, enumerate(files)):
            shapes[i] = {"image": stem, "shape": orig}
            dicom2id[stem] = i

    with open(os.path.join(out_dir, "mimic_shape_full.pkl"), "wb") as f:
        pickle.dump(shapes, f)
    with open(os.path.join(out_dir, "dicom2id.pkl"), "wb") as f:
        pickle.dump(dicom2id, f)
    return len(files)


def main(argv=None):
    p = argparse.ArgumentParser(description="DICOM/JPG -> PNG converter")
    p.add_argument("-p", "--in_dir", required=True)
    p.add_argument("-o", "--out_dir", required=True)
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--limit", type=int, default=None)
    a = p.parse_args(argv)
    n = convert_tree(a.in_dir, a.out_dir, a.size, workers=a.workers,
                     limit=a.limit)
    print(f"converted {n} images to {a.out_dir}")


if __name__ == "__main__":
    main()
