"""Expert knowledge tables for the semantic difference graph.

The port's own copy of `ekaid_tpu/data/knowledge.py` (same tables, same
class order). Encodes the reference's two expert KGs as dense lookup
tables consumed by the extraction pipeline's `combine_pair`:

  1. organ-level KG — anatomy/disease → organ region
     ("feature extraction/combine_dicts.py": get_kg_ana_only :33-66,
     get_kg :68-96). An edge (label 1) links an anatomy node and a
     disease node mapped to the same organ.
  2. CheXpert co-occurrence KG — 14×14 disease co-occurrence counts from
     mimic-cxr-2.0.0-chexpert.csv, row-normalized by the diagonal and
     thresholded at 0.18 → label 2 (combine_dicts.py:234-238; built by
     "feature extraction/dictionary/preparation.py":8-25).

Combined class indexing follows combine_dicts.py:98-105: anatomy classes
first (the 26 detector classes + the stray 'Edema' entry the reference's
anatomy KG carries), then the 22 VinDr disease classes; index
`num_classes` is the missing-detection sentinel.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

# Anatomy entries in get_kg_ana_only() insertion order (combine_dicts.py:33-66)
ANATOMY_ORGANS: Dict[str, str] = {
    "right lung": "Lung",
    "right upper lung zone": "Lung",
    "right mid lung zone": "Lung",
    "right lower lung zone": "Lung",
    "right hilar structures": "Lung",
    "right apical zone": "Lung",
    "right costophrenic angle": "Pleural",
    "right hemidiaphragm": "Pleural",
    "left lung": "Lung",
    "left upper lung zone": "Lung",
    "left mid lung zone": "Lung",
    "left lower lung zone": "Lung",
    "left hilar structures": "Lung",
    "left apical zone": "Lung",
    "left costophrenic angle": "Pleural",
    "left hemidiaphragm": "Pleural",
    "trachea": "Lung",
    "right clavicle": "Bone",
    "left clavicle": "Bone",
    "aortic arch": "Heart",
    "upper mediastinum": "Mediastinum",
    "svc": "Heart",
    "cardiac silhouette": "Heart",
    "cavoatrial junction": "Heart",
    "right atrium": "Heart",
    "carina": "Lung",
    "edema": "Lung",          # stray KG entry, kept for index parity
}

# VinDr-CXR disease classes in get_vindr_label2id() order
# (combine_dicts.py:7-32) with their organ mapping (get_kg :68-96)
DISEASE_ORGANS: Dict[str, str] = {
    "aortic enlargement": "Heart",
    "atelectasis": "Lung",
    "cardiomegaly": "Heart",
    "calcification": "Bone",
    "clavicle fracture": "Bone",
    "consolidation": "Lung",
    "edema": "Lung",
    "emphysema": "Lung",
    "enlarged pa": "Heart",
    "ild": "Lung",
    "infiltration": "Lung",
    "lung cavity": "Lung",
    "lung cyst": "Lung",
    "lung opacity": "Lung",
    "mediastinal shift": "Mediastinum",
    "nodule/mass": "Lung",
    "pulmonary fibrosis": "Lung",
    "pneumothorax": "Pleural",
    "pleural thickening": "Pleural",
    "pleural effusion": "Pleural",
    "rib fracture": "Bone",
    "other lesion": "Lung",
}

ANATOMY_CLASSES = list(ANATOMY_ORGANS)
DISEASE_CLASSES = list(DISEASE_ORGANS)
COMBINED_CLASSES = ANATOMY_CLASSES + DISEASE_CLASSES
NUM_CLASSES = len(COMBINED_CLASSES)              # sentinel id == NUM_CLASSES

ORGAN_IDS = {"Lung": 0, "Pleural": 1, "Bone": 2, "Heart": 3,
             "Mediastinum": 4}

# mimic-cxr-2.0.0-chexpert.csv columns[2:16] (preparation.py:11-12)
CHEXPERT_COLUMNS = [
    "atelectasis", "cardiomegaly", "consolidation", "edema",
    "enlarged cardiomediastinum", "fracture", "lung lesion",
    "lung opacity", "no finding", "pleural effusion", "pleural other",
    "pneumonia", "pneumothorax", "support devices",
]


def build_cooccurrence(chexpert_csv: Optional[str] = None,
                       counting_adj: Optional[np.ndarray] = None,
                       threshold: float = 0.18) -> np.ndarray:
    """14×14 thresholded co-occurrence (combine_dicts.py:234-238):
    rows normalized by the diagonal, then `> threshold → 2`."""
    if counting_adj is None:
        if chexpert_csv is None:
            raise ValueError("need chexpert_csv or counting_adj")
        import pandas as pd
        df = pd.read_csv(chexpert_csv)
        cols = df.columns[2:16]
        pos = (df[cols].to_numpy() == 1).astype(np.int64)
        counting_adj = (pos.T @ pos).astype(np.float64)
        counting_adj = counting_adj / np.linalg.norm(counting_adj)
    adj = np.array(counting_adj, dtype=np.float64)
    for i in range(len(adj)):
        adj[i] = adj[i] / adj[i][i]
    return np.where(adj > threshold, 2, 0).astype(np.int32)


def semantic_tables(counting_adj: Optional[np.ndarray] = None,
                    chexpert_csv: Optional[str] = None
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(organ_table [C+1], cooccur_table [C+1, C+1], is_disease [C+1])
    over combined class ids; the sentinel row gets organ -1 / no edges.

    Without co-occurrence data, the organ KG alone is used (cooccur 0).
    """
    c = NUM_CLASSES
    organ = np.full(c + 1, -1, np.int32)
    is_dis = np.zeros(c + 1, bool)
    for i, name in enumerate(ANATOMY_CLASSES):
        organ[i] = ORGAN_IDS[ANATOMY_ORGANS[name]]
    for j, name in enumerate(DISEASE_CLASSES):
        organ[len(ANATOMY_CLASSES) + j] = ORGAN_IDS[DISEASE_ORGANS[name]]
        is_dis[len(ANATOMY_CLASSES) + j] = True

    co = np.zeros((c + 1, c + 1), np.int32)
    if counting_adj is not None or chexpert_csv is not None:
        small = build_cooccurrence(chexpert_csv, counting_adj)
        name2idx = {n: i for i, n in enumerate(CHEXPERT_COLUMNS)}
        # classes whose lowered name is a CheXpert column participate —
        # including the anatomy 'edema' entry (combine_dicts.py:141-147)
        chex = [(k, name2idx[n]) for k, n in enumerate(COMBINED_CLASSES)
                if n in name2idx]
        for k1, c1 in chex:
            for k2, c2 in chex:
                co[k1, k2] = small[c1, c2]
    return organ, co, is_dis
