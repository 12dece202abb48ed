"""Qualitative figures: detections, node attention, study-pair answers
(counterpart of `ekaid_tpu/viz/draw.py`).

Box overlays, attention overlays, side-by-side difference panels with
the question and answer, example sheets, the decoder's module-weight
heatmap and the sampled-answer histogram, in matplotlib with the Agg
backend. Every function returns its figure, and with `save` writes it
and closes it. matplotlib is imported at the first figure.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _mpl():
    """(pyplot, patches) on the Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import patches
    return plt, patches


def _show_image(ax, image):
    if image.ndim == 2:
        ax.imshow(image, cmap="gray")
    else:
        ax.imshow(np.clip(image, 0, 1) if image.dtype.kind == "f"
                  else image)
    ax.set_xticks([])
    ax.set_yticks([])


def draw_detections(image, boxes, classes=None, scores=None,
                    class_names: Optional[Sequence[str]] = None,
                    valid=None, save: Optional[str] = None,
                    title: str = ""):
    """Bounding-box overlay (draw_single.py-style panel)."""
    plt, patches = _mpl()
    fig, ax = plt.subplots(figsize=(7, 7))
    _show_image(ax, image)
    cmap = plt.get_cmap("tab20")
    boxes = np.asarray(boxes)
    n = len(boxes)
    for i in range(n):
        if valid is not None and not valid[i]:
            continue
        x1, y1, x2, y2 = boxes[i]
        if x2 <= x1 or y2 <= y1:
            continue
        c = cmap((int(classes[i]) if classes is not None else i) % 20)
        ax.add_patch(patches.Rectangle((x1, y1), x2 - x1, y2 - y1,
                                       fill=False, edgecolor=c,
                                       linewidth=1.5))
        label = ""
        if classes is not None:
            k = int(classes[i])
            label = (class_names[k] if class_names is not None
                     and k < len(class_names) else str(k))
        if scores is not None:
            label += f" {float(scores[i]):.2f}"
        if label:
            ax.text(x1, max(y1 - 3, 0), label, color=c, fontsize=7,
                    bbox=dict(facecolor="black", alpha=0.4, pad=1))
    ax.set_title(title)
    if save:
        fig.savefig(save, bbox_inches="tight", dpi=120)
        plt.close(fig)
    return fig


def draw_attention(image, boxes, att_weights, valid=None,
                   save: Optional[str] = None, title: str = ""):
    """Node-attention overlay (draw_diff.py-style): box alpha scales with
    the change detector's sigmoid attention weight."""
    plt, patches = _mpl()
    fig, ax = plt.subplots(figsize=(7, 7))
    _show_image(ax, image)
    att = np.asarray(att_weights).reshape(-1)
    att = att / max(att.max(), 1e-9)
    for i, (x1, y1, x2, y2) in enumerate(np.asarray(boxes)):
        if valid is not None and not valid[i]:
            continue
        if x2 <= x1 or y2 <= y1:
            continue
        ax.add_patch(patches.Rectangle(
            (x1, y1), x2 - x1, y2 - y1, linewidth=0,
            facecolor="red", alpha=0.5 * float(att[i])))
        ax.add_patch(patches.Rectangle(
            (x1, y1), x2 - x1, y2 - y1, fill=False, edgecolor="red",
            alpha=min(1.0, 0.3 + float(att[i])), linewidth=1.0))
    ax.set_title(title)
    if save:
        fig.savefig(save, bbox_inches="tight", dpi=120)
        plt.close(fig)
    return fig


def draw_pair(image_bef, image_aft, question: str, answer: str,
              gt_answer: Optional[str] = None,
              att_bef=None, att_aft=None, boxes_bef=None, boxes_aft=None,
              save: Optional[str] = None):
    """Side-by-side difference panel with Q/A caption
    (draw_by_asking_question.py parity)."""
    plt, patches = _mpl()
    fig, axes = plt.subplots(1, 2, figsize=(12, 6.5))
    for ax, img, att, bxs, name in (
            (axes[0], image_bef, att_bef, boxes_bef, "main"),
            (axes[1], image_aft, att_aft, boxes_aft, "reference")):
        _show_image(ax, img)
        ax.set_title(name)
        if att is not None and bxs is not None:
            a = np.asarray(att).reshape(-1)
            a = a / max(a.max(), 1e-9)
            for i, (x1, y1, x2, y2) in enumerate(np.asarray(bxs)):
                if x2 <= x1 or y2 <= y1:
                    continue
                ax.add_patch(patches.Rectangle(
                    (x1, y1), x2 - x1, y2 - y1, linewidth=0,
                    facecolor="red", alpha=0.45 * float(a[i])))
    caption = f"Q: {question}\nA: {answer}"
    if gt_answer is not None:
        caption += f"\nGT: {gt_answer}"
    fig.suptitle(caption, fontsize=11)
    if save:
        fig.savefig(save, bbox_inches="tight", dpi=120)
        plt.close(fig)
    return fig


def draw_example_sheet(examples, save: Optional[str] = None,
                       max_rows: int = 6):
    """Dataset-example presentation sheet
    (draw_dataset_examples_for_presentation.py parity): one row per
    study pair — main/reference images side by side with the Q/A (and
    optional GT) as the row caption.

    examples: iterable of dicts with image_bef, image_aft, question,
    answer and optionally gt_answer / boxes_bef / boxes_aft.
    """
    plt, patches = _mpl()
    rows = list(examples)[:max_rows]
    n = max(len(rows), 1)
    fig, axes = plt.subplots(n, 2, figsize=(10, 4.6 * n), squeeze=False)
    for r, ex in enumerate(rows):
        for c, (img_key, box_key, name) in enumerate((
                ("image_bef", "boxes_bef", "main"),
                ("image_aft", "boxes_aft", "reference"))):
            ax = axes[r][c]
            _show_image(ax, np.asarray(ex[img_key]))
            if ex.get(box_key) is not None:
                for x1, y1, x2, y2 in np.asarray(ex[box_key]):
                    if x2 <= x1 or y2 <= y1:
                        continue
                    ax.add_patch(patches.Rectangle(
                        (x1, y1), x2 - x1, y2 - y1, fill=False,
                        edgecolor="lime", linewidth=0.8))
            title = name if c else (name + "  |  Q: "
                                    + str(ex["question"]))
            ax.set_title(title, fontsize=9, loc="left")
        caption = f"A: {ex['answer']}"
        if ex.get("gt_answer"):
            caption += f"   (GT: {ex['gt_answer']})"
        axes[r][0].set_xlabel(caption, fontsize=9)
    fig.tight_layout()
    if save:
        fig.savefig(save, bbox_inches="tight", dpi=110)
        plt.close(fig)
    return fig


def draw_module_weights(weights, tokens: Optional[Sequence[str]] = None,
                        save: Optional[str] = None, title: str = ""):
    """Decoder module-attention heatmap: the 3-way (bef, diff, aft)
    softmax the DynamicCore emits per decode step
    (dynamic_speaker_change_pos.py:104-105; the reference stores them in
    self.module_weights for its figures)."""
    plt, _ = _mpl()
    w = np.asarray(weights)                           # [T, 3]
    t = w.shape[0]
    fig, ax = plt.subplots(figsize=(max(6, 0.35 * t), 2.6))
    im = ax.imshow(w.T, aspect="auto", cmap="viridis", vmin=0, vmax=1)
    ax.set_yticks([0, 1, 2])
    ax.set_yticklabels(["before", "diff", "after"])
    if tokens is not None:
        ax.set_xticks(range(min(t, len(tokens))))
        ax.set_xticklabels(tokens[:t], rotation=90, fontsize=7)
    else:
        ax.set_xlabel("decode step")
    fig.colorbar(im, ax=ax, fraction=0.025)
    ax.set_title(title)
    if save:
        fig.savefig(save, bbox_inches="tight", dpi=120)
        plt.close(fig)
    return fig


def draw_answer_distribution(answer_counts, save: Optional[str] = None,
                             title: str = "sampled answers"):
    """Bar chart of sampled-answer counts (the answer histogram
    `viz/ask.py` prints)."""
    plt, _ = _mpl()
    items = sorted(answer_counts.items(), key=lambda kv: -kv[1])[:12]
    labels = [k if len(k) < 42 else k[:39] + "..." for k, _ in items]
    fig, ax = plt.subplots(figsize=(7, 0.45 * max(len(items), 1) + 1.2))
    ax.barh(range(len(items)), [v for _, v in items], color="#4477aa")
    ax.set_yticks(range(len(items)))
    ax.set_yticklabels(labels, fontsize=8)
    ax.invert_yaxis()
    ax.set_xlabel("count")
    ax.set_title(title)
    if save:
        fig.savefig(save, bbox_inches="tight", dpi=120)
        plt.close(fig)
    return fig
