"""Faster R-CNN R50-FPN: the detector of the extraction path."""

from ekaid_torch.models.detector.backbone import ResNetFPN  # noqa: F401
from ekaid_torch.models.detector.faster_rcnn import FasterRCNN  # noqa: F401
