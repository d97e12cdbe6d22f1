"""The YOLO raw-image pipeline behind the medical region features (cv2
at import, Pillow for the labels cache; host only)."""

from vqa_project_tpu_torch.data.yolo.augment import (
    augment_hsv,
    cutout,
    letterbox,
    mixup,
    mosaic4,
    random_perspective,
)
from vqa_project_tpu_torch.data.yolo.loaders import (
    ImageLabelDataset,
    InfiniteBatcher,
    LoadImages,
    LoadStreams,
    LoadWebcam,
    get_yolo_dataset,
)

__all__ = [
    "augment_hsv", "cutout", "letterbox", "mixup", "mosaic4",
    "random_perspective",
    "ImageLabelDataset", "InfiniteBatcher", "LoadImages", "LoadStreams",
    "LoadWebcam", "get_yolo_dataset",
]
