"""Host-side data helpers of the port (numpy only)."""

from vqa_project_tpu_torch.data.store import FeatureStore
from vqa_project_tpu_torch.data.text import tokenize

__all__ = ["FeatureStore", "tokenize"]
