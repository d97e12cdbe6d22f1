"""Host-side data helpers of the port (numpy; torch only to prefetch
batches to the device): the in-memory feature store and dataset, the
synthetic generator, host and index batches, tokenization."""

from vqa_project_tpu_torch.data.datasets import (GraphVQADataset,
                                                 QuestionTable,
                                                 random_embeddings)
from vqa_project_tpu_torch.data.loader import (Batcher, pack_index_batch,
                                               prefetch_to_device)
from vqa_project_tpu_torch.data.store import FeatureStore
from vqa_project_tpu_torch.data.synthetic import generate_synthetic_vqa
from vqa_project_tpu_torch.data.text import tokenize

__all__ = ["FeatureStore", "tokenize", "QuestionTable", "GraphVQADataset",
           "random_embeddings", "Batcher", "pack_index_batch",
           "prefetch_to_device", "generate_synthetic_vqa"]
