"""Host-side data layer of the port (numpy; torch only to prefetch
batches to the device): the feature store (in memory or packed from
zarr), the dataset adapters, vocabularies and GloVe vectors, the
synthetic generator (in memory or as files), host and index batches,
tokenization. ``data.feature_cache`` holds the device tables that index
batches are gathered from (not imported here: it reaches the ops)."""

from vqa_project_tpu_torch.data.datasets import (GraphVQADataset,
                                                 QuestionTable)
from vqa_project_tpu_torch.data.glove import (load_glove_embeddings,
                                              random_embeddings)
from vqa_project_tpu_torch.data.loader import (Batcher, pack_index_batch,
                                               prefetch_to_device)
from vqa_project_tpu_torch.data.store import FeatureStore, write_sizes_csv
from vqa_project_tpu_torch.data.synthetic import (generate_synthetic_vqa,
                                                  write_synthetic_vqa)
from vqa_project_tpu_torch.data.text import tokenize
from vqa_project_tpu_torch.data.vocab import (build_answer_vocab,
                                              build_question_vocab,
                                              load_vocab, save_vocab)

__all__ = ["FeatureStore", "write_sizes_csv", "tokenize", "QuestionTable",
           "GraphVQADataset", "random_embeddings", "load_glove_embeddings",
           "Batcher", "pack_index_batch", "prefetch_to_device",
           "generate_synthetic_vqa", "write_synthetic_vqa", "load_vocab",
           "save_vocab", "build_question_vocab", "build_answer_vocab"]
