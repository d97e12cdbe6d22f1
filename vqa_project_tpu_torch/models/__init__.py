"""The VQA model's torch modules and weight loading."""

from vqa_project_tpu_torch.models.graph_vqa import (GaussianGraphConv,
                                                    GraphLearner,
                                                    GraphVQAModel,
                                                    WeightNormLinear)
from vqa_project_tpu_torch.models.weights import (load_reference_checkpoint,
                                                  state_dict_from_jax_params)

__all__ = ["GraphVQAModel", "GraphLearner", "GaussianGraphConv",
           "WeightNormLinear", "state_dict_from_jax_params",
           "load_reference_checkpoint"]
