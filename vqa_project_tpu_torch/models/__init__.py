"""The VQA models' torch modules and weight loading: the
conditioned-graph model (``graph_vqa``) and MCAN (``mcan``), chosen by
``ModelConfig.arch``."""

from vqa_project_tpu_torch.models.graph_vqa import (GaussianGraphConv,
                                                    GraphLearner,
                                                    GraphVQAModel,
                                                    WeightNormLinear)
from vqa_project_tpu_torch.models.mcan import MCANModel
from vqa_project_tpu_torch.models.weights import (load_reference_checkpoint,
                                                  state_dict_from_jax_params)

MODELS = {"graph": GraphVQAModel, "mcan": MCANModel}


def make_model(cfg, *, device="cuda", seed: int = 0):
    """The model of ``cfg.arch`` at ``cfg``'s widths, weights from
    ``seed``."""
    if cfg.arch not in MODELS:
        raise ValueError(f"unknown architecture {cfg.arch!r}; one of "
                         f"{sorted(MODELS)}")
    return MODELS[cfg.arch](cfg, device=device, seed=seed)


__all__ = ["GraphVQAModel", "GraphLearner", "GaussianGraphConv",
           "WeightNormLinear", "MCANModel", "MODELS", "make_model",
           "state_dict_from_jax_params", "load_reference_checkpoint"]
