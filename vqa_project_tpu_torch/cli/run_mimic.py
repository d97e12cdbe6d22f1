"""MIMIC-CXR VQA grid search, on the card.

    python -m vqa_project_tpu_torch.cli.run_mimic --data_dir data
    python -m vqa_project_tpu_torch.cli.run_mimic --synthetic \
        --neighbors_list 19 --kernels_list 8 --ep 1 --fast_math

Counterpart of ``vqa_project_tpu/cli/run_mimic.py``: the grid of
``cli/medical.py`` over the MIMIC artifacts (train and val splits with
their own vocabularies and stores), checkpoints
``mimic_{n_obj}_{kernels}_{neigh}_{acc}.pt``; the accuracy divides by
the validation questions, not the reference's 10 * bsize.
"""

from vqa_project_tpu_torch.cli.medical import (grid_search_main,
                                               medical_input_args)


def main(argv=None):
    """Run the grid; returns its cells (``cli.medical.Cell``)."""
    args, parser, unparsed = medical_input_args(
        argv, n_obj_default=51, neigh_default=19)
    return grid_search_main(args, parser, unparsed, dataset_name="mimic",
                            ckpt_prefix="mimic")


if __name__ == "__main__":
    main()
