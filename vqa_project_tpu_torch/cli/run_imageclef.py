"""ImageCLEF-VQA-Med grid search, on the card.

    python -m vqa_project_tpu_torch.cli.run_imageclef --data_dir data
    python -m vqa_project_tpu_torch.cli.run_imageclef --synthetic \
        --neighbors_list 16 --kernels_list 4 --ep 1 --device cpu

Counterpart of ``vqa_project_tpu/cli/run_imageclef.py``: the grid of
``cli/medical.py`` over the ImageCLEF artifacts (one json, train = val),
checkpoints ``clef_{n_obj}_{kernels}_{neigh}_{acc}.pt``.
"""

from vqa_project_tpu_torch.cli.medical import (grid_search_main,
                                               medical_input_args)


def main(argv=None):
    """Run the grid; returns its cells (``cli.medical.Cell``)."""
    args, parser, unparsed = medical_input_args(
        argv, n_obj_default=51, neigh_default=19)
    return grid_search_main(args, parser, unparsed,
                            dataset_name="imageclef", ckpt_prefix="clef")


if __name__ == "__main__":
    main()
