"""Interpretability plots (``plots``; the cv2 renderer, ``cv2_plots``,
is imported on its own, as in the JAX package). Importing this package
needs neither matplotlib nor cv2."""

from vqa_project_tpu_torch.viz.plots import (
    collect_graphs,
    colorline,
    find_question,
    given_question_graph,
    load_image,
    make_segments,
    node_weights_from_adjacency,
    plot_adjacency_graph,
    plot_given_question,
    read_adj,
    render_graphs,
    resolve_image_path,
    save_predictions_csv,
    visualize_checkpoint,
)

__all__ = [
    "colorline",
    "find_question",
    "load_image",
    "make_segments",
    "node_weights_from_adjacency",
    "plot_adjacency_graph",
    "plot_given_question",
    "read_adj",
    "resolve_image_path",
    "save_predictions_csv",
    "visualize_checkpoint",
    "collect_graphs",
    "render_graphs",
    "given_question_graph",
]
