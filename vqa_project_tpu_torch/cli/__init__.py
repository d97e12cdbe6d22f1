"""Command-line front-ends of the port (``python -m
vqa_project_tpu_torch.cli.run``)."""
