"""Offline preprocessing of the reference's raw inputs into the artifacts
the dataset adapters read (``medical``: ImageCLEF, MIMIC, NIH)."""
