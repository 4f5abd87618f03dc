"""Command-line entry points of the port (``python -m
stereoscene_torch.tools.<name>``)."""
