"""Command-line tools of the port (``python -m tecogan_tpu_torch.tools.<name>``)."""
