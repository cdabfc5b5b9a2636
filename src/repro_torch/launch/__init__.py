"""LM serving entry points (``python -m repro_torch.launch.serve``)."""
