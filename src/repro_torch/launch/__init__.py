"""Command-line entry points (``python -m repro_torch.launch.serve traffic``,
``python -m repro_torch.launch.train``) and the training step."""
