"""Launch entry points: ``python -m repro_torch.launch.serve`` (the
streaming serving driver) and ``python -m repro_torch.launch.train``
(training)."""
