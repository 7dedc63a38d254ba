"""Entry points: ``python -m repro_torch.launch.serve`` (the sharded serve
driver) and ``python -m repro_torch.launch.train`` (the training
driver)."""
