"""Entry points: ``python -m repro_torch.launch.serve`` (the sharded serve
driver), ``python -m repro_torch.launch.train`` (the training driver) and
``python -m repro_torch.launch.dryrun`` (the cells' dry run, over
``launch.cells`` and ``launch.mesh``)."""
