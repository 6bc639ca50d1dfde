"""Entry points: the serving step builders and the batched decode loop
(``python -m repro_torch.launch.serve``), and the simulation launcher
(``python -m repro_torch.launch.train``)."""
