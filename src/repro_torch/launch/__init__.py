"""Serving entry points: the prefill and decode step builders and the
batched decode loop (``python -m repro_torch.launch.serve``)."""
