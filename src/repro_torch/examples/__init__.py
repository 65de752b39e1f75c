"""Runnable examples of the port: ``python -m repro_torch.examples.<name>``
(on the card unless ``--device cpu``)."""
