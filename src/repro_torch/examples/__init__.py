"""Runnable examples of the port: ``python -m repro_torch.examples.quickstart``
and ``python -m repro_torch.examples.analyze_pipeline`` (on the card by
default, ``--device cpu`` when asked)."""
