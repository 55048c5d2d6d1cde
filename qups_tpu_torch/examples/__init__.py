"""Runnable examples of the port (``python -m qups_tpu_torch.examples.<name>``).
The package's ``__init__`` never imports them."""
