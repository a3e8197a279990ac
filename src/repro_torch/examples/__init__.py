"""Runnable examples of the port (``python -m repro_torch.examples.<name>``,
on the card by default, ``--device cpu`` for the plain PyTorch path):
``quickstart`` (one fold with and without AAQ) and ``fold_server`` (the
request lifecycle through ``FoldClient``, then the same engine over HTTP).
They are the counterparts of the reference's ``examples/quickstart.py``
and ``examples/fold_server.py``."""
