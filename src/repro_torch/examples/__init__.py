"""Runnable examples of the port (``python -m repro_torch.examples.<name>``,
on the card by default, ``--device cpu`` for the plain PyTorch path):
``quickstart`` (one fold with and without AAQ), ``fold_server`` (the
request lifecycle through ``FoldClient``, then the same engine over HTTP),
``train_lm`` (``launch.train`` through a simulated preemption with the AAQ
straight-through estimator) and ``lm_serve_quantized_kv`` (the LM decode
tenant with an fp16 and an AAQ-quantized KV cache: KV bytes, their ratio
and the first-token logit drift, gated by ``--drift-tol``).  They are the
counterparts of the reference's ``examples/*.py``, one module each."""
