"""repro_torch.optim — AdamW, LR schedules, AAQ gradient compression (port
of ``repro.optim``)."""
