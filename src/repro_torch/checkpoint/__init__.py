"""repro_torch.checkpoint — atomic, async checkpointing (port of
``repro.checkpoint``)."""
