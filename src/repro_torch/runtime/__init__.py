"""repro_torch.runtime — the fault-tolerant training driver and elastic
resume onto a resized mesh (port of ``repro.runtime``)."""
