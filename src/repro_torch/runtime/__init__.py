"""repro_torch.runtime — the fault-tolerant training driver (port of
``repro.runtime``; ``elastic.py`` is multi-device, ROADMAP Queue 1 item 11)."""
