"""Training: AdamW and the Trainer (port of ``repro.train``)."""
