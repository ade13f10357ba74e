"""CNN helpers (counterpart of `repro.models.cnn`)."""
