"""Weight block density (counterpart of `repro.sparse_weights.format`)."""
