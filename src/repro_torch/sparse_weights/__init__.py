"""Weight sparsity: block pruning, the BSR conv and its block geometry
(counterpart of `repro.sparse_weights`)."""
