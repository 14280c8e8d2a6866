"""Parameter interop: reference checkpoints into the JAX package's trees,
and those trees into the port's modules."""
