"""Training (state, step, checkpoints, trainer) and the chunked eval
render driver."""
