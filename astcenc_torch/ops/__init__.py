"""Batched tensor ops and the hand-written kernels of the encoder."""
