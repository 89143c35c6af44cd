"""Checkpoints of the LM substrate's training state, in the reference's format."""
