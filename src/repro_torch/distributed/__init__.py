"""Sharding of the LM substrate over a ``torch.distributed`` device mesh."""
