"""Sharded groups on one card: the shard axis is part of the batch axis."""
