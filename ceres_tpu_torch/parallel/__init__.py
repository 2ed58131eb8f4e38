"""Sharded solves over torch.distributed: one process (rank) per shard."""
