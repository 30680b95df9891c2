"""Parallel layers of the port. Only what a single card serves so far: the
mixture-of-experts layer at one expert shard (``moe``)."""
