"""Atomic checkpoints: array trees, and the AdHash master's recoverable
state (query log, placement table, full adaptivity snapshots)."""
