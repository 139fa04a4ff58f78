"""Durable checkpoints (atomic, fsync-ed msgpack files)."""
