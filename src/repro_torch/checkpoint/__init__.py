"""Checkpoint store: atomic, manifest-driven msgpack checkpoints (the SON
plane's spill and boundary format, and the rule index's persistence)."""
