"""Checkpoint store: atomic, manifest-driven msgpack checkpoints (the SON
plane's spill and boundary format, the rule index's persistence, the
trainer's state), and the elastic restore onto another mesh
(``elastic.py``)."""
