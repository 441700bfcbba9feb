"""The port's checkpointing (``repro/checkpoint``): atomic, sha-checked,
asynchronous saves of a training run's state."""
