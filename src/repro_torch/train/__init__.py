"""The port's training loop (``repro/train``): the step factory, the
straggler watchdog and the checkpointing ``Trainer``."""
