"""The port's optimizer (``repro/optim``): AdamW with its schedule, and
gradient compression with error feedback."""
