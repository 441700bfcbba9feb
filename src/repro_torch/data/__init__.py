"""The port's data pipeline (``repro/data``): deterministic, resumable
synthetic and packed-file token streams (numpy)."""
