"""Resilience vocabulary of the port (the outcome set; fault injection and
the degradation ladder arrive in a later slice)."""
from repro_torch.resil.errors import OUTCOMES

__all__ = ["OUTCOMES"]
