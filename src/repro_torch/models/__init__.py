"""Model forwards of the port (attention-only dense decoders)."""
