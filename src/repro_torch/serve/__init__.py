"""Serving of the port: paged KV bookkeeping and the paged engine."""
