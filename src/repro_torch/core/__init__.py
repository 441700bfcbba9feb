"""The port's copy of the AE-LLM core (``repro/core``): so far only the
cost model's speculative-decoding terms (``costmodel.py``); the search
and the H100 tier of the cost model follow (ROADMAP A5)."""
