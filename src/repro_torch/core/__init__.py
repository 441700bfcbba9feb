"""The port's copy of the AE-LLM core (``repro/core``): the configuration
space (``space.py``), the config rewrite of an efficiency configuration
(``apply.py``) and the cost model on an H100 tier (``costmodel.py``:
rooflines, per-dispatch estimates, online calibration).  The search
(NSGA-II, surrogates, tuner, evaluator) follows (ROADMAP A5)."""
