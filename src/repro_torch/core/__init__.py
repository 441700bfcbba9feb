"""The port's copy of the AE-LLM core (``repro/core``): the configuration
space (``space.py``), applying an efficiency configuration to a config and
to weights (``apply.py``), the cost model on H100 tiers (``costmodel.py``:
rooflines, per-dispatch estimates, online calibration), and the search:
features (``features.py``), Pareto archive and Efficiency Score
(``pareto.py``), NSGA-II (``nsga2.py``), boosted-tree surrogates
(``surrogate.py``), the evaluator (``evaluator.py``: analytic, or a
proxy trained through ``repro_torch.train``) and Algorithm 1
(``tuner.py``)."""
