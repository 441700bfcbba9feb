"""The port's copy of the AE-LLM core (``repro/core``): the configuration
space (``space.py``), applying an efficiency configuration to a config and
to weights (``apply.py``), the cost model on H100 tiers (``costmodel.py``:
rooflines, per-dispatch estimates, online calibration), and the search:
features (``features.py``), Pareto archive and Efficiency Score
(``pareto.py``), NSGA-II (``nsga2.py``), boosted-tree surrogates
(``surrogate.py``), the analytic evaluator (``evaluator.py``) and
Algorithm 1 (``tuner.py``).  The evaluator's proxy mode and PEFT arms need
the training path (ROADMAP A7)."""
