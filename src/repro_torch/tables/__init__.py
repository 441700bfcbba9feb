"""The paper's tables on the port's H100 tiers (ROADMAP A5): Table 2 (main
results), 3 (ablations), 4 (VLMs), 6 (per task) and the Pareto fronts,
each ``python -m repro_torch.tables.<name>``, all through ``run``."""
