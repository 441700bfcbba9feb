"""Port parity: the serving CLI's reference flags (``--policy sjf``,
``--admission-control``, ``--arrival-rate``, ``--kv-style``, ``--profile``,
``--calibration-in`` / ``--calibration-out``, ``--metrics``,
``--trace-out``) against ``repro.launch.serve``, on the CPU.

Both CLIs serve the smoke qwen2 in float32 here (their ``get_smoke_config``
is patched to float32: bf16 prefill-vs-decode rounding flips greedy
near-ties), the port's on JAX's ``LM.init`` weights for the same seed
(bridged), and each engine they build is kept for inspection.

* A closed-loop ``--policy sjf --profile --metrics --trace-out
  --calibration-out`` drive gives JAX's streams and host syncs, the same
  metric names, a trace and a calibration; the ``costmodel_*`` gauges are
  the port's own ``service_estimate`` at ``h100-1``.
* Under ``--arrival-rate`` every request's stream equals its closed-loop
  stream (host syncs follow the wall clock there, so they are not held).
* ``--calibration-in`` seeds the next drive's calibration; Prometheus text
  for ``.prom``; EDF ``--admission-control`` and ``--kv-style`` run.
* A drive that raises mid-way still writes ``--metrics``.
* ``--arch granite-moe-3b-a800m`` (MoE) through ``--paged`` and the
  scheduler with ``--prefill-chunk`` gives JAX's streams and syncs.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.sched as jsched_mod  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.core.costmodel import TIERS, service_estimate  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

ARGS = ["--smoke", "--requests", "4", "--prompt-len", "20", "--max-new",
        "6", "--slots", "2", "--max-len", "64", "--page-size", "8",
        "--prefill-chunk", "16", "--decode-block", "4"]


def _patch(mp, engines, fail_at=None):
    """float32 smoke configs for both CLIs, JAX's weights for the port's
    LM, and their scheduler engines recorded in ``engines`` (the port's
    failing at step ``fail_at``)."""
    mp.setattr(jserve, "get_smoke_config",
               lambda a: j_smoke(a).with_(dtype="float32"))
    mp.setattr(tserve, "get_smoke_config",
               lambda a: t_smoke(a).with_(dtype="float32"))

    class BridgedLM(tserve.LM):
        def init(self, seed=0):
            jcfg = j_smoke(self.cfg.name).with_(dtype="float32")
            tree = JLM(jcfg).init(jax.random.PRNGKey(seed))
            return params_from_numpy(jax.tree.map(np.asarray, tree),
                                     self.cfg, device=self.device)
    mp.setattr(tserve, "LM", BridgedLM)
    for mod in (jsched_mod, tserve):
        base = mod.SchedEngine

        class Kept(base):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                self.n_steps = 0
                engines.append(self)

            def step(self):
                self.n_steps += 1
                if fail_at is not None and self.n_steps == fail_at:
                    raise RuntimeError("drive failed")
                return super().step()
        mp.setattr(mod, "SchedEngine", Kept)


def _streams(eng):
    return [eng.registry[i].out_tokens for i in sorted(eng.registry)]


def _families(snapshot: dict) -> set:
    return {k.split("{")[0] for part in ("counters", "gauges", "histograms")
            for k in snapshot.get(part, {})}


def test_closed_loop_sjf_profile_metrics_trace_match_jax(tmp_path, capsys):
    engines = []
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp, engines)
        for side, main, extra in (("jax", jserve.main, []),
                                  ("port", tserve.main,
                                   ["--device", "cpu"])):
            files = {k: str(tmp_path / f"{side}_{k}") for k in
                     ("m.json", "t.json", "c.json")}
            assert main(ARGS + extra + [
                "--policy", "sjf", "--profile",
                "--metrics", files["m.json"], "--trace-out",
                files["t.json"], "--calibration-out",
                files["c.json"]]) == 0
            out[side] = {k: json.loads(open(v).read())
                         for k, v in files.items()}
    jeng, teng = engines
    assert teng.policy.name == "sjf" and teng.policy.layout == "paged"
    assert _streams(teng) == _streams(jeng)
    assert all(len(s) == 6 for s in _streams(teng))
    assert teng.sync_count == jeng.sync_count
    jm, tm = out["jax"]["m.json"], out["port"]["m.json"]
    assert _families(tm) == _families(jm)
    for fam in ("profile_dispatch_seconds_total", "profile_dispatch_count",
                "profile_roofline_attainment", "costmodel_drift_ratio",
                "costmodel_calibration_samples", "costmodel_t_prefill_s",
                "costmodel_hbm_bytes_decode", "sched_slo_rejected_total"):
        assert fam in _families(tm), fam
    cfg = t_smoke("qwen2-1.5b").with_(dtype="float32")
    est = service_estimate(cfg, TIERS["h100-1"], prompt=20, gen=6, chunk=16)
    for k, v in est.items():
        assert tm["gauges"][f"costmodel_{k}"] == v, k
    # the same calibration series (kind x arm), one sample per dispatch
    jc, tc = out["jax"]["c.json"], out["port"]["c.json"]
    assert [(f["kind"], f["arm"], f["n"]) for f in tc["factors"]] == \
        [(f["kind"], f["arm"], f["n"]) for f in jc["factors"]]
    assert sum(f["n"] for f in tc["factors"]) == teng.sync_count
    names = {e["name"] for e in out["port"]["t.json"]["traceEvents"]}
    assert {"request", "queue", "prefill_chunk", "decode_block"} <= names
    text = capsys.readouterr().out
    assert "calibration series" in text and "metrics snapshot" in text


def test_open_loop_streams_equal_closed_loop(tmp_path):
    engines = []
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp, engines)
        for extra in ([], ["--arrival-rate", "200"]):
            assert tserve.main(ARGS + ["--device", "cpu", "--policy",
                                       "sjf"] + extra) == 0
    closed, opened = engines
    assert _streams(opened) == _streams(closed)
    assert len(opened.registry) == 4


def test_calibration_in_prometheus_admission_control_kv_style(tmp_path):
    """The second drive's calibration starts from the first's factors
    (each series' count adds up); ``.prom`` metrics are Prometheus text;
    EDF with admission control rejects requests already past their TTFT
    target; ``--kv-style gqa`` serves."""
    engines = []
    c1, c2 = str(tmp_path / "c1.json"), str(tmp_path / "c2.json")
    prom = str(tmp_path / "m.prom")
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp, engines)
        base = ARGS + ["--device", "cpu", "--policy", "fcfs"]
        assert tserve.main(base + ["--calibration-out", c1]) == 0
        assert tserve.main(base + ["--calibration-in", c1,
                                   "--calibration-out", c2,
                                   "--metrics", prom]) == 0
        n1 = {(f["kind"], f["arm"]): f["n"]
              for f in json.loads(open(c1).read())["factors"]}
        n2 = {(f["kind"], f["arm"]): f["n"]
              for f in json.loads(open(c2).read())["factors"]}
        assert set(n2) == set(n1)
        assert all(n2[k] == 2 * n1[k] for k in n1)
        text = open(prom).read()
        assert "# TYPE costmodel_drift_ratio gauge" in text
        assert "costmodel_t_total_s" in text
        assert tserve.main(base[:-1] + ["edf", "--admission-control",
                                        "--slo-ttft", "-1"]) == 0
        assert engines[-1].stats.slo_rejected == 4
        assert tserve.main(base + ["--kv-style", "gqa"]) == 0
        assert engines[-1].lm.cfg.kv_cache_style == "gqa"


def test_failed_drive_still_writes_metrics(tmp_path):
    engines = []
    m = tmp_path / "m.json"
    t = tmp_path / "t.json"
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp, engines, fail_at=3)
        with pytest.raises(RuntimeError, match="drive failed"):
            tserve.main(ARGS + ["--device", "cpu", "--policy", "fcfs",
                                "--profile", "--metrics", str(m),
                                "--trace-out", str(t)])
    snap = json.loads(m.read_text())
    assert snap["counters"]["serve_requests_submitted_total"] == 4
    assert "costmodel_t_prefill_s" in snap["gauges"]
    assert json.loads(t.read_text())["traceEvents"]


@pytest.mark.parametrize("engine", [["--paged"], ["--policy", "fcfs"]],
                         ids=["paged", "sched"])
def test_moe_arch_streams_match_jax(engine):
    """``--arch granite-moe-3b-a800m --smoke``: the paged engine, and the
    scheduler with ``--prefill-chunk 16``, serve JAX's streams with its
    host syncs."""
    import repro.serve.engine as jengine_mod
    engines = []
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp, engines)
        for mod in (jengine_mod, tserve):
            base = mod.PagedEngine

            class Kept(base):
                def __init__(self, *a, **k):
                    super().__init__(*a, **k)
                    engines.append(self)
            mp.setattr(mod, "PagedEngine", Kept)
        argv = ARGS + ["--arch", "granite-moe-3b-a800m"] + engine
        assert jserve.main(argv) == 0
        assert tserve.main(argv + ["--device", "cpu"]) == 0
    jeng, teng = engines
    assert teng.lm.cfg.moe is not None
    assert type(teng).__mro__[1].__name__ == type(jeng).__mro__[1].__name__
    assert _streams(teng) == _streams(jeng)
    assert all(len(s) == 6 for s in _streams(teng))
    assert teng.sync_count == jeng.sync_count
