"""Port parity of the training loop: ``make_train_step`` steps against
the reference's (full fine-tuning, LoRA, QLoRA, two microbatches, top-k
and int8 gradient compression), the straggler watchdog, the data
pipelines, the checkpoint manager (round trip, keep-N, corrupt fallback,
async), exact resume, the training CLI and the search's proxy
``_reduce_config``.  float32 smoke configs; the same numpy batches; the
reference's initial parameters (and adapters) bridged to torch."""
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _search_pairs import ROSTER, configs  # noqa: E402
from _train_pairs import flat, pair, rel_l2, to_torch  # noqa: E402
from repro.core import apply as japply  # noqa: E402
from repro.core import evaluator as jev  # noqa: E402
from repro.core import space as jspace  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro.peft import lora as jlora  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.core import evaluator as tev  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.launch import train as tcli  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import compress as tcompress  # noqa: E402
from repro_torch.peft import lora as tlora  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

VARIANTS = {  # method, microbatches, compress
    "full": ("full", 1, "none"), "lora": ("lora", 1, "none"),
    "qlora": ("qlora", 1, "none"), "microbatch2": ("full", 2, "none"),
    "topk": ("full", 1, "topk"), "int8": ("full", 1, "int8")}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_steps_match_jax(variant):
    """Three steps (cosine schedule, clip 1.0, weight decay 0.1) on batch
    4 x 64 of the synthetic pipeline: grad_norm and the loss of every
    step within 1e-4, every parameter leaf within 1e-4 relative L2 after
    the third, frozen leaves bit-equal to their start on both sides."""
    method, n_mb, comp = VARIANTS[variant]
    jlm, tlm, jp, _ = pair("llama3.2-1b")
    eff = jspace.EfficiencyConfig(jspace.ArchChoice(),
                                  jspace.FtChoice(method, 4, 2),
                                  jspace.InfChoice())
    jp = japply.apply_to_params(jp, eff, jax.random.PRNGKey(1))
    tp = to_torch(jp, tlm.cfg)
    start = flat(params_to_numpy(tp, tlm.cfg))
    jmask = None if method == "full" else jlora.trainable_mask(jp, method)
    tmask = None if method == "full" else tlora.trainable_mask(tp, method)
    kw = dict(num_microbatches=n_mb, compress=comp)
    jstep = jax.jit(jloop.make_train_step(
        jlm, lr=jadamw.cosine_schedule(1e-2, 1, 3), mask=jmask, **kw))
    tstep = tloop.make_train_step(
        tlm, lr=tadamw.cosine_schedule(1e-2, 1, 3), mask=tmask, **kw)
    jopt, topt = jadamw.init_adamw(jp, jmask), tadamw.init_adamw(tp, tmask)
    if comp == "none":
        jerr, terr = jopt.mu, None
    else:
        jerr = jcompress.init_error_feedback(jp)
        terr = tcompress.init_error_feedback(tp)
    jpipe = jdata.SyntheticLMData(512, 64, 4, seed=3)
    tpipe = tdata.SyntheticLMData(512, 64, 4, seed=3)
    for _ in range(3):
        jb, tb = jpipe.next_batch(), tpipe.next_batch()
        assert all(np.array_equal(jb[k], tb[k]) for k in jb)
        jp, jopt, jerr, jm = jstep(jp, jopt, {k: jnp.asarray(v)
                                              for k, v in jb.items()}, jerr)
        tp, topt, terr, tm = tstep(tp, topt, {k: torch.from_numpy(v).long()
                                              for k, v in tb.items()}, terr)
        for k in ("grad_norm", "loss", "ce_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=k)
        if comp != "none":
            assert float(tm["compress_ratio"]) == float(jm["compress_ratio"])
    got, want = flat(params_to_numpy(tp, tlm.cfg)), flat(jp)
    assert got.keys() == want.keys()
    for k in want:
        if want[k].dtype.kind == "f" and not np.array_equal(start[k],
                                                           want[k]):
            assert rel_l2(got[k], want[k]) <= 1e-4, k
        else:           # frozen, or an integer base: untouched
            np.testing.assert_array_equal(got[k], start[k], err_msg=k)
            np.testing.assert_array_equal(want[k], start[k], err_msg=k)
    assert topt.step == int(jopt.step) == 3


def test_straggler_watchdog_matches_jax():
    dts = [0.1, 0.1, 0.11, 0.09, 0.1, 0.1, 0.5, 0.1, 0.35, 0.1, 0.1, 0.9]
    j, t = jloop.StragglerWatchdog(), tloop.StragglerWatchdog()
    for i, dt in enumerate(dts):
        assert t.observe(i, dt) == j.observe(i, dt)
    assert t.events == j.events and t.events
    assert t.ema == j.ema


def test_data_pipelines_match_jax(tmp_path):
    """Synthetic and packed-file batches bit-equal to the reference's,
    per host too, and a restored ``DataState`` replays the stream."""
    for h in range(2):
        j = jdata.SyntheticLMData(300, 16, 4, seed=5, host_index=h,
                                  host_count=2)
        t = tdata.SyntheticLMData(300, 16, 4, seed=5, host_index=h,
                                  host_count=2)
        for _ in range(3):
            jb, tb = j.next_batch(), t.next_batch()
            for k in jb:
                assert np.array_equal(jb[k], tb[k]) and \
                    tb[k].dtype == jb[k].dtype
    rng = np.random.default_rng(0)
    for i in range(2):
        rng.integers(0, 1000, 500 + 100 * i).astype(np.uint32).tofile(
            tmp_path / f"tokens.{i}.bin")
    j = jdata.make_pipeline("packed", path=str(tmp_path), seq_len=32,
                            global_batch=3, seed=2)
    t = tdata.make_pipeline("packed", path=str(tmp_path), seq_len=32,
                            global_batch=3, seed=2)
    for _ in range(3):
        jb, tb = j.next_batch(), t.next_batch()
        assert all(np.array_equal(jb[k], tb[k]) for k in jb)
    saved = t.state
    after = t.next_batch()
    t.next_batch()
    t.restore(tdata.DataState.from_dict(json.loads(json.dumps(
        saved.to_dict()))))
    assert np.array_equal(t.next_batch()["tokens"], after["tokens"])


def _bf16_tree():
    g = torch.Generator().manual_seed(0)
    return {"embed": {"w": torch.randn(6, 4, generator=g).bfloat16()},
            "layers": [{"q": torch.randint(-8, 8, (3, 2),
                                           dtype=torch.int8),
                        "u": torch.randint(0, 255, (2, 2),
                                           dtype=torch.uint8),
                        "f8": torch.randn(4, generator=g).to(
                            torch.float8_e4m3fn)}],
            "final_norm": {"scale": torch.randn(4, generator=g)}}


def _same(a, b):
    return all(x.dtype == y.dtype and torch.equal(
        x.view(torch.uint8) if x.element_size() == 1 else x,
        y.view(torch.uint8) if y.element_size() == 1 else y)
        for (_, x), (_, y) in zip(leaves_with_path(a), leaves_with_path(b)))


def test_checkpoint_round_trip_keep_n_and_manifest(tmp_path):
    """bf16, fp8, int8 and uint8 leaves and the AdamW state come back
    bit for bit in their dtypes; the manifest is JSON naming each dtype;
    only the newest ``keep`` steps stay."""
    params = _bf16_tree()
    opt = tadamw.init_adamw(params)
    opt = opt._replace(step=7)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, params, opt, tdata.DataState(4, s))
    assert mgr.all_steps() == [2, 3]
    man = json.loads((tmp_path / "step_000000003" / "MANIFEST.json")
                     .read_text())
    assert man["arrays"]["params/embed/w"]["dtype"] == "bfloat16"
    assert man["arrays"]["params/layers/0/f8"]["dtype"] == "float8_e4m3fn"
    assert man["data_state"] == {"seed": 4, "step": 3}
    r = mgr.restore(like=params)
    assert r["step"] == 3 and _same(r["tree"], params)
    assert int(r["arrays"]["opt/step"]) == 7
    assert not any((tmp_path / d).name.endswith(".tmp")
                   for d in tmp_path.iterdir())


def test_corrupt_checkpoint_falls_back(tmp_path):
    params = _bf16_tree()
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(5, params)
    params["final_norm"]["scale"] += 1
    mgr.save(10, params)
    next((tmp_path / "step_000000010").glob("shard_*.bin")).write_bytes(
        b"garbage")
    with pytest.warns(UserWarning, match="step 10"):
        r = CheckpointManager(str(tmp_path)).restore()
    assert r["step"] == 5
    with pytest.raises(IOError):
        CheckpointManager(str(tmp_path)).restore(10)


def test_async_checkpoint_copies_before_returning(tmp_path):
    """``save_async`` returns once its host copy is made; an in-place
    update right after it does not reach the checkpoint."""
    params = {"w": torch.randn(256, 256)}
    want = params["w"].clone()
    mgr = CheckpointManager(str(tmp_path))
    t0 = time.perf_counter()
    mgr.save_async(1, params)
    submit = time.perf_counter() - t0
    params["w"].add_(1.0)
    mgr.wait()
    assert submit < 5.0
    assert torch.equal(mgr.restore()["arrays"]["params/w"], want)


def _trainer(tmp, lm, steps_pipe=0, **kw):
    pipe = tdata.SyntheticLMData(512, 32, 4, seed=1)
    return tloop.Trainer(lm, pipe, lr=tadamw.cosine_schedule(1e-2, 2, 6),
                         ckpt_dir=tmp, log_every=1, log_fn=lambda _: None,
                         **kw)


def test_resume_is_bit_exact(tmp_path):
    """3 steps, a checkpoint, a fresh Trainer resumed from it and 3 more
    steps equal 6 uninterrupted steps bit for bit (parameters, AdamW
    moments and step, data state, losses)."""
    _, lm, _, _ = pair("llama3.2-1b")
    a = _trainer(str(tmp_path / "a"), lm, ckpt_every=3)
    a.init_or_resume(0)
    a.run(3)
    b = _trainer(str(tmp_path / "a"), lm)
    b.init_or_resume(123)              # another seed: it must restore
    assert b.step == 3 and b.opt_state.step == 3
    assert b.pipe.state == a.pipe.state
    assert _same(b.params, a.params) and _same(b.opt_state.mu,
                                               a.opt_state.mu)
    hist_b = b.run(6)
    c = _trainer(None, lm)
    c.init_or_resume(0)
    hist_c = c.run(6)
    assert [h["loss"] for h in hist_b] == [h["loss"] for h in hist_c[3:]]
    assert _same(b.params, c.params)
    assert _same(b.opt_state.nu, c.opt_state.nu)
    assert b.pipe.state == c.pipe.state


def test_train_cli_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu``: plain,
    with a checkpoint directory and a history file, and ``--autotune``
    (the search at a small budget) applying c*; ``--model-parallel 2``
    trains RWKV-6 blocks over the rank's heads, and ``--model-parallel
    8`` of its 4 smoke heads, a layout the model axis does not split, is
    refused, naming A8.8."""
    from repro_torch.core import tuner
    base = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
            "--seq-len", "32", "--global-batch", "2"]
    hist = tmp_path / "h.json"
    assert tcli.main(base + ["--steps", "4", "--ckpt-dir",
                             str(tmp_path / "ck"), "--ckpt-every", "2",
                             "--history-out", str(hist)]) == 0
    assert CheckpointManager(str(tmp_path / "ck")).all_steps() == [2, 4]
    assert json.loads(hist.read_text())[-1]["step"] == 4
    small = tuner.AutoTuner

    def small_tuner(ev, **kw):
        return small(ev, **{**kw, "generations": 2, "pop_size": 8,
                            "n0": 12, "k_per_iter": 4, "ensemble_k": 1})
    monkeypatch.setattr(tuner, "AutoTuner", small_tuner)
    assert tcli.main(base + ["--steps", "2", "--autotune"]) == 0
    out = capsys.readouterr().out
    assert "AE-LLM selected" in out and "loss" in out
    # llama3.2-1b's smoke heads, which 2 does not divide, train (the
    # whole-heads arm); RWKV-6 blocks train over the rank's heads, where
    # the axis divides them
    rwkv = base[:1] + ["rwkv6-1.6b"] + base[2:]
    assert tcli.main(rwkv + ["--steps", "2", "--model-parallel", "2",
                             "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "mesh {'data': 1, 'model': 2} over 2 ranks (gloo, cpu)" in out
    assert out.count("[train] rank ") == 2
    with pytest.raises(SystemExit):
        tcli.main(rwkv + ["--model-parallel", "8"])
    assert "RWKV-6 heads" in capsys.readouterr().err


def test_reduce_config_matches_jax():
    """The proxy's reduced config equals the reference's, field by field,
    for every config of the search's roster."""
    import dataclasses
    for name in ROSTER:
        jcfg, tcfg = configs(name)
        j, t = jev._reduce_config(jcfg), tev._reduce_config(tcfg)
        for f in dataclasses.fields(t):
            tv, jv = getattr(t, f.name), getattr(j, f.name)
            if f.name in ("attention", "moe", "ssm", "encoder") \
                    and tv is not None:
                for g in dataclasses.fields(tv):
                    assert getattr(tv, g.name) == getattr(jv, g.name), \
                        (name, f.name, g.name)
            else:
                assert tv == jv, (name, f.name)
