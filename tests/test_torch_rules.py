"""Rules of the port: it imports nothing of JAX or of the reference
package, its entry points never fall back to the CPU on their own, and
its copied configs agree with the reference's."""
import ast
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "ml_dtypes", "repro"}


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_no_reference():
    files = _port_files()
    assert len(files) > 15
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f))
                                            & FORBIDDEN)
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    """Without a GPU and without device='cpu', LM, PagedEngine (through
    its LM) and launch.serve raise instead of running on the CPU."""
    from repro_torch.launch.serve import main
    from repro_torch.models.model import LM
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_smoke_config("qwen2-1.5b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--smoke", "--paged", "--requests", "1"])
    lm = LM(cfg, device="cpu")            # an explicit request is honoured
    assert lm.device.type == "cpu"


def test_launch_serve_requires_paged():
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit):
        main(["--smoke", "--device", "cpu"])


def test_engine_refuses_non_attention_decoders():
    from repro_torch.models.model import LM
    from repro_torch.serve.engine import PagedEngine
    cfg = tconfigs.get_smoke_config("qwen2-1.5b")
    lm = LM(cfg.with_(attention=dataclasses.replace(cfg.attention,
                                                    window=8)), device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        PagedEngine(lm, {}, n_slots=1, max_len=16)


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCH_IDS))
def test_copied_configs_agree_with_reference(arch):
    for getter in ("get_config", "get_smoke_config"):
        t = getattr(tconfigs, getter)(arch)
        j = getattr(jconfigs, getter)(arch)
        for f in dataclasses.fields(t):
            if f.name == "attention":
                for g in dataclasses.fields(t.attention):
                    assert getattr(t.attention, g.name) == \
                        getattr(j.attention, g.name), (arch, g.name)
            else:
                assert getattr(t, f.name) == getattr(j, f.name), \
                    (arch, f.name)
        assert t.padded_vocab == j.padded_vocab
        assert t.num_groups == j.num_groups
        assert t.attention.heads_padded == j.attention.heads_padded
