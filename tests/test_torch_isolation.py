"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points run on the card unless told otherwise."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from torch_threads import intra_op_threads, worker_env  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


# the one `torch_*` script that is a named comparison against the JAX
# package, not part of the port
JAX_COMPARISONS = (ROOT / "scripts" / "torch_tp_collectives_vs_jax.py",)
# the twins of the JAX package's smoke scripts and examples
TWINS = ("scripts/torch_service_smoke.py", "scripts/torch_chaos_smoke.py",
         "scripts/torch_ann_smoke.py", "scripts/torch_tiled_smoke.py",
         "examples/torch_attack_resilience.py", "examples/torch_quickstart.py",
         "examples/torch_serve_batch.py", "examples/torch_train_lm.py")


def _port_files():
    scripts = sorted(ROOT.glob("examples/torch_*.py")) + \
        sorted(ROOT.glob("scripts/torch_*.py"))
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + \
        [p for p in scripts if p not in JAX_COMPARISONS]


def _imports(path):
    """(line, module) of every absolute import in `path`, nested ones
    included."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((node.lineno, a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_no_jax_or_repro_imports_in_the_port():
    """The package, chip_smoke.py and every `examples/torch_*.py` and
    `scripts/torch_*.py` but the named JAX comparisons."""
    files = _port_files()
    assert {ROOT / t for t in TWINS} <= set(files)
    assert all(p.exists() for p in JAX_COMPARISONS)
    assert all(any(_forbidden(m) for _, m in _imports(p))
               for p in JAX_COMPARISONS)
    offending = []
    for path in files:
        offending += [f"{path.relative_to(ROOT)}:{line} {m}"
                      for line, m in _imports(path) if _forbidden(m)]
    assert len(files) > 20 and offending == []


_CHILD = """
import importlib, pkgutil, sys
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
from repro_torch.launch.fed import run_federation
_, hist = run_federation("aecg", rounds=1, num_clients=3, device="cpu",
                         log=None)
assert len(hist) == 1
from repro_torch.launch.serve import serve
res = serve("minitron-4b", batch=1, prompt_len=4, max_new=2, device="cpu")
assert res["generated"].shape == (1, 2)
from repro_torch.launch.train import train
_, hist = train("minitron-4b", steps=1, batch=1, seq=4, device="cpu",
                log=None)
assert len(hist) == 1
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", bad)
"""


def test_port_runs_without_loading_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **worker_env())
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout


def test_run_federation_needs_a_card_unless_told(monkeypatch):
    from repro_torch.launch.fed import run_federation
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_federation("aecg", rounds=1, num_clients=3, log=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_federation("aecg", rounds=1, num_clients=4, attack="lsh_cheat",
                       attack_start=0, log=None)
    _, hist = run_federation("aecg", rounds=1, num_clients=4, device="cpu",
                             attack="lsh_cheat", attack_start=0, log=None)
    assert 0.0 <= hist[0]["attacker_admission_rate"] <= 1.0


def test_serve_needs_a_card_unless_told(monkeypatch):
    from repro_torch.launch.serve import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve("minitron-4b", batch=1, prompt_len=4, max_new=2)
    res = serve("minitron-4b", batch=1, prompt_len=4, max_new=2,
                device="cpu")
    assert res["generated"].shape == (1, 2)


def test_train_needs_a_card_unless_told(monkeypatch):
    from repro_torch.launch.train import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train("minitron-4b", steps=1, batch=1, seq=4, log=None)
    params, hist = train("minitron-4b", steps=2, batch=1, seq=4,
                         log_every=1, device="cpu", log=None)
    assert [h["step"] for h in hist] == [0, 1]
    assert params["final_norm"]["scale"].device.type == "cpu"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """Without CUDA (or without the rest of the repo) the script exits
    non-zero and prints no result line."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
