"""What runs on the card loads neither JAX nor the JAX package, and the
reference loads nothing of the port. Top-level module names are compared
whole: `repro_torch` begins with `repro` and is not it."""
import ast
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def loaded_after(code: str):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT), str(ROOT / "src")]), "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in sys.modules}))"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120,
        check=True).stdout.strip().splitlines()[-1]
    return set(ast.literal_eval(out))


def test_the_harness_loads_no_jax():
    tops = loaded_after(
        "import runpy, sys\nsys.argv=['run.py']\n"
        "from portbench import cells, harness, check, flops, trace\n"
        "harness._program_side(cells.load_cell('mnist-personal-1k')"
        "['config_data'], cells.load_cell('mnist-personal-1k')"
        "['traffic_data'], harness.Options(device='cpu'))\n"
        "harness._kernels()\n"
        "import repro_torch.core, repro_torch.launch.fed")
    assert "repro_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    tops = loaded_after("import portbench.check, portbench.reference.chain,"
                        " portbench.reference.protocol")
    assert not tops & (FORBIDDEN | {"repro_torch"}), tops


def test_reference_sources_import_no_program():
    for path in (HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"repro_torch"}, \
                    (path.name, n)
