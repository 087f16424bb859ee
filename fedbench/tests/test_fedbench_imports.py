"""Nothing the benchmark runs loads ``jax`` or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), the plain
reference imports nothing of the program, and the command refuses a
machine without a card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

DRIVE = """
import sys, json, torch
torch.set_num_threads(2)
sys.path[:0] = [{src!r}, {root!r}]
import fedbench.run
from fedbench import harness, tracing, hooks, compare
from fedbench.drivers import federated_rounds, lm_train
import fedbench.reference.femnist, fedbench.reference.mixtral
cell = harness.Cell(harness.load_benchmark(), "femnist.fullsync")
cell.workload = json.loads(json.dumps(cell.workload))
cell.workload["traffic"]["rounds_per_call"] = 1
out = federated_rounds.run(cell, 5, 0.0, False, torch.device("cpu"))
assert out.correct, out.checks
bad = harness.forbidden_loaded()
assert "repro_torch.federated" in sys.modules
print("forbidden:", bad)
"""


def clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_a_run_loads_no_jax_and_no_reference_package():
    out = subprocess.run(
        [sys.executable, "-c", DRIVE.format(src=str(ROOT / "src"),
                                            root=str(ROOT))],
        capture_output=True, text=True, timeout=300, env=clean_env())
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "forbidden: []"


def test_forbidden_names_are_compared_whole():
    code = ("import sys, types\nsys.path[:0] = [%r]\n"
            "from fedbench import harness\n"
            "sys.modules['repro_torch_x'] = types.ModuleType('x')\n"
            "sys.modules['jaxtyping'] = types.ModuleType('y')\n"
            "assert harness.forbidden_loaded() == []\n"
            "sys.modules['repro.core'] = types.ModuleType('z')\n"
            "assert harness.forbidden_loaded() == ['repro.core']\n"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, env=clean_env())
    assert out.returncode == 0, out.stderr


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "fedbench/reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro",
                                               "jax"), (path, n)
    code = ("import sys\nsys.path[:0] = [%r]\n"
            "import fedbench.reference.femnist, fedbench.reference.mixtral\n"
            "import fedbench.reference.adafactor\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax')))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, env=clean_env())
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_command_refuses_a_machine_without_a_card():
    code = "import torch; print(torch.cuda.is_available())"
    has_card = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True,
                              timeout=60).stdout.strip() == "True"
    env = clean_env()
    env["CUDA_VISIBLE_DEVICES"] = ""      # hides a card where there is one
    out = subprocess.run(
        [sys.executable, "fedbench/run.py", "--workload", "femnist.fullsync",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0, (has_card, out.stdout)
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
