"""The port's examples (``examples/*_torch.py``) run on the CPU with
``--device cpu`` at their smallest arguments, each exiting 0, and none
imports JAX or the reference package. The four run at once, each a
subprocess with its own timeout (one intra-op thread each)."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = {
    "quickstart_torch.py": ["--nodes", "400", "--edges", "2400"],
    "train_rgnn_torch.py": ["--steps", "6", "--nodes", "400", "--edges",
                            "2400", "--dim", "16"],
    "serve_lm_torch.py": ["--gen", "4"],
    "train_lm_torch.py": ["--steps", "4"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for name, extra in EXAMPLES.items():
        args = [sys.executable, str(ROOT / "examples" / name), "--device",
                "cpu", *extra]
        if name.startswith("train"):
            flag = "--ckpt" if name == "train_rgnn_torch.py" else \
                "--ckpt-dir"
            args += [flag, str(tmp_path_factory.mktemp(name[:-3]))]
        procs[name] = subprocess.Popen(args, cwd=ROOT, env=env,
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
        p.communicate()


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(runs, name):
    try:
        out, err = runs[name].communicate(timeout=240)
    except subprocess.TimeoutExpired:
        runs[name].kill()
        raise
    assert runs[name].returncode == 0, err[-3000:]
    want = {"quickstart_torch.py": "validation catches authoring bugs",
            "train_rgnn_torch.py": "loss: ",
            "serve_lm_torch.py": "generated tokens (4, 4)",
            "train_lm_torch.py": "steps (the drill's repeats included)"}
    assert want[name] in out, out[-2000:]


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_imports_only_the_port(name):
    tree = ast.parse((ROOT / "examples" / name).read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert not mods & {"jax", "repro", "hector"}, mods
