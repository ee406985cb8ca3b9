"""No module that a run loads is JAX's or the JAX package's, compared by
whole top-level names (the port's name begins with the JAX package's);
and no file of the harness reads the JAX package, the root bench, the
scripts or the results."""
import ast
import json
import subprocess
import sys

from gnnbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax",
             "gta_graph_tensor_acclelrator_for_general_gnn_tpu"}

PROBE = """
import json, sys
import torch
from gnnbench import calibrate, faults, run
from gnnbench.tests.tiny import tiny_cell
for fam in ("gcn", "gat"):
    for loop in ("serve", "train"):
        run.run_cell(tiny_cell(fam, loop), 7, 0.1, True,
                     torch.device("cpu"), 0.0)
print(json.dumps(sorted({m.split(".")[0] for m in list(sys.modules)})))
"""


def test_a_run_loads_no_jax():
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    top = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert not top & FORBIDDEN
    # the port itself was loaded: the guard looked at a real run
    assert "gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch" in top


def test_sources_name_none_of_it():
    for path in spec.HERE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"bench",
                                                           "scripts",
                                                           "results"}, path
        if "tests" in path.relative_to(spec.HERE).parts:
            continue
        text = path.read_text()
        for bad in ("scripts/", "results/", "bench.py"):
            assert bad not in text, (path, bad)
