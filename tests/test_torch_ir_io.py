"""PyTorch port: the op-graph YAML (``ir_io.py``) against the JAX package's.

The port writes and reads the reference's schema without a YAML package
(the card's host has none).  Its text must load under PyYAML to the JAX
package's structure, and it must read the JAX package's text, a plain
reference file without ``EXTRA`` (written by PyYAML with sorted keys) and
its own text back to the op graph, keeping the per-op path's output within
1e-6 (JAX's ``tests/test_ir_io.py``)."""
import math

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu import ir_io as JI  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import ir_io as TI  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.lower import (  # noqa: E402
    init_params, lower)
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models.builders import NETWORKS  # noqa: E402

from conftest import small_graph  # noqa: E402

CPU = "cpu"


def _ops(graph):
    return [(o.op_id, o.kind, o.compute, o.order, list(o.inputs),
             o.out_width, o.extra) for o in graph.ops]


@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("network", NETWORKS)
def test_text_and_import_equal_jax(network, reorder):
    gj = J.build_op_graph(network, 16, 8, heads=2, reorder=reorder)
    gt = T.build_op_graph(network, 16, 8, heads=2, reorder=reorder)
    tj = JI.to_yaml(gj, n_node=50, n_edge=200)
    tt = TI.to_yaml(gt, n_node=50, n_edge=200)
    assert yaml.safe_load(tt) == yaml.safe_load(tj)
    assert TI.load_yaml(tj) == yaml.safe_load(tj)
    back = TI.from_yaml(tj, name=gt.name, in_width=16)
    assert _ops(back) == _ops(gt) and back.in_width == gt.in_width
    mine = TI.from_yaml(tt, name=gt.name)
    assert _ops(mine) == _ops(JI.from_yaml(tj, name=gj.name))
    assert mine.in_width == JI.from_yaml(tj).in_width


@pytest.mark.parametrize("network", NETWORKS)
def test_roundtrip_preserves_numerics(rng, network):
    og = T.build_op_graph(network, 16, 8, heads=2)
    back = TI.from_yaml(TI.to_yaml(og, n_node=50, n_edge=200), name=og.name,
                        in_width=16)
    s, r = small_graph(rng, n=50, e=200)
    g = T.build_graph(s, r, 50, add_self_loops=True, symmetric_norm=True,
                      device=CPU)
    x = torch.tensor(rng.normal(size=(50, 16)).astype(np.float32))
    params = init_params(og, torch.Generator().manual_seed(0), device=CPU)
    out1 = lower(og)(params, g, x)
    out2 = lower(back)(params, g, x)
    np.testing.assert_allclose(out2.numpy(), out1.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_plain_reference_file_without_extra(tmp_path):
    """A file without EXTRA, keys sorted as PyYAML writes them, imports as
    the JAX package imports it: weights made from op ids."""
    og = T.build_op_graph("GCN", 8, 4)
    raw = yaml.safe_load(TI.to_yaml(og, n_node=10, n_edge=30))
    for d in raw:
        d.pop("EXTRA", None)
    p = tmp_path / "gcn.yaml"
    p.write_text(yaml.safe_dump(raw))
    back = TI.load(str(p), in_width=8)
    ref = JI.load(str(p), in_width=8)
    assert _ops(back) == _ops(ref) and back.name == ref.name == "gcn"
    mm = [o for o in back.ops if o.compute == "MM"][0]
    assert mm.extra["weight"] == (f"gcn_w{mm.op_id}", 8, 4)
    for d in raw:
        assert {"OP_NO", "COMP_TYPE", "TYPE", "ORDER", "INPUT",
                "OUTPUT"} <= set(d)
        assert d["INPUT"]["input_size"] % 4 == 0


def test_save_and_load(tmp_path):
    og = T.build_op_graph("GAT", 16, 8, heads=4)
    p = tmp_path / "gat.yaml"
    TI.save(og, str(p), n_node=10, n_edge=40)
    assert _ops(TI.load(str(p))) == _ops(og)
    assert T.ir_io is TI


@pytest.mark.parametrize("value", [
    "1", "true", "null", "a b", "it's", "x: y", "-x", "#c", "[]", "",
    0, -3, 12345678901234, 0.2, 1e-5, -2.5e10, 1.0, math.inf, -math.inf,
    None, True, False, [], {}])
def test_scalars_as_pyyaml_reads_them(value):
    text = TI.dump_yaml({"k": value, "l": [value, 1]})
    assert yaml.safe_load(text) == {"k": value, "l": [value, 1]}
    assert TI.load_yaml(text) == {"k": value, "l": [value, 1]}
    assert TI.load_yaml(yaml.safe_dump({"k": value})) == {"k": value}


def test_nested_blocks_as_pyyaml_writes_them():
    d = {"a": [{"b": [1, 2], "c": {"d": "e"}}, {"f": []}], "g": {},
         "h": [{"i": [{"j": 1}]}]}
    text = TI.dump_yaml(d)
    assert text == yaml.safe_dump(d, sort_keys=False)
    assert TI.load_yaml(text) == d
    assert TI.load_yaml("# comment\n---\n" + text) == d
    with pytest.raises(ValueError):
        TI.load_yaml("a: 1\n  b: 2\n")
