"""PyTorch port, multi-device execution (``parallel/``) on the CPU.

One world of four gloo ranks (``parallel.launch``, ``device="cpu"``) runs
every sharded case of this module once (``utils/shard_cases.run_cases``);
each case is its own test.  Against the JAX package's ``make_dist_apply``
over four of the conftest's virtual devices and against the port's
single-device lowering: the sharded forward of GCN (with and without
reorder), GAT at 4 heads, GraphSAGE, GIN and PNA; their gradients against
single-device autograd; the kernel route (``use_kernels=True``: K1 and
K3's plain versions on each rank's local edges) against the route
without kernels and JAX's kernel route; the 2 x 2 mesh; the sharded
train step against the single-device one.  Without processes: the 1-D
and 2-D partition arrays equal JAX's for D = 2, 4 and 8, each rank's
tiling equals JAX's live tiles of its shard, the community order, and
the launcher's refusals.

Tolerance in float32: max |port - ref| <= 1e-5 * max(1, max |ref|), as
every parity test; gradients and AdamW parameters likewise."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu import parallel as JPar  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler.lower import init_params as j_init  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.models.zoo import build_model as j_model  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import parallel as TPar  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.parallel.launch import check_backend, launch  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.shard_cases import run_cases  # noqa: E402

from conftest import small_graph  # noqa: E402

CPU = "cpu"     # the port's entry points default to the CUDA card
WORLD = 4
TOL = 1e-5
NETWORKS = [("GCN", {}), ("GCN", {"reorder": True}), ("GAT", {"heads": 4}),
            ("GraphSAGE", {}), ("GIN", {}), ("PNA", {})]
KERNEL_NETS = [("GCN", {}), ("GAT", {"heads": 4})]
TILE = (16, 16, 32)


def _close(port, ref, tol=TOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


def _graphs(s, r, n):
    kw = dict(symmetric_norm=True, add_self_loops=True)
    return J.build_host_graph(s, r, n, **kw), T.build_host_graph(s, r, n,
                                                                 **kw)


def _setup(seed, network, n=97, e=600, in_w=24, out_w=12, **kw):
    """JAX's ``_setup`` (tests/test_parallel.py): graph, op graphs of both
    packages, JAX's parameters, x."""
    rng = np.random.default_rng(seed)
    s, r = small_graph(rng, n=n, e=e)
    hj, ht = _graphs(s, r, n)
    oj = J.build_op_graph(network, in_w, out_w, **kw)
    ot = T.build_op_graph(network, in_w, out_w, **kw)
    params = {k: np.asarray(v) for k, v in j_init(oj, jax.random.key(1)).items()}
    x = rng.normal(size=(n, in_w)).astype(np.float32)
    return hj, ht, oj, ot, params, x


def _name(net, kw, tag=""):
    return f"{net}{''.join(f'-{k}' for k in kw)}{tag}"


def _cases():
    """(cases for the world, what the tests need of each)."""
    cases, meta = [], {}
    for i, (net, kw) in enumerate(NETWORKS):
        hj, ht, oj, ot, params, x = _setup(i, net, **kw)
        base = dict(kind="forward", layers=[ot], graph=ht, params=params,
                    x=x, grads=True)
        cases.append(dict(base, name=_name(net, kw)))
        meta[_name(net, kw)] = (hj, ht, oj, ot, params, x)
        if (net, kw) in KERNEL_NETS:
            cases.append(dict(base, name=_name(net, kw, "/kernels"),
                              use_kernels=True, tile=TILE))
            cases.append(dict(base, name=_name(net, kw, "/2x2"),
                              mesh2d=(2, 2)))
    # the sharded train step: GCN-2l, AdamW, two steps
    rng = np.random.default_rng(7)
    n, n_class = 96, 4
    s, r = small_graph(rng, n=n, e=500)
    hj, ht = _graphs(s, r, n)
    jm = j_model("GCN", 12, n_class, hidden=16, n_layers=2)
    params = {k: np.asarray(v) for k, v in jm.init(jax.random.key(0)).items()}
    y = rng.integers(0, n_class, size=n).astype(np.int32)
    x = (rng.normal(size=(n_class, 12))[y]
         + rng.normal(size=(n, 12))).astype(np.float32)
    mask = rng.random(n) < 0.6
    tm = T.build_model("GCN", 12, n_class, hidden=16, n_layers=2, device=CPU)
    step = dict(kind="train_step", name="train_step", layers=tm.layers,
                graph=ht, params=params, x=x, y=y, mask=mask, steps=2)
    cases.append(step)
    cases.append(dict(step, name="train_step/kernels", use_kernels=True,
                      tile=TILE))
    meta["train_step"] = (tm, ht, params, x, y, mask)
    return cases, meta


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases, meta = _cases()
    res = launch(run_cases, WORLD, backend="gloo", args=(cases,),
                 device=CPU, threads=1,
                 tmp_dir=str(tmp_path_factory.mktemp("world")))
    return res, meta


def _out(res, name, n):
    return np.concatenate([r[name]["out"] for r in res])[:n]


def _jax_sharded(hj, oj, params, x, **kw):
    """JAX's make_dist_apply over four virtual devices (1-D)."""
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("graph",))
    part_h = JPar.partition_graph(hj, WORLD)
    part = JPar.shard_part(part_h, mesh)
    xp = jax.device_put(jnp.asarray(JPar.pad_nodes(x, part_h)),
                        NamedSharding(mesh, JP("graph", None)))
    if kw.get("use_kernels"):
        br, bc, te = TILE
        geo = dict(block_rows=br, block_cols=bc, tile_edges=te)
        kw = dict(use_kernels=True,
                  tiles=JPar.shard_part(JPar.shard_tiles(part_h, **geo), mesh),
                  gat_tiles=JPar.shard_part(JPar.shard_tiles(
                      part_h, unit_weight=True, **geo), mesh))
    fwd = jax.jit(JPar.make_dist_apply([oj], mesh, **kw))
    return np.asarray(fwd({k: jnp.asarray(v) for k, v in params.items()},
                          part, xp))[: hj.n_node]


def _single(ot, ht, params, x):
    """The port's single-device lowering and autograd of sum(out²)."""
    p = T.params_from_numpy(params, CPU)
    for v in p.values():
        v.requires_grad_(True)
    y = T.lower(ot)(p, ht.to_device(CPU), torch.from_numpy(x))
    (y ** 2).sum().backward()
    return y.detach().numpy(), {k: v.grad.numpy() for k, v in p.items()}


@pytest.mark.parametrize("net,kw", NETWORKS)
def test_sharded_forward_matches_jax(world, net, kw):
    res, meta = world
    hj, ht, oj, ot, params, x = meta[_name(net, kw)]
    _close(_out(res, _name(net, kw), ht.n_node),
           _jax_sharded(hj, oj, params, x))


@pytest.mark.parametrize("net,kw", NETWORKS)
def test_sharded_forward_matches_single_device(world, net, kw):
    res, meta = world
    hj, ht, oj, ot, params, x = meta[_name(net, kw)]
    _close(_out(res, _name(net, kw), ht.n_node), _single(ot, ht, params, x)[0])


@pytest.mark.parametrize("net,kw", NETWORKS)
def test_sharded_grads_match_single_device_autograd(world, net, kw):
    res, meta = world
    hj, ht, oj, ot, params, x = meta[_name(net, kw)]
    _, ref = _single(ot, ht, params, x)
    for r in res:          # every rank holds the group's sum
        for k, g in ref.items():
            _close(r[_name(net, kw)]["grads"][k], g)


@pytest.mark.parametrize("net,kw", KERNEL_NETS)
def test_kernel_route_matches_route_without_kernels(world, net, kw):
    """K1 (GCN) and K3 (GAT) plain versions on each rank's local edges:
    forward and gradients as the per-op sharded route."""
    res, meta = world
    n = meta[_name(net, kw)][1].n_node
    _close(_out(res, _name(net, kw, "/kernels"), n),
           _out(res, _name(net, kw), n))
    for k, g in res[0][_name(net, kw)]["grads"].items():
        _close(res[0][_name(net, kw, "/kernels")]["grads"][k], g)


@pytest.mark.parametrize("net,kw", KERNEL_NETS)
def test_kernel_route_matches_jax_kernel_route(world, net, kw):
    res, meta = world
    hj, ht, oj, ot, params, x = meta[_name(net, kw)]
    _close(_out(res, _name(net, kw, "/kernels"), ht.n_node),
           _jax_sharded(hj, oj, params, x, use_kernels=True))


@pytest.mark.parametrize("net,kw", KERNEL_NETS)
def test_2x2_mesh_forward_and_grads(world, net, kw):
    """The hierarchical plan over chip-axis and host-axis subgroups:
    forward against JAX's 2-D plan on a (2, 2) mesh and the single
    device, gradients against single-device autograd."""
    res, meta = world
    hj, ht, oj, ot, params, x = meta[_name(net, kw)]
    out = _out(res, _name(net, kw, "/2x2"), ht.n_node)
    ref, gref = _single(ot, ht, params, x)
    _close(out, ref)
    axes = ("host", "chip")
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), axes)
    part_h = JPar.partition_graph_2d(hj, 2, 2)
    xp = jax.device_put(jnp.asarray(JPar.pad_nodes(x, part_h)),
                        NamedSharding(mesh, JP(axes, None)))
    fwd = jax.jit(JPar.make_dist_apply([oj], mesh, axis=axes))
    yj = fwd({k: jnp.asarray(v) for k, v in params.items()},
             JPar.shard_part(part_h, mesh, axis=axes), xp)
    _close(out, np.asarray(yj)[: ht.n_node])
    for k, g in gref.items():
        _close(res[0][_name(net, kw, "/2x2")]["grads"][k], g)


@pytest.mark.parametrize("name", ["train_step", "train_step/kernels"])
def test_sharded_train_step_matches_single_device(world, name):
    """Two AdamW steps of ``make_sharded_train_step`` (global masked mean,
    gradients summed over the group) against ``make_train_step`` on the
    whole graph: losses and parameters."""
    res, meta = world
    tm, ht, params, x, y, mask = meta["train_step"]
    p = T.params_from_numpy(params, CPU)
    for v in p.values():
        v.requires_grad_(True)
    state = TT.TrainState(p, TT.adamw(p, 1e-2))
    step = TT.make_train_step(tm.make_apply())
    g = ht.to_device(CPU)
    losses = []
    for _ in range(2):
        state, loss = step(state, g, torch.from_numpy(x),
                           torch.from_numpy(y), torch.from_numpy(mask))
        losses.append(float(loss))
    for r in res:
        _close(r[name]["losses"], losses)
        for k, v in state.params.items():
            _close(r[name]["params"][k], v.detach().numpy())


def _skewed(rng, n=160, e=1200):
    s = rng.integers(0, n, e).astype(np.int32)
    r = np.where(rng.random(e) < 0.9, rng.integers(0, n // 8, e),
                 rng.integers(0, n, e)).astype(np.int32)
    return s, r


def _equal_fields(tp, jp):
    for f in dataclasses.fields(tp):
        a, b = getattr(tp, f.name), getattr(jp, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("hub_frac", [1 / 256, 0.2])
def test_partition_arrays_equal_jax(D, hub_frac):
    rng = np.random.default_rng(D)
    hj, ht = _graphs(*_skewed(rng), 160)
    _equal_fields(TPar.partition_graph(ht, D, hub_frac=hub_frac),
                  JPar.partition_graph(hj, D, hub_frac=hub_frac))


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (2, 4)])
@pytest.mark.parametrize("hub_frac", [1 / 256, 0.2])
def test_partition_2d_arrays_equal_jax(mesh, hub_frac):
    rng = np.random.default_rng(sum(mesh))
    hj, ht = _graphs(*_skewed(rng), 160)
    tp = TPar.partition_graph_2d(ht, *mesh, hub_frac=hub_frac)
    jp = JPar.partition_graph_2d(hj, *mesh, hub_frac=hub_frac)
    _equal_fields(tp, jp)
    assert tp.comm_report(128) == jp.comm_report(128)


@pytest.mark.parametrize("mesh", [(4,), (2, 2)])
def test_shard_keeps_only_the_rank_edges(mesh):
    """``shard(d)`` is JAX's ``[d:d+1]`` slice of every array, except that
    the edge arrays stop at the rank's own edges (a prefix of each row):
    every kept slot is live, every live slot is kept."""
    rng = np.random.default_rng(20 + len(mesh))
    _, ht = _graphs(*_skewed(rng), 160)
    part = (TPar.partition_graph(ht, *mesh) if len(mesh) == 1
            else TPar.partition_graph_2d(ht, *mesh))
    kept = 0
    for d in range(part.n_shards):
        sh = part.shard(d, CPU)
        for f in dataclasses.fields(part):
            a = getattr(part, f.name)
            if not isinstance(a, np.ndarray):
                continue
            b = getattr(sh, f.name).numpy()
            if f.name[:3] in ("el_", "er_"):
                live = int(getattr(part, f.name[:3] + "mask")[d].sum())
                assert b.shape == (1, live), f.name
                a = a[:, :live]
            np.testing.assert_array_equal(b, a[d:d + 1], err_msg=f.name)
        assert bool(sh.el_mask.all()) and bool(sh.er_mask.all())
        kept += sh.el_mask.shape[1] + sh.er_mask.shape[1]
    assert kept == ht.n_edge


@pytest.mark.parametrize("D", [2, 4, 8])
def test_comm_report_and_pad_nodes_equal_jax(D):
    rng = np.random.default_rng(10 + D)
    hj, ht = _graphs(*_skewed(rng), 160)
    tp, jp = TPar.partition_graph(ht, D), JPar.partition_graph(hj, D)
    assert tp.comm_report(128, 2) == jp.comm_report(128, 2)
    x = rng.normal(size=(160, 3)).astype(np.float32)
    np.testing.assert_array_equal(TPar.pad_nodes(x, tp),
                                  JPar.pad_nodes(x, jp))
    for d in range(D):
        np.testing.assert_array_equal(
            TPar.shard_rows(x, tp, d),
            JPar.pad_nodes(x, jp)[d * jp.n_local:(d + 1) * jp.n_local])


@pytest.mark.parametrize("D", [4, 8])
@pytest.mark.parametrize("unit", [False, True])
def test_shard_tilings_equal_jax_live_tiles(D, unit):
    """Each rank's own tiling (no padding to a common count, no dead
    tiles) equals the first T_d tiles of JAX's shard d; K1 and K3 need no
    row_first_host, and the port's kernels walk each tile's edge prefix,
    which the per-shard tiling keeps (edges sorted by receiver)."""
    rng = np.random.default_rng(3)
    hj, ht = _graphs(*_skewed(rng), 160)
    tp, jp = TPar.partition_graph(ht, D), JPar.partition_graph(hj, D)
    geo = dict(block_rows=16, block_cols=16, tile_edges=32,
               unit_weight=unit)
    jt = JPar.shard_tiles(jp, **geo)
    for d, tg in enumerate(TPar.shard_tiles(tp, device=CPU, **geo)):
        T_d = tg.n_tiles
        assert (np.asarray(jt.tile_cb)[d, :T_d] >= 0).all()
        assert (np.asarray(jt.tile_cb)[d, T_d:] == -1).all()
        for f in ("tile_rb", "tile_cb", "src_local", "dst_local",
                  "edge_id", "weight"):
            np.testing.assert_array_equal(
                getattr(tg, f).float().numpy() if f == "weight"
                else getattr(tg, f).numpy(),
                np.asarray(getattr(jt, f))[d, :T_d].astype(np.float32)
                if f == "weight" else np.asarray(getattr(jt, f))[d, :T_d],
                err_msg=f)
        # each tile's live slots are a prefix sorted by receiver
        live = (tg.src_local < 16) & (tg.dst_local < 16)
        assert bool((live[:, :-1] | ~live[:, 1:]).all())


def test_community_partition_order_equals_jax():
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.data.datasets import synthetic_coo
    n, D = 600, 4
    s, r, labels = synthetic_coo(n, 6000, seed=5, communities=12, p_in=0.8)
    hj, ht = _graphs(s, r, n)
    for balance in ("edges", "nodes"):
        pt, st = TPar.community_partition_order(ht, labels, D,
                                                balance=balance)
        pj, sj = JPar.community_partition_order(hj, labels, D,
                                                balance=balance)
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(st, sj)


def test_launch_refuses_what_it_cannot_run():
    """nccl with more ranks than cards raises, naming the count (no card
    here), and never turns into gloo; an unknown backend raises."""
    with pytest.raises(ValueError, match="world 2 > 0 CUDA devices"):
        launch(run_cases, 2, backend="nccl", args=([],))
    with pytest.raises(ValueError, match="CUDA devices only"):
        check_backend("nccl", 1, "cpu")
    with pytest.raises(ValueError, match="backend 'mpi'"):
        check_backend("mpi", 1, "cpu")
    with pytest.raises(TypeError, match="Mesh2D"):
        TPar.remote_table(torch.zeros(4, 2), TPar.partition_graph_2d(
            T.build_host_graph(np.array([0, 1]), np.array([1, 0]), 4), 1, 2
        ).shard(0, CPU))
