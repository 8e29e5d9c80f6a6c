"""The port's mesh (`core/mesh.py`) and sharding rules
(`parallel/sharding.py`) against the JAX package's: `fsdp_spec` on every
parameter of a tiny LLaMA and UNet and on odd shapes, the tensor-parallel
placement of every parameter of a float and a quantized tiny LLaMA and of
a tiny UNet (after `split_geglu`) at meshes (1, 2) and (2, 2), equal to the
specs of JAX's `apply_tp_rules`; then, on four gloo ranks, the mesh's
coordinates, `shard_batch`, every collective wrapper and its counts, the
TP context's refusal outside it and a worker thread's own mesh. CPU."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from instructany2pix_tpu.core import tree as jtree
from instructany2pix_tpu.core.mesh import make_mesh
from instructany2pix_tpu.models import llama as jllama
from instructany2pix_tpu.models import unet as junet
from instructany2pix_tpu.ops import quant as jq
from instructany2pix_tpu.parallel import sharding as jsh
from instructany2pix_tpu_torch.core import mesh as M
from instructany2pix_tpu_torch.models import llama as tllama
from instructany2pix_tpu_torch.models import unet as tunet
from instructany2pix_tpu_torch.ops import quant as Q
from instructany2pix_tpu_torch.parallel import sharding as sh
from torch_port_helpers import one_torch_thread, random_tree, spawn_ranks  # noqa: F401 (autouse)

LCFG = dataclasses.replace(jllama.LlamaConfig.tiny(vocab_size=280), hidden_size=256,
                           intermediate_size=512)


def _jspec(spec, ndim):
    """A JAX PartitionSpec as a tuple of one entry per dim."""
    s = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return () if all(a is None for a in s) else s


def _port_spec(spec, ndim):
    return () if all(a is None for a in spec) else tuple(spec) + (None,) * (ndim - len(spec))


def _to_port_layout(jspec, name, port_ndim):
    """A JAX spec in the port's layout: linear weights (in, out) → (out,
    in), conv HWIO → OIHW; quantized buffers, embeddings and norms keep it."""
    if not jspec:
        return ()
    if name.endswith(".weight") and port_ndim == 2 and not name.endswith("embed_tokens.weight"):
        return tuple(reversed(jspec))
    if port_ndim == 4:
        h, w, i, o = jspec
        return (o, i, h, w)
    return jspec


def _jax_leaf(flat_j, name):
    path, _, leaf = name.rpartition(".")
    for cand in {"weight": ("w", "g"), "bias": ("b",)}.get(leaf, (leaf,)):
        if f"{path}.{cand}" in flat_j:
            return f"{path}.{cand}"
    raise KeyError(name)


def _tiny_llama_numpy(seed=0):
    shapes = jax.eval_shape(lambda: jllama.init(jax.random.key(0), LCFG))
    return random_tree(shapes, seed)


def _port_llama(tree):
    from instructany2pix_tpu_torch import convert

    cfg = tllama.LlamaConfig(**{f.name: getattr(LCFG, f.name)
                                for f in dataclasses.fields(tllama.LlamaConfig)})
    return convert.llama(tree, cfg), cfg


@pytest.mark.parametrize("dims", [(1, 2), (2, 2), (2, 1), (4, 2)])
def test_fsdp_spec_matches_jax(dims):
    jmesh = make_mesh(n_data=dims[0], n_model=dims[1], devices=jax.devices()[:dims[0] * dims[1]])
    mesh = M.abstract_mesh(*dims)
    shapes = [(), (7,), (1023,), (1024,), (32009, 4096), (4096, 11008), (6, 6, 30, 30),
              (3, 3, 320, 640), (33, 62), (2752, 4096), (5, 7, 9, 11), (3, 2, 1024)]
    tree = jax.tree_util.tree_leaves(jax.eval_shape(lambda: jllama.init(jax.random.key(0), LCFG)))
    tree += jax.tree_util.tree_leaves(jax.eval_shape(
        lambda: junet.init(jax.random.key(0), junet.UNetConfig.tiny(with_ip=True))))
    for shape in shapes + [tuple(x.shape) for x in tree]:
        for min_size in (1024, 1):
            want = _jspec(jsh.fsdp_spec(shape, jmesh, min_size), len(shape))
            got = sh.fsdp_spec(shape, mesh, min_size)
            assert _port_spec(got, len(shape)) == want, (shape, min_size, got, want)


def _compare_tp(jparams, module, mesh_dims, jrules, rules, unit):
    jmesh = make_mesh(n_data=mesh_dims[0], n_model=mesh_dims[1],
                      devices=jax.devices()[:mesh_dims[0] * mesh_dims[1]])
    placed = jtree.flatten(jsh.apply_tp_rules(jparams, jmesh, jrules))
    specs = sh.tp_specs(module, M.abstract_mesh(*mesh_dims), rules, unit)
    n_sharded = 0
    for name, spec in specs.items():
        t = module.get_parameter(name) if name in dict(module.named_parameters()) else \
            module.get_buffer(name)
        jname = _jax_leaf(placed, name)
        leaf = placed[jname]
        want = _to_port_layout(_jspec(leaf.sharding.spec, leaf.ndim), name, t.dim())
        assert _port_spec(spec, t.dim()) == want, (name, jname, spec, want)
        n_sharded += bool(want)
    assert len(specs) == len(placed), (len(specs), len(placed))
    return n_sharded


@pytest.mark.parametrize("dims", [(1, 2), (2, 2)])
@pytest.mark.parametrize("quant", [None, "int4_tp_rows_int8", "int4"])
def test_llama_tp_placement_matches_jax(dims, quant):
    tree = _tiny_llama_numpy()
    jparams = jax.tree_util.tree_map(np.asarray, tree)
    module, cfg = _port_llama(tree)
    if quant is not None:
        rows8 = quant == "int4_tp_rows_int8"
        jparams = jq.quantize_llama(jparams, bits=4, tp_rows_int8=rows8)
        Q.quantize_llama(module, bits=4, tp_rows_int8=rows8)
        # the same formats on both sides, layer by layer
        for i in range(LCFG.num_layers):
            for n in ("q", "o", "down", "gate"):
                jkeys = sorted(k for k in jparams[f"layer_{i}"][n] if k != "b")
                assert jkeys == sorted(getattr(module, f"layer_{i}").get_submodule(n).q), (i, n)
    jsh.assert_unfused_for_tp(jparams)
    sh.assert_unfused_for_tp(module)
    n = _compare_tp(jparams, module, dims, jsh.LLAMA_TP_RULES, sh.LLAMA_TP_RULES,
                    tllama.tp_unit(cfg))
    assert n >= 7 * LCFG.num_layers


def test_unet_tp_placement_matches_jax():
    jcfg = junet.UNetConfig.tiny(with_ip=True)
    shapes = jax.eval_shape(lambda: junet.init(jax.random.key(0), jcfg))
    tree = random_tree(shapes, 1)
    jparams = junet.split_geglu(jax.tree_util.tree_map(np.asarray, tree))
    pcfg = tunet.UNetConfig(**dataclasses.asdict(jcfg))
    from instructany2pix_tpu_torch import convert

    module = tunet.split_geglu(convert.unet(tree, pcfg))
    for dims in ((1, 2), (2, 2)):
        n = _compare_tp(jparams, module, dims, jsh.UNET_TP_RULES, sh.UNET_TP_RULES,
                        tunet.tp_unit(pcfg))
        assert n > 20


def test_fused_projections_are_refused_for_tp():
    tree = _tiny_llama_numpy()
    module, _ = _port_llama(tree)
    Q.quantize_llama(module, bits=4)
    tllama.fuse_projections(module)
    with pytest.raises(ValueError, match="unfused"):
        sh.assert_unfused_for_tp(module)
    with pytest.raises(ValueError, match="unfused"):
        jsh.assert_unfused_for_tp(jllama.fuse_projections(
            jq.quantize_llama(jax.tree_util.tree_map(np.asarray, tree), bits=4)))


def test_batch_placements_and_one_rank_mesh():
    mesh = M.make_mesh(device="cpu")
    assert (mesh.n_data, mesh.n_model, mesh.size(), mesh.groups) == (1, 1, 1, {})
    assert sh.batch_spec(3) == ("data", None, None) == tuple(jsh.batch_spec(3))
    assert M.batch_sharded(mesh).spec == ("data",) and M.replicated(mesh).spec == ()
    assert M.sharding(mesh, None, "model").spec == (None, "model")
    placed = sh.batch_shardings({"a": np.zeros((2, 3)), "b": np.zeros(4)}, mesh)
    assert placed["a"].spec == ("data", None) and placed["b"].spec == ("data",)
    x = torch.arange(6).reshape(3, 2)
    assert torch.equal(M.shard_batch(x, mesh), x)
    assert M.batch_rows(5, M.abstract_mesh(2, 1, rank=1)) == (3, 6, 6)
    assert M.single_device_mesh("cpu").size() == 1
    if not torch.cuda.is_available():  # the card unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.single_device_mesh()


def test_mesh_basics_on_four_ranks(tmp_path):
    outs = spawn_ranks("mesh_basics", 4, tmp_path, {"mesh": (2, 2)})
    for r, o in enumerate(outs):
        d, m = divmod(r, 2)
        assert o["coords"] == (d, m) and o["shape"] == {"data": 2, "model": 2}
        # 5 rows padded to 6 by repeating the last: data rank 0 rows 0-2, rank 1 rows 3, 4, 4
        want = [0, 1, 2] if d == 0 else [3, 4, 4]
        assert o["y_rows"] == want and o["x_rows"] == [[2 * i, 2 * i + 1] for i in want]
        model_ranks, data_ranks = [2 * d, 2 * d + 1], [m, m + 2]
        assert o["reduce_model"] == [float(sum(x + 1 for x in model_ranks))] * 3
        assert o["reduce_data"] == [float(sum(x + 1 for x in data_ranks))] * 3
        assert o["gather_model"] == model_ranks
        assert o["bcast_data"] == [data_ranks[0]]
        assert o["ring_model"] == [model_ranks[(m - 1) % 2]]
        c = o["counts"]
        assert c["all-reduce"] == {"count": 2, "bytes": 24}
        assert c["all-gather"] == {"count": 1, "bytes": 16}
        assert c["broadcast"] == {"count": 1, "bytes": 8}
        assert c["collective-permute"] == {"count": 1, "bytes": 8}
        assert "tp_activation_constraints" in o["outside_tp"]
        assert o["main_mesh_kept"] and o["thread_before"] is None and o["thread_inside"]
