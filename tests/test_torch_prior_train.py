"""The prior's training in the port against the JAX package at tiny sizes,
float32: the `train_forward` loss with JAX's draws (timestep, noise)
computed from the same key and passed in, one training step (gradients
and the update), `make_optimizer` over three steps against the optax
chain, `mask_target_sequence` with its draws injected, and `param_count`."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from instructany2pix_tpu.core import tree as j_tree
from instructany2pix_tpu.core.prng import KeyChain
from instructany2pix_tpu.prior import model as jprior
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch.prior import model as tprior
from torch_port_helpers import assert_close, one_torch_thread, randn, t  # noqa: F401

LOSS_TOL = 1e-5
PARAM_TOL = 1e-6  # after Adam updates of about lr = 1e-3 each, float32 rounding
NOISE_OF_MAX = 1e-4  # gradient elements below this share of their tensor's largest are noise


def _case(seed, b=2, tlen=3):
    jcfg, tcfg = jprior.PriorConfig.tiny(), tprior.PriorConfig.tiny()
    tree = convert.to_numpy(jprior.init(jax.random.key(seed), jcfg))
    port = convert.prior(tree, tcfg)
    mask = np.ones((b, jcfg.text_len), np.float32)
    mask[1, 4:] = 0
    cond_np = {"src_type": np.array([[3], [0]], np.int32),
               "imagebind": randn(seed, b, 1, jcfg.imagebind_dim),
               "crossattn_clip": (randn(seed + 1, b, jcfg.text_len, jcfg.text_dim), mask),
               "score": randn(seed + 2, b, 1, jcfg.score_dim)}
    target = randn(seed + 3, b, tlen, jcfg.embed_dim)
    return jcfg, tcfg, tree, port, cond_np, target


def _cond(cond_np, conv):
    return {k: (conv(v[0]), conv(v[1])) if isinstance(v, tuple) else conv(v)
            for k, v in cond_np.items()}


def _jax_draws(key, target):
    kc = KeyChain(key)
    t_ = jax.random.randint(kc(), (target.shape[0],), 0, 1000)
    noise = jax.random.normal(kc(), target.shape, jnp.float32)
    return np.asarray(t_), np.asarray(noise)


def test_train_forward_and_step_match_jax():
    seed = 341
    jcfg, tcfg, tree, port, cond_np, target = _case(seed)
    key = jax.random.key(seed)
    jcond = _cond(cond_np, jnp.asarray)
    ref = jprior.train_forward(tree, jcfg, jcond, jnp.asarray(target), key)
    tt, noise = _jax_draws(key, target)
    loss = tprior.train_forward(port, tcfg, _cond(cond_np, t), t(target), t=t(tt), noise=t(noise))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert_close(loss, ref, LOSS_TOL, seed, rel=True, what="train_forward loss")
    # drawn from a generator when not given: finite, and a different draw
    g = torch.Generator().manual_seed(0)
    drawn = tprior.train_forward(port, tcfg, _cond(cond_np, t), t(target), generator=g)
    assert torch.isfinite(drawn) and float(drawn) != float(loss)

    # one step: JAX's gradient and optax chain against the port's
    kw = dict(learning_rate=1e-3, weight_decay=0.01, warmup_steps=1)
    tx = jprior.make_optimizer(**kw)
    grads = jax.grad(lambda p: jprior.train_forward(p, jcfg, jcond, jnp.asarray(target), key))(
        jax.tree.map(jnp.asarray, tree))
    jtree = jax.tree.map(jnp.asarray, tree)
    state = tx.init(jtree)
    for _ in range(2):  # the first update runs at lr 0 (warmup from count 0)
        upd, state = tx.update(grads, state, jtree)
        jtree = optax.apply_updates(jtree, upd)
    port.requires_grad_(True)
    ptx = tprior.make_optimizer(**kw)
    pstate = ptx.init(port)
    for _ in range(2):
        step_loss = tprior.train_step(port, tcfg, ptx, pstate, _cond(cond_np, t), t(target),
                                      t=t(tt), noise=t(noise))
        assert_close(step_loss, ref, LOSS_TOL, seed, rel=True, what="step loss")
    got = _jax_layout(port)
    flat_j = j_tree.flatten(convert.to_numpy(jtree))
    flat_g = j_tree.flatten(convert.to_numpy(grads))
    assert flat_j.keys() == got.keys()
    for k, a in flat_j.items():
        # Adam moves an element by about lr whatever its gradient's size, so
        # where the gradient is float32 noise (the attention keys' bias, to
        # which softmax is blind) the two sides may step either way: such
        # elements are held within the step's lr, the rest within rounding
        g = np.abs(flat_g[k])
        strong = g > NOISE_OF_MAX * max(float(g.max()), 1e-30)
        d = np.abs(got[k].numpy() - a)
        lim = PARAM_TOL + 1e-6 * float(np.abs(a).max())
        assert d[strong].max(initial=0) <= lim, f"{k}: {d[strong].max():.3g} > {lim:.3g}"
        assert d.max() <= kw["learning_rate"] + lim, f"{k}: {d.max():.3g}"


def _jax_layout(module):
    """A module's parameters under the JAX tree's flat names and layouts."""
    mods = dict(module.named_modules())
    out = {}
    for name, p in module.named_parameters():
        owner, _, leaf = name.rpartition(".")
        m, v = mods[owner], p.detach()
        if isinstance(m, torch.nn.Linear):
            out[f"{owner}.{'w' if leaf == 'weight' else 'b'}"] = v.T if leaf == "weight" else v
        elif isinstance(m, torch.nn.LayerNorm):
            out[f"{owner}.{'g' if leaf == 'weight' else 'b'}"] = v
        elif isinstance(m, torch.nn.Embedding):
            out[f"{owner}.w"] = v
        else:
            out[name] = v
    return {k: v.contiguous() for k, v in out.items()}


def test_make_optimizer_matches_optax_chain():
    seed = 343
    kw = dict(learning_rate=2e-3, weight_decay=0.05, warmup_steps=2, step_size_epochs=1,
              gamma=0.5, steps_per_epoch=1)
    rs = np.random.RandomState(seed)
    params = {"a": rs.randn(5, 3).astype(np.float32), "b": rs.randn(7).astype(np.float32)}
    grads = [{k: rs.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    tx = jprior.make_optimizer(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    ptx = tprior.make_optimizer(**kw)
    pp = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    pstate = {"count": 0, "mu": [torch.zeros_like(p) for p in pp],
              "nu": [torch.zeros_like(p) for p in pp]}
    for i, g in enumerate(grads):
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        ptx.update(pp, [torch.from_numpy(g[k]) for k in ("a", "b")], pstate)
        for k, p in zip(("a", "b"), pp):
            assert_close(p, jp[k], 1e-7, i, what=f"step {i + 1} {k}")
    assert pstate["count"] == 3
    # warmup 0, 1/2, then 1 with gamma^epoch
    assert [ptx.schedule(c) for c in range(4)] == pytest.approx(
        [0.0, 2e-3 * 0.5 * 0.5, 2e-3 * 0.25, 2e-3 * 0.125])


@pytest.mark.parametrize("random_ratio", [False, True])
def test_mask_target_sequence_matches_jax(random_ratio):
    seed = 345
    target = randn(seed, 3, 6, 4)
    attn = np.ones((3, 6), np.float32)
    key = jax.random.key(seed)
    jm, ja, jk = jprior.mask_target_sequence(jnp.asarray(target), jnp.asarray(attn), key, 0.5,
                                             random_ratio)
    kc = KeyChain(key)
    ratio_u = jax.random.uniform(kc(), ()) if random_ratio else None
    keep_u = jax.random.uniform(kc(), (3, 6))
    m, a, k = tprior.mask_target_sequence(
        t(target), t(attn), 0.5, random_ratio,
        ratio_u=None if ratio_u is None else t(np.asarray(ratio_u)), keep_u=t(np.asarray(keep_u)))
    assert torch.equal(k, t(np.asarray(jk)))
    assert torch.equal(m, t(np.asarray(jm))) and torch.equal(a, t(np.asarray(ja)))
    assert 0 < int(k.sum()) < 18
    g = torch.Generator().manual_seed(1)
    m2, a2, k2 = tprior.mask_target_sequence(t(target), t(attn), 0.5, random_ratio, generator=g)
    assert m2.shape == m.shape and k2.dtype == torch.bool
    same = tprior.mask_target_sequence(t(target), t(attn), 0.0)
    assert same[2] is None and same[0] is not None


def test_param_count_matches_jax():
    jcfg, tcfg = jprior.PriorConfig.tiny(), tprior.PriorConfig.tiny()
    tree = jprior.init(jax.random.key(0), jcfg)
    assert tprior.param_count(convert.prior(convert.to_numpy(tree), tcfg)) == jprior.param_count(tree)
    full = jax.eval_shape(lambda: jprior.init(jax.random.key(0), jprior.PriorConfig.default()))
    with torch.device("meta"):
        m = tprior.Prior(tprior.PriorConfig.default())
    assert tprior.param_count(m) == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(full))
