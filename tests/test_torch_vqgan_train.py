"""VQ-GAN training losses of the port against the JAX package: the PatchGAN
discriminator, the GAN losses, `adopt_weight`, the generator objective
(before and after the discriminator starts, with a perceptual term), the
discriminator-free and segmentation objectives, the discriminator's
objective (hinge and vanilla), and the segmentation previews. Every loss
is held with its gradients: autograd on the port against `jax.grad` of the
same loss on the same weights (seeded numpy draws in the JAX tree's
layout). CPU, float32: code indices identical; values and gradients within
TOL relative (gradients: `grad_close`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (assert_close, grad_close, grad_enabled,  # noqa: F401
                                one_torch_thread, random_tree, randn, t)

from instructany2pix_tpu.codecs import vqgan as jvq
from instructany2pix_tpu.codecs import vqgan_train as jtr
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch.codecs import vqgan as tvq
from instructany2pix_tpu_torch.codecs import vqgan_train as ttr

TOL = 1e-5
DISC_START = 5

pytestmark = pytest.mark.usefixtures("grad_enabled")  # every test here takes gradients


def _trainable(m):
    return m.requires_grad_(True)


@pytest.fixture(scope="module")
def nets():
    """(JAX vq params, JAX disc params, port VQModel, port Discriminator),
    tiny (the discriminator's last two convs at stride 1)."""
    vcfg, dcfg = jvq.VQConfig.tiny(), jtr.DiscConfig.tiny()
    vtree = random_tree(jax.eval_shape(lambda: jvq.init(jax.random.key(0), vcfg)), 0)
    dtree = random_tree(jax.eval_shape(lambda: jtr.disc_init(jax.random.key(0), dcfg)), 1)
    vq = _trainable(convert.vqgan(vtree, tvq.VQConfig(**dataclasses.asdict(vcfg))))
    disc = _trainable(convert.discriminator(dtree, ttr.DiscConfig(**dataclasses.asdict(dcfg))))
    return (jax.tree.map(jnp.asarray, vtree), jax.tree.map(jnp.asarray, dtree), vq, disc,
            vcfg, dcfg)


def _grads(loss, *modules):
    for m in modules:
        m.zero_grad()
    loss.backward()
    return [convert.to_tree(m, grad=True) for m in modules]


def test_gan_losses_and_their_gradients():
    lr, lf = randn(0, 2, 3, 3, 1), randn(1, 2, 3, 3, 1)
    for jfn, tfn in ((jtr.hinge_d_loss, ttr.hinge_d_loss), (jtr.vanilla_d_loss, ttr.vanilla_d_loss)):
        want, (gr, gf) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(lr), jnp.asarray(lf))
        a, b = t(lr).requires_grad_(True), t(lf).requires_grad_(True)
        got = tfn(a, b)
        got.backward()
        assert_close(got, want, TOL, 0, rel=True, what=jfn.__name__)
        assert_close(a.grad, gr, TOL, 0, rel=True, what="d/d real")
        assert_close(b.grad, gf, TOL, 0, rel=True, what="d/d fake")
    a = t(lf).requires_grad_(True)
    got = ttr.generator_loss(a)
    got.backward()
    want, g = jax.value_and_grad(jtr.generator_loss)(jnp.asarray(lf))
    assert_close(got, want, TOL, 1, rel=True, what="generator_loss")
    assert_close(a.grad, g, TOL, 1, rel=True, what="d generator_loss")
    for step in (0, DISC_START - 1, DISC_START, 10 * DISC_START):
        want = np.float32(jtr.adopt_weight(0.8, step, DISC_START))
        assert np.float32(ttr.adopt_weight(0.8, step, DISC_START)) == want


def test_discriminator_forward(nets):
    """Odd sizes take XLA's uneven SAME padding (the generator test runs the
    even case inside its loss)."""
    _, dparams, _, disc, _, dcfg = nets
    x = randn(3, 1, 13, 11, 3)
    want = jtr.disc_apply(dparams, jnp.asarray(x), dcfg)
    with torch.no_grad():
        got = ttr.disc_apply(disc, t(x))
    assert tuple(got.shape) == want.shape == (1, 4, 3, 1)
    assert_close(got, want, TOL, 3, rel=True, what="odd sizes")


def _jax_perceptual(x):
    return jnp.tanh(x[..., :2] * 2.0)


def _port_perceptual(x):
    return torch.tanh(x[..., :2] * 2.0)


def test_generator_loss_before_and_after_the_discriminator_starts(nets):
    vparams, dparams, vq, disc, vcfg, dcfg = nets
    x = randn(4, 2, 16, 16, 3)

    def jloss(vp, dp, step):
        return jtr.vqgan_generator_loss(vp, dp, jnp.asarray(x), step, vcfg, dcfg,
                                        perceptual_fn=_jax_perceptual, disc_start=DISC_START)

    fn = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))
    for step in (DISC_START - 1, DISC_START):
        (want, aux_j), (gv, gd) = fn(vparams, dparams, step)
        got, aux_t = ttr.vqgan_generator_loss(vq, disc, t(x), step, vq.cfg, disc.cfg,
                                              perceptual_fn=_port_perceptual,
                                              disc_start=DISC_START)
        tv, td = _grads(got, vq, disc)
        assert_close(got, want, TOL, 4, rel=True, what=f"loss at step {step}")
        np.testing.assert_array_equal(aux_t["indices"].numpy(), np.asarray(aux_j["indices"]))
        for k in ("rec_loss", "codebook_loss", "commit_loss", "perceptual_loss", "g_loss"):
            assert_close(aux_t[k], aux_j[k], TOL, 4, rel=True, what=k)
        assert np.float32(aux_t["adv_weight"]) == np.float32(aux_j["adv_weight"]) == (
            0.0 if step < DISC_START else np.float32(0.8))
        grad_close(tv, gv, TOL, 4)
        grad_close(td, gd, TOL, 4)  # the discriminator's, though its optimizer takes none


def test_nodisc_loss(nets):
    vparams, _, vq, _, vcfg, _ = nets
    x = randn(5, 2, 8, 8, 3)
    fn = jax.jit(jax.value_and_grad(lambda p: jtr.vqgan_nodisc_loss(p, jnp.asarray(x), vcfg,
                                                                    codebook_weight=0.5),
                                    has_aux=True))
    (want, aux_j), g = fn(vparams)
    got, aux_t = ttr.vqgan_nodisc_loss(vq, t(x), vq.cfg, codebook_weight=0.5)
    (tv,) = _grads(got, vq)
    assert_close(got, want, TOL, 5, rel=True, what="nodisc loss")
    assert "perceptual_loss" not in aux_t
    grad_close(tv, g, TOL, 5)
    # with a perceptual term: its value on the same reconstruction (the
    # generator test holds the term against JAX)
    with torch.no_grad():
        got_p, aux_p = ttr.vqgan_nodisc_loss(vq, t(x), vq.cfg, _port_perceptual,
                                             codebook_weight=0.5)
        pl_ = torch.mean(torch.abs(_port_perceptual(t(x)) - _port_perceptual(aux_p["recon"])))
    assert torch.equal(aux_p["perceptual_loss"], pl_) and float(pl_) > 0
    assert_close(got_p - pl_, float(want), TOL, 5, rel=True, what="nodisc + perceptual")


def test_segmentation_loss_and_previews(nets):
    vparams, _, vq, _, vcfg, _ = nets
    labels = np.random.RandomState(6).randint(0, 3, (2, 8, 8))
    x = np.eye(3, dtype=np.float32)[labels]
    fn = jax.jit(jax.value_and_grad(lambda p: jtr.vq_segmentation_loss(p, jnp.asarray(x), vcfg),
                                    has_aux=True))
    (want, aux_j), g = fn(vparams)
    got, aux_t = ttr.vq_segmentation_loss(vq, t(x), vq.cfg)
    (tv,) = _grads(got, vq)
    assert_close(got, want, TOL, 6, rel=True, what="segmentation loss")
    np.testing.assert_array_equal(aux_t["indices"].numpy(), np.asarray(aux_j["indices"]))
    for k in ("bce_loss", "codebook_loss", "commit_loss", "logits"):
        assert_close(aux_t[k].detach(), aux_j[k], TOL, 6, rel=True, what=k)
    grad_close(tv, g, TOL, 6)
    colorize = randn(7, 3, 3)
    for from_logits, inp in ((False, x), (True, np.asarray(aux_j["logits"]))):
        want = jtr.segmentation_to_rgb(jnp.asarray(colorize), jnp.asarray(inp), from_logits)
        got = ttr.segmentation_to_rgb(t(colorize), t(inp), from_logits)
        assert_close(got, want, TOL, 7, rel=True, what=f"to_rgb from_logits={from_logits}")
        assert float(got.min()) >= -1.0 - 1e-6 and float(got.max()) <= 1.0 + 1e-6
    c = ttr.colorize_init(torch.Generator().manual_seed(0), 5)
    assert tuple(c.shape) == jtr.colorize_init(jax.random.key(0), 5).shape


@pytest.mark.parametrize("loss_type", ["hinge", "vanilla"])
def test_discriminator_loss(nets, loss_type):
    vparams, dparams, vq, disc, vcfg, dcfg = nets
    x = randn(8, 2, 16, 16, 3)

    def jloss(dp, step):
        return jtr.vqgan_discriminator_loss(dp, vparams, jnp.asarray(x), step, vcfg, dcfg,
                                            disc_start=DISC_START, loss_type=loss_type)

    fn = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    for step in (0, DISC_START):
        (want, aux_j), g = fn(dparams, step)
        got, aux_t = ttr.vqgan_discriminator_loss(disc, vq, t(x), step, vq.cfg, disc.cfg,
                                                  disc_start=DISC_START, loss_type=loss_type)
        vq.zero_grad()
        (td,) = _grads(got, disc)
        assert_close(got, want, TOL, 8, rel=True, what=f"{loss_type} at {step}")
        for k in ("logits_real", "logits_fake"):
            assert_close(aux_t[k].detach(), aux_j[k], TOL, 8, rel=True, what=k)
        grad_close(td, g, TOL, 8)
        # the reconstruction is a constant: no gradient reaches the codec
        assert all(p.grad is None or not p.grad.any() for p in vq.parameters())


def test_a_training_step_moves_every_trainable_weight(nets):
    """One generator and one discriminator step with Adam (0.5, 0.9), as
    the reference trains the VQ-GAN, after the discriminator starts. The
    discriminator step takes the vanilla loss: under the hinge loss the
    output bias's gradient is 0.5 · (share of fake patches inside the
    margin − share of real ones), zero when all sit inside it, as at this
    small init."""
    _, _, vq0, disc0, _, _ = nets
    import copy

    vq, disc = copy.deepcopy(vq0), copy.deepcopy(disc0)
    before = {n: p.detach().clone() for n, p in [*vq.named_parameters(prefix="vq"),
                                                 *disc.named_parameters(prefix="disc")]}
    opt_g = torch.optim.Adam(vq.parameters(), lr=1e-3, betas=(0.5, 0.9))
    opt_d = torch.optim.Adam(disc.parameters(), lr=1e-3, betas=(0.5, 0.9))
    x = t(randn(9, 2, 16, 16, 3))
    loss_g, _ = ttr.vqgan_generator_loss(vq, disc, x, DISC_START, vq.cfg, disc.cfg,
                                         disc_start=DISC_START)
    opt_g.zero_grad()
    loss_g.backward()
    opt_g.step()
    loss_d, _ = ttr.vqgan_discriminator_loss(disc, vq, x, DISC_START, vq.cfg, disc.cfg,
                                             disc_start=DISC_START, loss_type="vanilla")
    opt_d.zero_grad()
    loss_d.backward()
    opt_d.step()
    assert np.isfinite(loss_g.item()) and np.isfinite(loss_d.item())
    after = dict([*vq.named_parameters(prefix="vq"), *disc.named_parameters(prefix="disc")])
    still = [n for n, p in after.items() if torch.equal(p.detach(), before[n])]
    assert not still, still
