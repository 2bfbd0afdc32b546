"""PyTorch port vs the JAX package: gradients of the path tracer and the
optimizer.

* `jax.grad` of the summed `trace_paths` radiance to `ke`, `kd` and `n_s`
  against `torch.autograd`, both on the same 8x8 Cornell camera rays and the
  same uniforms (rebuilt from the JAX key).  Tolerance: rtol 1e-3 on the
  components above 1e-4 of the largest, atol 1e-4 of the largest below.
  Against JAX run op by op (each primitive rounded on its own, as in
  PyTorch) the measured difference is ~1e-7 relative; the jitted function
  (XLA fusion, FMA contraction) is within ~1e-4.  The reference's `n_s`
  gradient is NaN on the rows of the sphere materials that the paths reach
  (a behaviour of the reference, jitted or not); the port must give NaN on
  the same rows and agree on the others.
* The port's gradient against its own central finite difference along a
  random direction in kd-space, at the size and tolerance (5%) of
  tests/test_render.py::test_grad_matches_finite_difference.
* `render_image_value_and_grad` (path replay, one chunk's graph at a time)
  against plain autograd through `render_image` (one graph) at 16x16, with
  chunks of 128 rays: rtol 1e-5 (the same paths; sums in another order).
* `optimize` for 3 steps against the JAX `optimize` from the same start,
  with the port's per-step randomness rebuilt from the JAX keys: parameters
  and losses to rtol 2e-3 (Adam divides by sqrt(v) + 1e-8, which amplifies
  gradient differences where a component is near 0, hence also atol 1e-4).
  Adam itself (torch.optim.Adam at optax's defaults, clamp at 0) is held to
  optax on a fixed gradient sequence, rtol 1e-4.
* The emitter-recovery case of tests/test_optim.py at its size and
  tolerance, with the port's own generator stream; checkpoint and resume.
* `sppm_loss_fn`'s (loss, grads) contract (the loss through the photon
  mapper; its gradients are held in tests/test_torch_sppm_diff.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity
from gpu_pathtracer_tpu import optim as joptim
from gpu_pathtracer_tpu.models.camera import Camera as JCamera
from gpu_pathtracer_tpu.render import integrator as jint
from gpu_pathtracer_tpu_torch import optim
from gpu_pathtracer_tpu_torch.models import convert
from gpu_pathtracer_tpu_torch.models.camera import Camera
from gpu_pathtracer_tpu_torch.render import integrator

torch.set_num_threads(1)
CAM = dict(eye=(0.5, 0.5, 2.4), center=(0.5, 0.5, 0.0), up=(0, 1, 0), fovy_deg=40.0)
NAMES = ("ke", "kd", "n_s")


@pytest.fixture(scope="module")
def cornell():
    _, jscene, _ = torch_parity.cornell_scenes()
    return jscene, convert.scene_from_numpy(torch_parity.flatten(jscene), "cpu")


def _camera_rays(n: int):
    ii, jj = np.meshgrid(np.arange(n, dtype=np.float32), np.arange(n, dtype=np.float32),
                         indexing="ij")
    zeros = np.zeros(n * n, np.float32)
    o, d = JCamera.create(**CAM, width=n, height=n).generate_rays(
        ii.reshape(-1) + 0.5, jj.reshape(-1) + 0.5, zeros, zeros)
    return np.array(o), np.array(d)


def _leaves(scene, names):
    return {n: optim._get_param(scene.materials, n).clone().requires_grad_(True) for n in names}


def _trace_grads(cornell, level):
    """(jax.grad function of the summed radiance, its argument, the port's
    gradients)."""
    jscene, scene = cornell
    o, d = _camera_rays(8)
    key = jax.random.key(2024)

    def jloss(p):
        scn = dataclasses.replace(jscene, materials=dataclasses.replace(jscene.materials, **p))
        return jnp.sum(jint.trace_paths(scn, o, d, key, level=level, hittable_pdf_weight=0.5))

    leaves = _leaves(scene, NAMES)
    val = integrator.trace_paths(
        optim._substitute(scene, leaves), torch.from_numpy(o), torch.from_numpy(d), level=level,
        hittable_pdf_weight=0.5,
        uniforms=torch.from_numpy(torch_parity.uniforms_from_key(key, level, 64)),
    ).sum()
    grads = torch.autograd.grad(val, list(leaves.values()))
    p0 = {n: getattr(jscene.materials, n) for n in NAMES}
    return jax.grad(jloss), p0, dict(zip(NAMES, (g.numpy() for g in grads)))


# op by op, JAX dispatches every primitive of the backward pass from Python
# (~10 s per bounce), so that case runs one bounce fewer
@pytest.mark.parametrize("jitted,level", [(False, 2), (True, 3)])
def test_trace_paths_grad_matches_jax(cornell, jitted, level):
    jgrad, p0, got = _trace_grads(cornell, level)
    if jitted:
        ref = jax.jit(jgrad)(p0)
    else:
        with jax.disable_jit():
            ref = jgrad(p0)
    for name in NAMES:
        a, b = got[name], np.asarray(ref[name])
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
        ok = ~np.isnan(b)
        scale = np.abs(b[ok]).max()
        np.testing.assert_allclose(a[ok], b[ok], rtol=1e-3, atol=1e-4 * scale, err_msg=name)
    assert np.abs(got["ke"]).max() > 1.0 and np.abs(got["kd"]).max() > 1.0
    # the glossy sphere's row and, from the third bounce, the glass sphere's
    assert np.isnan(got["n_s"]).sum() == level - 1


def test_grad_matches_finite_difference(cornell):
    _, scene = cornell
    n_rays, level = 64, 4
    o = torch.tensor([[0.5, 0.5, 2.4]]).repeat(n_rays, 1)
    t = torch.linspace(-0.3, 0.3, n_rays)
    d = torch.stack([t, torch.zeros_like(t), -torch.ones_like(t)], -1)
    d = d / d.norm(dim=-1, keepdim=True)
    uni = torch.rand((level, integrator.N_UNIFORMS, n_rays),
                     generator=torch.Generator().manual_seed(5))

    def f(kd):
        img = integrator.trace_paths(optim._substitute(scene, {"kd": kd}), o, d, level=level,
                                     hittable_pdf_weight=0.5, uniforms=uni)
        return torch.mean(img ** 2)

    kd = scene.materials.kd.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(f(kd), kd)
    assert torch.isfinite(g).all() and float(g.norm()) > 1e-6
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(kd.shape).astype(np.float32))
    v[kd.detach().amax(dim=-1) <= 0.0] = 0.0  # no gradient support where kd == 0
    directional = float((g * v).sum())
    eps = 3e-4
    with torch.no_grad():
        fd = (float(f(kd + eps * v)) - float(f(kd - eps * v))) / (2 * eps)
    assert abs(directional - fd) < 0.05 * max(abs(fd), abs(directional), 1e-3), (directional, fd)


def test_replay_grad_equals_one_graph(cornell):
    _, scene = cornell
    n = 16
    cam = Camera.create(**CAM, width=n, height=n)
    target = torch.full((n, n, 3), 0.2)
    kw = dict(sample_size=2, level=3, hittable_pdf_weight=0.5, ray_chunk=128)

    def image_loss(img):
        return torch.mean((img - target) ** 2)

    leaves = _leaves(scene, ("ke", "kd", "ks"))
    scn = optim._substitute(scene, leaves)
    gen = torch.Generator().manual_seed(9)
    img1 = integrator.render_image(scn, cam, n, n, generator=gen, **kw)
    after_one = gen.get_state()
    loss1 = image_loss(img1)
    g1 = torch.autograd.grad(loss1, list(leaves.values()))

    gen = torch.Generator().manual_seed(9)
    loss2, img2, g2 = integrator.render_image_value_and_grad(
        scn, cam, n, n, image_loss, list(leaves.values()), generator=gen, **kw)
    torch.testing.assert_close(img2, img1.detach(), rtol=0, atol=0)
    torch.testing.assert_close(loss2, loss1.detach(), rtol=0, atol=0)
    for a, b in zip(g2, g1):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-9)
    assert float(g1[0].abs().max()) > 0
    assert torch.equal(gen.get_state(), after_one)  # the stream goes on as after one render
    assert not img2.requires_grad and all(p.grad is None for p in leaves.values())


def test_adam_matches_optax():
    rng = np.random.default_rng(3)
    p0 = rng.uniform(0.0, 1.0, (5, 3)).astype(np.float32)
    grads = rng.standard_normal((6, 5, 3)).astype(np.float32)
    opt = optax.adam(0.05)
    jp, state = jnp.asarray(p0), None
    state = opt.init(jp)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, jp)
        jp = jnp.maximum(optax.apply_updates(jp, updates), 0.0)

    steps = iter(grads)
    params, _ = optim.optimize(
        _scene_with(kd=p0), None, None, param_names=("kd",), steps=6, lr=0.05,
        loss_fn=lambda params, gen: (torch.tensor(0.0), {"kd": torch.from_numpy(next(steps))}),
    )
    # the two group m / (sqrt(v) + eps) differently: a few float32 ulps per step
    np.testing.assert_allclose(params["kd"].numpy(), np.asarray(jp), rtol=1e-4, atol=1e-6)
    assert (params["kd"].numpy() == 0).any()  # the clamp was active


def _scene_with(**fields):
    """A stand-in scene holding only what `optimize` reads without a render."""
    from types import SimpleNamespace

    mats = SimpleNamespace(**{k: torch.from_numpy(v) for k, v in fields.items()})
    return SimpleNamespace(materials=mats, geom=SimpleNamespace(p=torch.zeros(1)))


def test_optimize_matches_jax_optimize(cornell):
    """Three Adam steps on kd and ke from the same start.  The port's loss
    function is given the reference's randomness: per step i and sample s,
    skey = fold_in(fold_in(fold_in(key, i), s), 7) (one chunk), lens jitter
    from sub-keys 0 and 1, path uniforms from sub-key 2."""
    jscene, scene = cornell
    n, spp, level, steps = 8, 2, 2, 3
    key = jax.random.key(4)
    jcam = JCamera.create(**CAM, width=n, height=n)
    cam = Camera.create(**CAM, width=n, height=n)
    jtarget = jint.render_image(jscene, jcam, jax.random.key(11), width=n, height=n,
                                sample_size=4, level=level, hittable_pdf_weight=0.5)
    target = torch.from_numpy(np.array(jtarget))
    dim = {"ke": jscene.materials.ke * 0.5, "kd": jscene.materials.kd * 0.8}
    jdim = dataclasses.replace(jscene, materials=dataclasses.replace(jscene.materials, **dim))
    jparams, jlosses = joptim.optimize(
        jdim, jcam, jtarget, param_names=("ke", "kd"), steps=steps, lr=0.05, key=key,
        sample_size=spp, level=level,
    )

    pix = torch.arange(n, dtype=torch.float32) + 0.5
    pix_i, pix_j = (x.reshape(-1) for x in torch.meshgrid(pix, pix, indexing="ij"))
    step = iter(range(steps))

    def loss_fn(params, _generator):
        i = next(step)
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        scn = optim._substitute(scene, leaves)
        total = 0.0
        for s in range(spp):
            skey = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(key, i), s), 7)
            u1, u2 = (torch.from_numpy(np.array(jax.random.uniform(
                jax.random.fold_in(skey, j), (n * n,)))) for j in (0, 1))
            o, d = cam.generate_rays(pix_i, pix_j, u1, u2)
            uni = torch_parity.uniforms_from_key(jax.random.fold_in(skey, 2), level, n * n)
            total = total + integrator.trace_paths(
                scn, o, d, level=level, hittable_pdf_weight=0.5, uniforms=torch.from_numpy(uni))
        loss = torch.mean(((total / spp).reshape(n, n, 3) - target) ** 2)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    start = convert.params_from_numpy({k: np.asarray(v) for k, v in dim.items()}, "cpu")
    params, losses = optim.optimize(
        optim._substitute(scene, start), cam, target, param_names=("ke", "kd"), steps=steps,
        lr=0.05, loss_fn=loss_fn,
    )
    np.testing.assert_allclose(losses, jlosses, rtol=2e-3)
    got = convert.params_to_numpy(params)
    for name in ("ke", "kd"):
        np.testing.assert_allclose(got[name], np.asarray(jparams[name]), rtol=2e-3, atol=1e-4,
                                   err_msg=name)
    assert not np.allclose(got["ke"], np.asarray(dim["ke"]))  # the steps moved it


@pytest.fixture(scope="module")
def box_setup(tmp_path_factory):
    """The Cornell box without spheres at 12x12, and a target rendered by
    the port (the setup of tests/test_optim.py)."""
    from gpu_pathtracer_tpu_torch.models.scene import build_scene
    from gpu_pathtracer_tpu_torch.utils import obj_io, testscenes

    folder = tmp_path_factory.mktemp("cornell_opt_torch")
    testscenes.make_cornell_box(folder, spheres=False)
    scene = build_scene(obj_io.load_scene(folder, "box.obj"), "cpu")
    cam = Camera.create(**CAM, width=12, height=12)
    with torch.no_grad():
        target = integrator.render_image(
            scene, cam, 12, 12, sample_size=8, level=3, hittable_pdf_weight=0.5,
            generator=torch.Generator().manual_seed(11))
    return scene, cam, target


def test_emitter_recovery(box_setup):
    scene, cam, target = box_setup
    true_ke = scene.materials.ke
    dim = optim._substitute(scene, {"ke": true_ke * 0.3})
    params, losses = optim.optimize(dim, cam, target, param_names=("ke",), steps=12, lr=0.5,
                                    seed=1, sample_size=4, level=3)
    assert losses[-1] < losses[0] * 0.7, losses
    emissive = true_ke.amax(dim=-1) > 0
    err0 = float((true_ke * 0.3 - true_ke).abs()[emissive].mean())
    err1 = float((params["ke"] - true_ke).abs()[emissive].mean())
    assert err1 < err0, (err0, err1)
    assert float(params["ke"].min()) >= 0.0


def test_checkpoint_resume(box_setup, tmp_path):
    """Interrupt after 4 steps, resume to 6: the resumed run takes only the
    missing steps and lands on the parameters of an uninterrupted run."""
    scene, cam, target = box_setup
    kw = dict(param_names=("kd",), lr=0.05, seed=2, checkpoint_every=2, sample_size=2, level=2)
    ckpt = str(tmp_path / "ck")
    _, losses_a = optim.optimize(scene, cam, target, steps=4, checkpoint_dir=ckpt, **kw)
    params_b, losses_b = optim.optimize(scene, cam, target, steps=6, checkpoint_dir=ckpt, **kw)
    params_c, losses_c = optim.optimize(scene, cam, target, steps=6, **kw)
    assert len(losses_a) == 4 and len(losses_b) == 2, (losses_a, losses_b)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step_4.pt", "step_5.pt"]
    torch.testing.assert_close(params_b["kd"], params_c["kd"], rtol=0, atol=0)
    assert losses_a + losses_b == losses_c


def test_sppm_loss_is_not_ported(box_setup):
    """(The name dates from before the loss was ported.)  `sppm_loss_fn`'s
    contract, as `optimize` uses it: (params, generator) -> (loss, grads),
    the loss a detached scalar equal to the L2 loss of
    `render_sppm_differentiable` from the loss's seed (rtol 1e-6), one finite
    gradient of each parameter's shape, not zero on the light's row of `ke`;
    a generator draws the render's seed from its own stream.
    `SPPM_LOSS_PRODUCTION` equals the reference's."""
    from gpu_pathtracer_tpu_torch.render.sppm import render_sppm_differentiable

    scene, cam, target = box_setup
    sizes = dict(n_photons=64, num_pass=1, max_bounce=3, eye_bounce=4)
    loss_fn = optim.sppm_loss_fn(scene, cam, target, seed=5, **sizes)
    params = {n: optim._get_param(scene.materials, n).clone() for n in ("ke", "kd")}
    loss, grads = loss_fn(params, None)
    with torch.no_grad():
        img = render_sppm_differentiable(scene, cam, 12, 12, seed=5, **sizes)
    assert loss.shape == () and not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(torch.mean((img - target) ** 2)), rtol=1e-6)
    assert set(grads) == set(params)
    for name, grad in grads.items():
        assert grad.shape == params[name].shape and bool(torch.isfinite(grad).all()), name
    light = scene.materials.ke.amax(dim=-1) > 0
    assert bool((grads["ke"][light] != 0).any())
    again, _ = loss_fn(params, None)
    drawn = [float(loss_fn(params, torch.Generator().manual_seed(s))[0]) for s in (1, 1, 2)]
    assert float(again) == float(loss) and drawn[0] == drawn[1] != drawn[2]
    assert optim.SPPM_LOSS_PRODUCTION == joptim.SPPM_LOSS_PRODUCTION
