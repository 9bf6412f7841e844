"""The 64 px app's ``ARCH resnet101`` trainer step of ``ctgan_tpu_torch``
against ``ctgan_tpu``'s on the CPU: two whole iterations of ``GanTrainer``
(wgan-ct, the app's mode; dim 8, batch 4, one critic iteration, remat off)
against the JAX package's ``make_gan_trainer``, substep by substep, through
``tests/test_torch_gan_trainer.py``'s ``check_iterations``.  The 101-layer
D has no dropout, so no mask is drawn.

Tolerances: ``check_iterations``'s, except a substep's costs and metrics,
D's gradients and G's gradients, each bounded at 4 times the JAX
package's own largest fp32 distance from the port's float64 substep
(``tests/torch_resnet101_probe.py``):

* costs and metrics: 4 x 3.24e-4 of the value (JAX's ``gen_cost`` at step
  1; its ``disc_cost`` 1.69e-4 at step 0, 4.96e-5 at step 1);
* D's gradients: 4 x 4.01e-3 of a tensor's scale (JAX at step 0; 1.11e-3
  at step 1);
* G's gradients: 4 x 6.70e-2 (JAX at step 1).

The port's fp32 substeps lie 2.92e-4 and 2.77e-4 (``disc_cost``), 5.0e-6
(``gen_cost``), 3.01e-3 and 5.69e-3 (D's gradients) and 3.02e-2 (G's) from
float64.  Neither package loses digits: both fp32 G's images lie within
about 6e-6 (max) and 7e-7 (RMS) of the float64 G's (the port's 3.94e-6 and
5.11e-7, JAX's 5.61e-6 and 6.72e-7 at step 0).  The step itself is that
sensitive: shifting the float64 G's images by Gaussian noise of 1e-6
moves the gradient penalty by up to 1.7e-4 (step 0) and 6.4e-3 (step 1) of
its value, D's gradients by up to 3.4e-2 and G's by up to 8.9e-2 of a
tensor's scale, in jumps (ReLUs of the 101-layer nets flip).
"""

from __future__ import annotations

from ctgan_tpu.models import good64 as jax_good64

from ctgan_tpu_torch.models import good64 as port_good64

from test_torch_gan_trainer import DIM, Net, check_iterations

# the JAX package's largest fp32 gaps to the port's float64 substeps (the probe)
JAX_COST_GAP, JAX_D_GRAD_GAP, JAX_G_GRAD_GAP = 3.24e-4, 4.01e-3, 6.70e-2


def resnet101_net() -> Net:
    """The 101-layer bottleneck ResNet G and D at dim 8
    (``ctgan_tpu/apps/ct_gan_64x64.py:94-98``).  In exact arithmetic only
    the critic's output bias has a zero gradient (it cancels in the WGAN
    and CT differences): G has no norm after its last conv, and D's norms
    are layer norms after convs without biases."""
    import jax.numpy as jnp

    jax_fns = (lambda n, noise=None: jax_good64.resnet101_64_generator(n, noise, dim=DIM),
               lambda x: jax_good64.resnet101_64_discriminator(x, dim=DIM))
    port_fns = (lambda p, n, rand, noise=None: port_good64.resnet101_generator(p, n, rand, dim=DIM, noise=noise),
                lambda p, x, rand: port_good64.resnet101_discriminator(p, x, rand, dim=DIM))

    def params(seed):
        arrays = {k: jnp.asarray(v) for k, v in port_good64.resnet101_init_params(DIM, seed).items()}
        return ({k: v for k, v in arrays.items() if k.startswith("Generator")},
                {k: v for k, v in arrays.items() if k.startswith("Discriminator")})

    return Net(jax_good64, jax_fns, port_fns, params, 3 * 64 * 64, -1.0, ["Discriminator.Output.b"],
               grad_rtol=4 * JAX_D_GRAD_GAP, masks_per_pass=0, metric_rtol=4 * JAX_COST_GAP,
               gen_grad_rtol=4 * JAX_G_GRAD_GAP)


def test_resnet101_iterations_match_jax(monkeypatch):
    """wgan-ct with the 64 px app's linear decay (``check_iterations``)."""
    check_iterations("wgan-ct", dict(lr_decay=True, iters=10), monkeypatch, net=resnet101_net())
