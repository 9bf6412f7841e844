"""One command for every app: ``ctgan-tpu-torch <app> [app args...]`` (or
``python -m ctgan_tpu_torch``), the counterpart of ``ctgan_tpu/__main__.py``.

Each app is a module with a ``Config`` dataclass and ``main(argv,
device=...)`` that takes ``--FIELD value`` for every field; this dispatcher
routes a short name (the JAX package's) to the port's module.
``--platform cpu|cuda`` (or ``--device``), as the first argument, picks the
device the app runs on; the default is ``cuda``.  ``flagship`` names
``cifar-resnet``.

Under ``torchrun`` every process runs the same command, and the flagship
and ``generate`` run over all of them (``apps.common.maybe_mesh``): NCCL
on the card, one GPU per process, gloo with ``--platform cpu``:

    torchrun --nproc_per_node 2 -m ctgan_tpu_torch --platform cpu flagship --ITERS 3 --DIM_G 16 --DIM_D 16
    torchrun --nproc_per_node 8 -m ctgan_tpu_torch flagship --MODEL_AXIS 2 --out_dir runs/flagship
"""

from __future__ import annotations

import importlib
import sys

# short name -> (module, one-line description, reference script)
APPS = {
    "mnist": ("ctgan_tpu_torch.apps.ct_gan_mnist",
              "CT-GAN on 1000-example MNIST (dcgan/wgan/wgan-CT modes)",
              "CT_gan_mnist.py"),
    "cifar": ("ctgan_tpu_torch.apps.ct_gan_cifar",
              "CT-GAN on 1000-example CIFAR-10 with Inception Score",
              "CT_gan_cifar.py"),
    "cifar-resnet": ("ctgan_tpu_torch.apps.ct_gan_cifar_resnet",
                     "conditional ResNet CT-GAN + ACGAN on full CIFAR-10 (flagship)",
                     "CT_gan_cifar_resnet.py"),
    "good64": ("ctgan_tpu_torch.apps.ct_gan_64x64",
               "64x64 ImageNet-style CT-GAN (architecture zoo)",
               "CT_gan_64x64.py"),
    "lsun128": ("ctgan_tpu_torch.apps.wgan_lsun128",
                "128x128 ResNet WGAN-GP+CT (LSUN bedrooms)",
                "LSUN_bedrooms/wgan_LSUN_Bedrooms128.py"),
    "mnist-ssl": ("ctgan_tpu_torch.apps.ct_mnist_ssl",
                  "semi-supervised 100-label MNIST classifier",
                  "Theano_classifier/CT_MNIST.py"),
    "cifar-ssl": ("ctgan_tpu_torch.apps.ct_cifar_ssl",
                  "semi-supervised 4000-label CIFAR-10 (+--temporal_ensembling)",
                  "Theano_classifier/CT_CIFAR.py, CT_CIFAR-10_TE.py"),
    "onehot-toys": ("ctgan_tpu_torch.apps.onehot_toys",
                    "one-hot WGAN + autoencoder toys",
                    "LSUN_bedrooms/wgan_onehots.py, onehot_autoencoder.py"),
    "generate": ("ctgan_tpu_torch.apps.generate",
                 "sample from a trained checkpoint (serving path)",
                 "(new; reference inlined sampling in the trainers)"),
}
PLATFORMS = ("cpu", "cuda")
ALIASES = {"flagship": "cifar-resnet"}


def _usage() -> str:
    lines = ["usage: ctgan-tpu-torch [--platform cpu|cuda] <app> [--FIELD value ...]", "",
             "apps (each accepts --help-style --FIELD overrides of its Config):"]
    width = max(len(k) for k in APPS)
    for name, (_, desc, ref) in APPS.items():
        lines.append(f"  {name:<{width}}  {desc}")
        lines.append(f"  {'':<{width}}    reference: {ref}")
    lines.append("")
    lines.append("e.g.  ctgan-tpu-torch cifar-resnet --ITERS 100000 --out_dir runs/flagship")
    lines.append("      ('flagship' names cifar-resnet; --device is --platform)")
    lines.append("      torchrun --nproc_per_node N -m ctgan_tpu_torch flagship ...  (cifar-resnet and generate "
                 "run over the N processes: NCCL, one GPU each; gloo with --platform cpu)")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    try:
        return _dispatch(argv)
    except BrokenPipeError:
        # ``ctgan-tpu-torch list | head``: the reader closed the pipe; exit
        # quietly instead of printing a traceback
        sys.stderr.close()
        return 0


def _dispatch(argv: list[str] | None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if argv and argv[0] in ("--platform", "--device"):
        if len(argv) < 2 or argv[1] not in PLATFORMS:
            print(f"ctgan-tpu-torch: {argv[0]} needs a value (cpu|cuda)", file=sys.stderr)
            return 2
        device, argv = argv[1], argv[2:]
    if not argv or argv[0] in ("-h", "--help", "list"):
        print(_usage())
        return 0
    name, rest = ALIASES.get(argv[0], argv[0]), argv[1:]
    if name not in APPS:
        print(f"ctgan-tpu-torch: unknown app '{name}'\n\n{_usage()}", file=sys.stderr)
        return 2
    module = importlib.import_module(APPS[name][0])
    module.main(rest, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
