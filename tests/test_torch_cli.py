"""The port's dispatcher (``ctgan_tpu_torch/__main__.py``) against the JAX
package's (``tests/test_cli.py``): the same app names, descriptions and
reference scripts, usage, exit codes, and ``--platform``."""

from __future__ import annotations

import importlib
import inspect
import subprocess
import sys
from pathlib import Path

import pytest

from ctgan_tpu.__main__ import APPS as JAX_APPS

from ctgan_tpu_torch.__main__ import APPS, _usage, main

ROOT = Path(__file__).resolve().parents[1]


def test_the_apps_are_the_jax_packages():
    assert list(APPS) == list(JAX_APPS)
    for name, (module, desc, ref) in APPS.items():
        assert module == JAX_APPS[name][0].replace("ctgan_tpu.", "ctgan_tpu_torch.", 1)
        assert (desc, ref) == JAX_APPS[name][1:]


def test_usage_lists_every_app(capsys):
    assert main([]) == 0
    out = capsys.readouterr().out
    for name in APPS:
        assert name in out
    assert main(["list"]) == 0 and main(["-h"]) == 0
    assert capsys.readouterr().out == 2 * (_usage() + "\n")


def test_unknown_app_is_an_error(capsys):
    assert main(["no-such-app"]) == 2
    err = capsys.readouterr().err
    assert "unknown app" in err and "usage:" in err


@pytest.mark.parametrize("name", sorted(APPS))
def test_every_app_module_exposes_main(name):
    module = importlib.import_module(APPS[name][0])
    assert callable(module.main)
    assert inspect.signature(module.main).parameters["device"].default == "cuda"


def test_usage_cites_reference_scripts():
    text = _usage()
    assert "CT_gan_cifar_resnet.py" in text
    assert "CT_CIFAR-10_TE.py" in text


def test_package_version():
    import ctgan_tpu_torch

    assert ctgan_tpu_torch.__version__ == "0.1.0"


@pytest.mark.parametrize("argv,device", [(["onehot-toys", "--ITERS", "2"], "cuda"),
                                         (["--platform", "cpu", "onehot-toys", "--ITERS", "2"], "cpu"),
                                         (["--platform", "cuda", "generate"], "cuda")])
def test_platform_picks_the_apps_device(monkeypatch, argv, device):
    """``--platform`` (first) sets the device passed to the app's ``main``;
    the rest of the command line is the app's."""
    calls = []

    class Stub:
        @staticmethod
        def main(rest, device):
            calls.append((rest, device))

    monkeypatch.setattr(importlib, "import_module", lambda name: Stub)
    assert main(argv) == 0
    assert calls == [(argv[-2:] if argv[-1] == "2" else [], device)]


@pytest.mark.parametrize("argv", [["--platform"], ["--platform", "tpu", "mnist"]])
def test_platform_needs_cpu_or_cuda(argv, capsys):
    assert main(argv) == 2
    assert "--platform" in capsys.readouterr().err


def test_piped_output_closes_quietly():
    """``python -m ctgan_tpu_torch list | head -1``: the reader closing the
    pipe must not print a traceback."""
    proc = subprocess.run(f"{sys.executable} -m ctgan_tpu_torch list | head -1", shell=True,
                          capture_output=True, text=True, cwd=ROOT)
    assert proc.returncode == 0 and proc.stdout.startswith("usage: ctgan-tpu-torch")
    assert "Traceback" not in proc.stderr
