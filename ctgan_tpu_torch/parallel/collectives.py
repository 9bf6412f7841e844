"""The collectives of the port's parallel training, over
``torch.distributed`` groups: an all-reduce that autograd runs through (at
any order), the gradients' one flat all-reduce, and the model axis's
all-gather.  On the card they run on the current stream's work, so a
captured step holds them (NCCL); gloo runs them eagerly.  ``CALLS`` counts
the collectives issued, by kind (a captured step issues its own once, at
the capture)."""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["CALLS", "all_gather_cat", "all_reduce_sum", "flat_mean"]

CALLS = {"all_reduce": 0, "all_gather": 0}


def _all_reduce(t: torch.Tensor, group) -> None:
    dist.all_reduce(t, group=group)
    CALLS["all_reduce"] += 1


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``; the backward is the same sum of the cotangents,
    itself differentiable, so a double backward (the gradient penalty)
    runs through it too."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.contiguous().clone()
        _all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the processes of ``group``, differentiable."""
    return _AllReduceSum.apply(x, group)


def flat_mean(tensors: list[torch.Tensor], group, world: int) -> list[torch.Tensor]:
    """The mean over ``group``'s ``world`` processes of each of ``tensors``
    (one dtype), in one all-reduce of one flat buffer."""
    if not tensors:
        return []
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    _all_reduce(flat, group)
    flat /= world
    return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def all_gather_cat(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The ``size`` processes' ``x`` of ``group`` concatenated along
    ``dim``, in rank order."""
    x = x.detach().contiguous()
    home = x.device
    if home.type == "cuda" and dist.get_backend(group) == "gloo":
        x = x.cpu()  # gloo gathers host tensors only
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    CALLS["all_gather"] += 1
    return torch.cat(parts, dim).to(home)
