"""The collectives of the sharded render, each with the gradient its place
in the render needs (`torch.autograd.Function`s over `torch.distributed`).

The JAX package gets these from `shard_map`'s transposes: an
`all_gather` transposes to a reduce-scatter, and a views-replicated input
has its cotangents summed over the views axis. PyTorch has no such
transform, so each rule is written here:

- `gather(x, group, dim, sum_grads=True)`: the projected per-gaussian
  arrays, gathered over the splats group. Each rank then renders a
  different band from them, so the backward sums the ranks' gradients and
  keeps this rank's block (a reduce-scatter).
- `gather(x, group, dim, sum_grads=False)`: the image bands (and view
  blocks) gathered for a loss that every rank then computes the same way.
  Each rank holds the whole loss gradient already, so the backward keeps
  this rank's slice; a sum would count it once per rank.
- `sum_grads_over(x, group)`: the identity whose backward sums over the
  group, for scene shards replicated over the views axis.
- `split(x, group, dim)`: this rank's block, whose backward gathers every
  rank's block, so that a caller holding the whole scene gets its whole
  gradient on every rank.

Each rank passes tensors on its own device. NCCL takes CUDA tensors; gloo
takes CPU tensors and, from PyTorch 2.11, CUDA tensors too (it copies
them through host memory itself).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim`, in group rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of every rank's `x`, cut into equal blocks along `dim`: this
    rank's block."""
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's `x` (out of place)."""
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def local_block(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's block of `x`, cut into equal blocks along `dim`."""
    n = dist.get_world_size(group)
    return x.chunk(n, dim=dim)[dist.get_rank(group)]


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, sum_grads):
        ctx.group, ctx.dim, ctx.sum_grads = group, dim, sum_grads
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grads:
            return reduce_scatter(g, ctx.group, ctx.dim), None, None, None
        return local_block(g, ctx.group, ctx.dim), None, None, None


class _SumGradsOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return local_block(x, group, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


def gather(x: torch.Tensor, group, dim: int, sum_grads: bool) -> torch.Tensor:
    """`all_gather` along `dim`; the backward reduce-scatters
    (`sum_grads`) or keeps this rank's slice (see the module docstring)."""
    if not x.requires_grad:
        return all_gather(x, group, dim)
    return _Gather.apply(x, group, dim, sum_grads)


def sum_grads_over(x: torch.Tensor, group) -> torch.Tensor:
    """`x` unchanged; its gradient is summed over `group`."""
    return _SumGradsOver.apply(x, group) if x.requires_grad else x


def split(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's block of `x`; the gradient of `x` is every rank's block
    gradient, gathered."""
    return _Split.apply(x, group, dim) if x.requires_grad else local_block(x, group, dim)
