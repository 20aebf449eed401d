"""Int8 gradient compression with error feedback — the JAX package's
``optim/grad_compress.py``.

Per leaf and per block of ``BLOCK`` elements, stochastic int8
quantization: a data-parallel all-reduce of the int8 payload moves about
a quarter of the f32 bytes.  Error feedback keeps the residual on the
rank and adds it back the next step, which leaves the sum of the steps'
gradients unbiased (Karimireddy et al. 2019).

The rounding noise is the one difference from JAX.  JAX gives each leaf
a key split from one; here the draws come from one ``torch.Generator``,
leaf by leaf in the order of the leaves' names.  :func:`_quantize_leaf`
takes the uniform draws as an argument, so the same draws give JAX's
``q`` and ``scale`` bit for bit.  Every division's divisor is a tensor
(in torch ``float / tensor`` is a reciprocal and a product), and
``torch.round`` rounds half to even, as ``jnp.round`` does.

The trainer does not call the compressor, as the JAX trainer does not: it
is a module of its own.  A gradient tree here is a mapping of names to
tensors, or a module tree of parameters (its ``named_parameters``).
"""
from __future__ import annotations

import torch

BLOCK = 2048
_F32 = torch.float32


def _leaves(grads) -> dict:
    """{name: tensor} of a mapping or a module tree, in name order."""
    if isinstance(grads, torch.nn.Module):
        grads = dict(grads.named_parameters())
    return {k: grads[k] for k in sorted(grads)}


def _blocks(g: torch.Tensor) -> torch.Tensor:
    flat = g.to(_F32).reshape(-1)
    pad = (-flat.numel()) % BLOCK
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)


def _noise_shape(g: torch.Tensor) -> tuple:
    return (-(-g.numel() // BLOCK), BLOCK)


def _quantize_leaf(g: torch.Tensor, uniform: torch.Tensor):
    """(q int8 (blocks, BLOCK), scale f32 (blocks, 1)) of ``g``, with
    ``uniform`` the draws in [0, 1) of the blocks' shape (JAX's
    ``jax.random.uniform(key, units.shape)``)."""
    flat = _blocks(g)
    dev = flat.device
    scale = flat.abs().amax(dim=1, keepdim=True) / torch.tensor(
        127.0, dtype=_F32, device=dev)
    scale = torch.clamp(scale, min=1e-12)
    units = flat / scale
    noise = uniform.to(_F32) - 0.5
    q = torch.clamp(torch.round(units + noise), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_leaf(q: torch.Tensor, scale: torch.Tensor, shape):
    flat = (q.to(_F32) * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def compress(grads, generator: torch.Generator) -> dict:
    """{name: (q, scale)} of every leaf, the noise drawn from
    ``generator`` leaf by leaf in name order."""
    out = {}
    for name, g in _leaves(grads).items():
        u = torch.rand(_noise_shape(g), generator=generator,
                       device=g.device, dtype=_F32)
        out[name] = _quantize_leaf(g, u)
    return out


def decompress(qtree: dict, like) -> dict:
    """{name: f32 tensor of ``like``'s leaf's shape}."""
    return {name: _dequantize_leaf(*qtree[name], g.shape)
            for name, g in _leaves(like).items()}


def compressed_grads_with_ef(grads, ef_state, generator: torch.Generator):
    """(the dequantized gradients for the optimizer, the new error-feedback
    state), both {name: tensor}.  An all-reduce would move the int8
    payload between quantizing and dequantizing; on one rank this is the
    same arithmetic."""
    leaves = _leaves(grads)
    if ef_state is None:
        ef_state = {k: torch.zeros_like(g) for k, g in leaves.items()}
    corrected = {k: g + ef_state[k] for k, g in leaves.items()}
    deq = decompress(compress(corrected, generator), corrected)
    new_ef = {k: corrected[k] - deq[k] for k in corrected}
    return deq, new_ef


def compression_ratio(grads) -> float:
    """Bytes of the int8 payload and its f32 scales over the f32 bytes."""
    comp = full = 0
    for g in _leaves(grads).values():
        n = g.numel()
        comp += n + -(-n // BLOCK) * 4
        full += n * 4
    return comp / max(full, 1)
