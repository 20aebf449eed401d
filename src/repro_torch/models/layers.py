"""Shared primitive layers: norms, rotary embeddings, MLPs, embeddings.

The JAX package's ``models/layers.py`` in PyTorch.  Parameters are plain
dicts of tensors at init (``models/lm.py`` wraps them in modules); each
``apply`` casts a weight to the activations' dtype at use, which is a
no-op for weights already cast for inference.  Norms, rotary angles,
logits and the training loss (``cross_entropy``) are f32.

On a ``(data, model)`` mesh a rank holds its blocks of the weights
(``runtime/sharding.py``'s rules): :func:`embed_sharded` looks up a
vocab-parallel table, :func:`mlp_sharded` runs the column- and
row-parallel MLP, both followed by the ``"model"`` sum, and
:func:`unembed` on a rank's rows of the table gives its vocab shard of the
logits, from which :func:`cross_entropy_sharded` takes the training loss.
The sums are ``launch/mesh.py``'s differentiable ones (``model_sum``,
``model_copy``), so the same code serves and trains.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import model_copy, model_sum


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(dim: int, device) -> dict:
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"]).to(dtype)


def init_layernorm(dim: int, device) -> dict:
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device),
            "bias": torch.zeros((dim,), dtype=torch.float32, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """In f32: the mean, the biased variance as the mean of squared
    deviations (``jnp.var``), scale and bias."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * params["scale"] + params["bias"]).to(dtype)


# ---------------------------------------------------------------------------
# Activations the JAX package computes its own way
# ---------------------------------------------------------------------------

def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` turns into
    the identity above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim//2,)."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to
    (..., seq).  Rotates the two halves of head_dim, in f32."""
    if theta <= 0:
        return x
    inv = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions.float()[..., None] * inv           # (..., seq, hd/2)
    cos = torch.cos(ang)[..., None, :]                 # (..., seq, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense / MLP
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, shape, scale: float = None):
    """Normal with std 1/sqrt(fan_in) (fan_in = shape[0]), or ``scale``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device).mul_(scale)


def init_mlp(generator, d_model: int, d_ff: int, mlp_type: str,
             bias: bool = False) -> dict:
    """The gated MLPs, or the gelu MLP, with zero biases under ``bias``
    (the encoder-decoder's)."""
    p = {}
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(generator, (d_model, d_ff))
        p["w_up"] = dense_init(generator, (d_model, d_ff))
        p["w_down"] = dense_init(generator, (d_ff, d_model))
    elif mlp_type == "gelu":
        p["w_up"] = dense_init(generator, (d_model, d_ff))
        p["w_down"] = dense_init(generator, (d_ff, d_model))
        if bias:
            dev = generator.device
            p["b_up"] = torch.zeros((d_ff,), dtype=torch.float32, device=dev)
            p["b_down"] = torch.zeros((d_model,), dtype=torch.float32,
                                      device=dev)
    else:
        raise ValueError(mlp_type)
    return p


def mlp(params, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    dtype = x.dtype
    if mlp_type in ("swiglu", "geglu"):
        gate = x @ params["w_gate"].to(dtype)
        up = x @ params["w_up"].to(dtype)
        act = F.silu(gate) if mlp_type == "swiglu" else \
            F.gelu(gate, approximate="tanh")
        return (act * up) @ params["w_down"].to(dtype)
    h = x @ params["w_up"].to(dtype)
    if "b_up" in params:
        h = h + params["b_up"].to(dtype)
    out = F.gelu(h, approximate="tanh") @ params["w_down"].to(dtype)
    if "b_down" in params:
        out = out + params["b_down"].to(dtype)
    return out


def mlp_sharded(params, x: torch.Tensor, mlp_type: str, d_ff: int,
                mesh) -> torch.Tensor:
    """:func:`mlp` on the rank's ff columns of ``w_gate``/``w_up`` (and
    ``b_up``) and its rows of ``w_down``, the partial outputs summed over
    ``"model"`` in rank order; a replicated ``b_down`` is added once,
    after the sum.  Weights whose ff does not divide the model axis are
    whole, and then nothing is summed.  Under autograd ``x``'s gradient
    is summed over ``"model"`` (``model_copy``)."""
    w_in = params["w_gate" if "w_gate" in params else "w_up"]
    if w_in.shape[1] == d_ff:
        return mlp(params, x, mlp_type)
    out = mlp({k: w for k, w in params.items() if k != "b_down"},
              model_copy(mesh, x), mlp_type)
    out = model_sum(mesh, out)
    if "b_down" in params:
        out = out + params["b_down"].to(x.dtype)
    return out


def mlp_flops(d_model: int, d_ff: int, mlp_type: str, n_tokens: int) -> float:
    """JAX's analytic flops of the MLP over ``n_tokens``."""
    n_mats = 3 if mlp_type in ("swiglu", "geglu") else 2
    return 2.0 * n_mats * d_model * d_ff * n_tokens


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(generator, vocab: int, d_model: int) -> dict:
    return {"table": torch.randn((vocab, d_model), generator=generator,
                                 dtype=torch.float32,
                                 device=generator.device) * 0.02}


def embed(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """The table's rows, cast to ``dtype`` (gathered first: the same
    values as casting the whole table)."""
    return params["table"][tokens].to(dtype)


def embed_sharded(params, tokens: torch.Tensor, dtype, vocab: int,
                  mesh) -> torch.Tensor:
    """:func:`embed` of a vocab-parallel table: the rank holds rows
    ``[m V/M, (m+1) V/M)``, looks up the ids in that range, writes zeros
    elsewhere, and the ``"model"`` sum adds the one nonzero term, so the
    rows are bitwise the unsharded lookup.  A whole table (V not dividing
    the model axis) is looked up as it is."""
    table = params["table"]
    v_loc = table.shape[0]
    if v_loc == vocab:
        return embed(params, tokens, dtype)
    ids = tokens - mesh.axis_index("model") * v_loc
    inside = (ids >= 0) & (ids < v_loc)
    rows = table[ids.clamp(0, v_loc - 1)].to(dtype)
    x = torch.where(inside[..., None], rows,
                    torch.zeros((), dtype=dtype, device=rows.device))
    return model_sum(mesh, x)


def unembed(params, x: torch.Tensor, table: torch.Tensor = None):
    """Logits in f32 (softmax stability); of a rank's rows of a
    vocab-parallel table, its vocab shard of them.  A full-f32 product: the card
    runs it with TF32 off (``core.largevis.resolve_device`` sets that)."""
    t = table if table is not None else params["table"]
    return x.float() @ t.float().T


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token cross-entropy with the z-loss term ``z_loss * lse**2``,
    on f32 logits: ``mean(lse - logit[label] + z_loss * lse**2)``, the
    JAX package's ``cross_entropy``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse.square()
    return loss.mean()


def cross_entropy_sharded(logits: torch.Tensor, labels: torch.Tensor, mesh,
                          z_loss: float = 1e-4) -> torch.Tensor:
    """:func:`cross_entropy` of vocab-parallel logits: ``logits`` is the
    rank's shard (columns ``[m V/M, (m+1) V/M)``), never gathered.  The
    row max is the max over ``"model"`` (exact, and held out of the
    gradient, as a log-sum-exp's is); each rank's sum of exponentials is
    added over ``"model"`` in rank order; the label's logit comes from
    the rank that holds it, added over ``"model"`` as one nonzero term.
    Every rank of the axis gets the same bits."""
    logits = logits.float()
    v_loc = logits.shape[-1]
    mx = logits.detach().amax(dim=-1)
    with mesh.timed("model_sum"):
        for other in mesh.all_gather_list(mx, "model"):
            mx = torch.maximum(mx, other)
    s = model_sum(mesh, torch.exp(logits - mx[..., None]).sum(dim=-1))
    lse = mx + torch.log(s)
    ids = labels.long() - mesh.axis_index("model") * v_loc
    inside = (ids >= 0) & (ids < v_loc)
    ll = torch.gather(logits, -1, ids.clamp(0, v_loc - 1)[..., None])[..., 0]
    ll = model_sum(mesh, torch.where(inside, ll, torch.zeros_like(ll)))
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse.square()
    return loss.mean()
