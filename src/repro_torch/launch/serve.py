"""Batched serving driver: prefill + decode loop with a continuous batch.

The JAX package's ``launch/serve.py`` engine.  Requests arrive with
prompts; the engine prefills each prompt at batch 1 and splices its cache
into a free slot (a K/V leaf at ``[0:P]``, a recurrent state whole, the
encoder output on its batch axis), then decodes all active slots in
lockstep, retiring finished sequences and admitting queued requests into
freed slots (continuous batching).  Greedy (argmax) or temperature
sampling (Gumbel-max from a seeded ``torch.Generator``).  An
encoder-decoder's prefill takes zero encoder frames (1, enc_positions,
d), as the JAX engine feeds it; the JAX engine cannot splice the encoder
output (ROADMAP Queue 3), this one can.

It runs on the card unless the caller passes ``device="cpu"``, and raises
without CUDA; there is no fallback from one to the other.  On the card a
prompt longer than 2048 tokens prefills through the flash-attention
kernel (``models/attention.py``'s ``attend``).

The command line serves seeded requests with a reduced model (the JAX
package's ``main``: 4 slots, ``max_len`` 64, prompts of 4-11 tokens drawn
from ``numpy.random.default_rng(0)``, random weights from seed 0):

    python -m repro_torch.launch.serve --arch qwen1.5-0.5b
    python -m repro_torch.launch.serve --arch qwen1.5-0.5b --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.largevis import resolve_device, seeded_generator
from repro_torch.models import ssm
from repro_torch.models.factory import (cast_for_inference, init_cache,
                                        make_model)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Fixed-slot continuous-batching engine (slots x max_len cache).

    ``params``: the model's parameters as ``lm.init_lm`` or
    ``convert.lm_params_from_numpy`` make them, which the engine moves to
    its device and casts for inference in place; by default random
    weights drawn from ``seed``, as the JAX engine draws its own."""

    def __init__(self, cfg, *, slots: int = 4, max_len: int = 128,
                 temperature: float = 0.0, seed: int = 0, device="cuda",
                 params=None):
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.temperature = temperature
        self.device = resolve_device(device)
        self.model = make_model(cfg)
        if params is None:
            params = self.model["init"](seeded_generator(self.device, seed))
        self.params = cast_for_inference(params.to(self.device), cfg)
        self.generator = seeded_generator(self.device, seed + 1)
        self._prefill = self.model["prefill"]
        self._decode = self.model["decode"]
        # what the prefill takes after the tokens: an encoder-decoder's
        # encoder frames, zeros as the JAX engine feeds them
        self.frames = (torch.zeros((1, cfg.enc_positions, cfg.d_model),
                                   dtype=cfg.dtype, device=self.device),
                       ) if cfg.is_encoder_decoder else ()
        # slot state
        self.active: List[Optional[Request]] = [None] * slots
        self.positions = [0] * slots
        self.cache = None
        self.queue: List[Request] = []

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        """Queue a request; its prompt must be 1..max_len tokens in
        [0, vocab_size), and fit the mamba layers' chunked scan where the
        model has them."""
        if not 1 <= len(req.prompt) <= self.max_len:
            raise ValueError(f"request {req.rid}: prompt of "
                             f"{len(req.prompt)} tokens, the cache holds "
                             f"1..{self.max_len}")
        if not all(0 <= t < self.cfg.vocab_size for t in req.prompt):
            raise ValueError(f"request {req.rid}: a token outside "
                             f"[0, {self.cfg.vocab_size})")
        if "mamba" in self.cfg.block_pattern:
            ssm.check_chunks(len(req.prompt))
        self.queue.append(req)

    def _admit(self):
        """Fill free slots by prefilling queued prompts, one at a time,
        each spliced into its slot's rows of the batch cache."""
        for slot in range(self.slots):
            if self.active[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            toks = torch.tensor([req.prompt], dtype=torch.long,
                                device=self.device)
            logits, cache1 = self._prefill(self.params, toks, *self.frames)
            _splice(self.cache, cache1, slot)
            req.out.append(int(self._sample(logits)[0]))
            self.active[slot] = req
            self.positions[slot] = len(req.prompt)

    def _sample(self, logits):
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        u = torch.rand(logits.shape, generator=self.generator,
                       device=logits.device)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(logits / self.temperature + gumbel, dim=-1)

    def step(self):
        """One lockstep decode over all active slots."""
        if self.cache is None:
            self.cache = init_cache(self.cfg, self.slots, self.max_len,
                                    self.device)
        self._admit()
        if not any(r is not None for r in self.active):
            return False
        last = torch.tensor(
            [[r.out[-1] if r and r.out else 0] for r in self.active],
            dtype=torch.long, device=self.device)
        position = torch.tensor(self.positions, dtype=torch.long,
                                device=self.device)
        logits, self.cache = self._decode(self.params, last, self.cache,
                                          position)
        toks = self._sample(logits).tolist()
        self.positions = [p + 1 for p in self.positions]
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            req.out.append(toks[slot])
            if len(req.out) >= req.max_new or \
                    self.positions[slot] >= self.max_len - 1:
                req.done = True
                self.active[slot] = None
        return True

    def run(self, max_steps: int = 10_000):
        steps = 0
        while (self.queue or any(self.active)) and steps < max_steps:
            self.step()
            steps += 1
        return steps


def _splice(full: dict, one: dict, slot: int) -> None:
    """A batch-1 prefill cache into ``slot`` of the batch cache, in place.
    ``encoder_out`` (1, F, d) into row ``slot``; every other leaf (L, 1,
    T, ...), stacked over periods or layers, into ``[:, slot, :T]``: T is
    the prompt's length, a local layer's window W once the prompt reaches
    it (its ring buffer, slot = position mod W), or a recurrent state's
    full extent (the state whole)."""
    for name, leaf in one.items():
        if isinstance(leaf, dict):
            _splice(full[name], leaf, slot)
        elif name == "encoder_out":
            full[name][slot] = leaf[0]
        else:
            full[name][:, slot, :leaf.shape[2]] = leaf[:, 0]


def main(argv=None) -> list:
    """Serve ``--requests`` seeded requests on ``--device`` (the card by
    default, the CPU only when asked) and print what was served; returns
    the requests, their tokens in ``out``."""
    ap = argparse.ArgumentParser(description="serve seeded requests with "
                                 "a reduced model")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from repro_torch.configs import get_config

    cfg = get_config(args.arch).reduced()
    eng = ServeEngine(cfg, slots=4, max_len=64, device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, rng.integers(4, 12))
                    .tolist(), max_new=args.max_new)
            for i in range(args.requests)]
    t0 = time.time()
    for r in reqs:
        eng.submit(r)
    steps = eng.run()
    dt = time.time() - t0
    n_tokens = sum(len(r.out) for r in reqs)
    print(f"served {len(reqs)} requests, {n_tokens} tokens, {steps} engine "
          f"steps, {dt:.1f}s on {eng.device}")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out}")
    return reqs


if __name__ == "__main__":
    main()
