"""Global RNG (counterpart of `mxnet_tpu/random.py`).

`mx.random.seed(s)` seeds one explicit `torch.Generator` per device; the
initializers and `Dropout` draw from the generator of the device their
tensor lives on. The JAX package chains one PRNG key; the two packages
draw different numbers from the same seed, so the parity tests make
their inputs with numpy and carry parameters across by name.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator"]

_lock = threading.Lock()
_seed = 0
_generators = {}                 # torch.device -> torch.Generator


def seed(seed_state, ctx="all"):
    """Seed the generator of every device. `ctx` is accepted for the
    reference signature; as in the JAX package, every device is
    reseeded."""
    global _seed
    with _lock:
        _seed = int(seed_state)
        _generators.clear()


def generator(device):
    """The generator of `device`, made on first use from the last
    `seed()` (0 before any)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        gen = _generators.get(dev)
        if gen is None:
            gen = _generators[dev] = torch.Generator(device=dev).manual_seed(
                _seed)
        return gen


def _snapshot():
    """The state of every generator made so far (for a trial step that
    must leave the draws as they were)."""
    with _lock:
        return {dev: gen.get_state() for dev, gen in _generators.items()}


def _restore(snap):
    """Put the generators back to `_snapshot()`'s states; a generator
    made since then starts again from the seed."""
    with _lock:
        for dev, gen in _generators.items():
            if dev in snap:
                gen.set_state(snap[dev])
            else:
                gen.manual_seed(_seed)
