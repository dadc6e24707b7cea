"""Random number generation.

Generators are explicit ``torch.Generator`` objects, threaded through the
calls that draw. The synth-detect kernel draws its own noise from a
counter-based Philox4x32-10 keyed by a 64-bit integer drawn here
(:mod:`fast_tpu_torch.ops.synth_detect`). The streams differ from JAX's,
so the port agrees with the JAX package in distribution, not bit for bit.
"""

import numpy as np
import torch


def make_generator(seed=None, device="cpu"):
    """A seeded generator on ``device``; fresh OS entropy when ``seed`` is
    None."""
    if seed is None:
        seed = int(np.random.SeedSequence().generate_state(1, np.uint64)[0])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    return g


def draw_seed(generator):
    """A 63-bit integer from ``generator``: the seed of a derived stream."""
    return int(torch.randint(0, 2 ** 63 - 1, (), generator=generator,
                             device=generator.device))


def complex_normal(shape, generator, dtype=torch.complex64):
    """Standard complex normal: unit-variance real and imaginary parts
    (the reference's ``N(0,1) + 1j N(0,1)``, ``fast/funcs.py:352-356``)."""
    rdtype = torch.float32 if dtype == torch.complex64 else torch.float64
    both = torch.randn((2,) + tuple(shape), generator=generator,
                       dtype=rdtype, device=generator.device)
    return torch.complex(both[0], both[1])
