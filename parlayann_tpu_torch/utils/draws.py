"""The random draws of the HCNNG and pyNNDescent builds.

The JAX builders draw from ``jax.random`` (threefry), which the port does
not replay. Every draw of the port's two builders goes through one
:class:`Draws` object instead, and each call names what it is for, so a
test can hand in an object that replays the JAX key schedule and compare
the builds module by module:

- ``tree_bits(t, l, n)``: level ``l`` of cluster tree ``t`` (JAX
  build/cluster.py:58-59);
- ``reverse_bits(stage, m)``: the shuffle keys of ``_reverse_capped``
  (JAX build/pynndescent.py:95) in descent round ``stage`` (an int), the
  ``"polish"`` round or the ``"final"`` undirect prune;
- ``hops(r, n, s1, s2, J)``: descent round ``r``'s two ``randint`` draws
  (JAX build/pynndescent.py:168-174).

Random keys are signed int32, as the JAX package's uint32 bits become
after ``.astype(jnp.int32)``, and sort signed.

The default object draws from one explicit ``torch.Generator`` seeded with
the build's seed, in the order the build calls it: the card's generator
for a build on the card, the CPU's otherwise. On the host a descent
round's draws at 100K points took 0.26 s against 0.0003 s on the card's
generator (NVIDIA H100 80GB HBM3, ``chip_smoke.py`` phase 9), ten rounds
about as long as a whole pyNNDescent build on the card's draws (2.8 s),
so a card build draws on the card and is held to a CPU build of the same
seed by the graph-build parity bar only. ``host=True``
draws on the CPU and moves the results to the device, so the draws do
not depend on it and a card build can be compared with a CPU build
exactly. It is a test seam, not a user option.
"""

from __future__ import annotations

import torch

I32_MIN, I32_END = -(2 ** 31), 2 ** 31


class Draws:
    """Draws of one build from a generator seeded with ``seed``: on the CPU
    when ``host`` (then moved to ``device``), else on ``device``; ``host``
    defaults to whether ``device`` is the CPU."""

    def __init__(self, seed: int, device=None, host: bool | None = None):
        self.device = torch.device(device if device is not None else "cpu")
        if host is None:
            host = self.device.type == "cpu"
        where = torch.device("cpu") if host else self.device
        self.gen = torch.Generator(device=where).manual_seed(int(seed))

    def _randint(self, lo: int, hi: int, shape, dtype) -> torch.Tensor:
        x = torch.randint(lo, hi, shape, generator=self.gen, dtype=dtype,
                          device=self.gen.device)
        return x.to(self.device, non_blocking=True)

    def tree_bits(self, tree: int, level: int, n: int) -> torch.Tensor:
        """(n,) int32 random keys of one level of one cluster tree."""
        return self._randint(I32_MIN, I32_END, (n,), torch.int32)

    def reverse_bits(self, stage, m: int) -> torch.Tensor:
        """(m,) int32 random keys of one reverse pass."""
        return self._randint(I32_MIN, I32_END, (m,), torch.int32)

    def hops(self, rnd: int, n: int, s1: int, s2: int, J: int):
        """Descent round ``rnd``'s sampled join slots in [0, J) -> (first
        hops (n, s1), second hops (n, s1, s2)), int64."""
        c1 = self._randint(0, J, (n, s1), torch.int32)
        c2 = self._randint(0, J, (n, s1, s2), torch.int32)
        return c1.long(), c2.long()
