"""The one traffic generator: reads a mix (``perfbench/traffic/<mix>.json``)
and gives each request of a run its shape and its token ids, from the
run's seed alone.

One client sends its next request when the last has completed.  The
requests run in blocks of one request a length, each block in an order
drawn from the seed, so every seed sends the same mix of shapes; token ids
are uniform over the vocabulary.  A mix holds:

  ``lengths``      the prompt lengths S a request may have;
  ``batch``        prompts a request (B), or ``batch_tokens``: B = that / S;
  ``trace_slice``  the requests the profiler sees in a ``--trace 1`` run:
                   ``skip`` requests after the window opens, then
                   ``requests`` requests.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _seed_words(seed: int) -> List[int]:
    """A seed of any size or sign as non-negative 32-bit words."""
    seed = int(seed)
    words = [1 if seed < 0 else 0]
    seed = abs(seed)
    while True:
        words.append(seed & 0xFFFFFFFF)
        seed >>= 32
        if not seed:
            return words


def stream_seed(seed: int, stream: int) -> int:
    """A 62-bit seed of its own for ``stream`` (0 token ids, 3 weights)
    of the run's ``seed``."""
    ss = np.random.SeedSequence(_seed_words(seed) + [stream])
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(2))


class Traffic:
    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix = mix
        self.vocab = vocab
        self.lengths = [int(s) for s in mix["lengths"]]
        self._words = _seed_words(seed)
        self._token_base = stream_seed(seed, 0)
        self._blocks = {}

    def batch_of(self, S: int) -> int:
        if "batch" in self.mix:
            return int(self.mix["batch"])
        B, rem = divmod(int(self.mix["batch_tokens"]), S)
        if rem or not B:
            raise ValueError(f"batch_tokens {self.mix['batch_tokens']} is not a "
                             f"multiple of the length {S}")
        return B

    def shapes(self) -> List[Tuple[int, int]]:
        """Every (B, S) the mix sends, in the order of ``lengths``."""
        return [(self.batch_of(S), S) for S in self.lengths]

    def shape(self, i: int) -> Tuple[int, int]:
        """Request i's (B, S)."""
        block, j = divmod(i, len(self.lengths))
        if block not in self._blocks:
            rng = np.random.default_rng(np.random.SeedSequence(self._words + [1, block]))
            self._blocks[block] = rng.permutation(len(self.lengths))
        S = self.lengths[int(self._blocks[block][j])]
        return self.batch_of(S), S

    def tokens(self, i: int, device, warm: bool = False):
        """Request i's token ids (B, S), drawn on ``device``; ``warm`` draws
        the warm-up requests' from a stream of their own."""
        import torch

        B, S = self.shapes()[i] if warm else self.shape(i)
        gen = torch.Generator(device=device)
        gen.manual_seed(self._token_base + 2 * i + (1 if warm else 0))
        return torch.randint(0, self.vocab, (B, S), generator=gen, device=device)

    def check_rng(self) -> np.random.Generator:
        """The generator that draws which request of each shape is compared."""
        return np.random.default_rng(np.random.SeedSequence(self._words + [2]))
