"""Integer seed mixing: PyTorch has no ``jax.random.fold_in``, so where
the reference folds an index into a key, the port seeds a
``torch.Generator`` with a fixed 63-bit mix of the integers instead
(request sampling streams in ``serve.scheduler``, feature generations in
``core.doubling``)."""
from __future__ import annotations

__all__ = ["mix_seed"]

_MASK64 = (1 << 64) - 1


def mix_seed(*words: int) -> int:
    """A fixed 63-bit mix of ``words`` (the splitmix64 finalizer over each
    word in turn): equal words give equal seeds on every host and device,
    and a change to any word changes the seed."""
    h = 0x9E3779B97F4A7C15
    for word in words:
        h = (h ^ (int(word) & _MASK64)) & _MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h >> 1
