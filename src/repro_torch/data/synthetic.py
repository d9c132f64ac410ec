"""Deterministic synthetic LM data (port of ``repro.data.synthetic``).

The stream is a pure function of ``(seed, step, host_index)``: every host
computes its own shard without coordination, and a run restored at step k
replays from k with no data state. ``SyntheticLMDataset`` draws a Markov
"language" from a hashed transition table with numpy's Philox generator,
exactly as the reference does, so ``batch_at(step)`` gives the
reference's tokens bit for bit; the port hands them out as ``int64``
tensors on the dataset's ``device`` (``"cuda"`` by default, which raises
without a card).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["byte_tokenize", "SyntheticLMDataset"]


def byte_tokenize(text: str, vocab_size: int = 256) -> torch.Tensor:
    """UTF-8 bytes modulo ``vocab_size`` -> an int64 CPU tensor."""
    data = np.frombuffer(text.encode("utf-8"), dtype=np.uint8)
    return torch.from_numpy((data % vocab_size).astype(np.int64))


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab_size: int = 512
    seq_len: int = 256
    global_batch: int = 8
    seed: int = 0
    branching: int = 8          # markov fan-out per context
    num_contexts: int = 512     # transition-table rows (task difficulty)
    order: int = 1              # 1: learnable without attention; 2: needs
    #                             a previous-token attention circuit
    num_hosts: int = 1
    host_index: int = 0
    device: str = "cuda"

    def __post_init__(self):
        if self.global_batch % self.num_hosts:
            raise ValueError(f"global_batch {self.global_batch} does not "
                             f"split over {self.num_hosts} hosts")
        self.device = resolve_device(self.device)
        self.local_batch = self.global_batch // self.num_hosts
        rng = np.random.Generator(np.random.Philox(self.seed))
        # transition table: context hash -> branching successors
        self._succ = rng.integers(
            0, self.vocab_size, size=(self.num_contexts, self.branching),
            dtype=np.int64)

    def _gen_sequences(self, step: int) -> np.ndarray:
        """``[local_batch, seq_len + 1]`` tokens, a pure function of
        ``(step, host)``."""
        n = self.local_batch
        rng = np.random.Generator(
            np.random.Philox(key=self.seed,
                             counter=step * self.num_hosts + self.host_index))
        out = np.empty((n, self.seq_len + 1), dtype=np.int64)
        out[:, 0] = rng.integers(0, self.vocab_size, n)
        out[:, 1] = rng.integers(0, self.vocab_size, n)
        choices = rng.integers(0, self.branching, size=(n, self.seq_len + 1))
        tbl = self._succ
        h = len(tbl)
        for t in range(2, self.seq_len + 1):
            if self.order == 1:
                ctx = (out[:, t - 1] * 31) % h
            else:
                ctx = (out[:, t - 1] * 31 + out[:, t - 2] * 7) % h
            out[:, t] = tbl[ctx, choices[:, t]]
        return out

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """``{"tokens", "targets"}``, each ``[local_batch, seq_len]`` int64
        on ``device``; targets are the tokens shifted by one."""
        seq = torch.from_numpy(self._gen_sequences(step)).to(self.device)
        return {"tokens": seq[:, :-1], "targets": seq[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
