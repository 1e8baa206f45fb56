"""KV state behind the serving engine's ``prefill -> insert -> generate``
stages: the dense per-slot rectangle (the paged pool is a later slice)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["DenseKV", "Prefix"]


@dataclass
class Prefix:
    """Result of :meth:`Engine.prefill` — everything ``insert`` needs."""
    lengths: np.ndarray                  # (B,) true prompt lengths
    first_tokens: np.ndarray             # (B,) greedy token at each last position
    bucket: int                          # padded prefill length (pow2 bucket)
    kv: dict | None = None               # {"k": (L,B,pb,H,dh), "v": ..., "length"}

    @property
    def batch(self) -> int:
        return int(len(self.lengths))


class DenseKV:
    """The dense slot cache — (L, slots, max_len, H, dh) rectangles plus a
    per-slot length vector.  ``insert_kv`` writes a prefix's rows into its
    slot in place (the only in-place update on the serving path; the decode
    step itself is functional and returns a fresh cache)."""

    def __init__(self, model, slots: int, max_len: int, device):
        self.model = model
        self.slots = slots
        self.max_len = max_len
        cache = dict(model.init_cache(slots, max_len, device))
        cache["length"] = torch.zeros((slots,), dtype=torch.int32,
                                      device=device)
        self.cache = cache

    def decode_cache(self) -> dict:
        return self.cache

    def absorb(self, new_cache: dict) -> None:
        self.cache = new_cache

    def insert_kv(self, kv: dict, row: int, true_len: int, slot: int) -> None:
        pb = kv["k"].shape[2]
        for key in ("k", "v"):
            self.cache[key][:, slot, :pb] = kv[key][:, row].to(
                self.cache[key].dtype)
        length = kv["length"]
        self.cache["length"][slot] = length[row] if length.dim() else length

    def free(self, slot: int) -> None:
        pass                      # the next insert resets KV + length

    def report(self) -> dict:
        return {"layout": "dense", "slots": self.slots,
                "max_len": self.max_len}
