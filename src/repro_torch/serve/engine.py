"""Serving engine: three explicit stages over dense KV.

* :meth:`Engine.prefill` — run one (possibly ragged) prompt batch through a
  pow2-bucketed prefill and get a :class:`~repro_torch.serve.kv.Prefix`:
  true lengths, the greedy first token per row, and the bucketed KV.
  Prefills dispatch through :func:`repro_torch.exec.stitch` with
  ``respecialize``: each bucket is its own specialization with its own plan.
* :meth:`Engine.insert` — bind one prefix row to a decode slot.
* :meth:`Engine.generate_step` — advance every occupied slot ``steps``
  greedy tokens through the one stitched decode step (one host readback
  per chunk).  :meth:`Engine.release` frees a finished slot.

With a ``stitch_service`` (a :class:`repro_torch.cache.CompilationService`)
both run through ``stitch()`` in ``stitch`` mode when
``ServeConfig.stitch_execute`` is set (miss-then-upgrade: the fallback
plan answers the first call of a signature while the stitched plan
compiles in the background; every call polls for it), else in ``shadow``
mode (compiled and reported, served eagerly), as in the reference.
Without a service, ``stitch_execute=True`` runs both in ``offline`` mode
(blocking compile at the first call of each signature through
``compiler``); otherwise the engine runs the model eagerly (``jit``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.cache.policy import BucketPolicy
from repro_torch.device import resolve_device
from repro_torch.exec import stitch
from repro_torch.models.api import Model

from .kv import DenseKV, Prefix

# the admission bucket rule: prompts are right-padded to the next power of
# two (the reference's ``serve.scheduler.ADMISSION_BUCKET``)
ADMISSION_BUCKET = BucketPolicy(mode="pow2", min_dim=1)


@dataclass
class ServeConfig:
    batch: int           # static batch size == slot count
    max_len: int
    max_new_tokens: int = 32
    stitch_execute: bool = False   # run prefill + decode through stitch()
    # -- KV layout: only the dense rectangles are ported (False or None) -------
    paged: bool | None = None
    # -- prefill dispatch ------------------------------------------------------
    # live prefill specializations (pow2 buckets), LRU
    prefill_cache_size: int = 8


class Engine:
    def __init__(self, model: Model, params, cfg: ServeConfig, device=None,
                 compiler=None, stitch_service=None):
        """``stitch_service``: the ``CompilationService`` of the stitch and
        shadow modes.  ``compiler``: the ``StitchCompiler`` both plans are
        compiled with in the offline mode (default: H100 model, exact
        ILP)."""
        if stitch_service is not None and compiler is not None:
            raise ValueError("pass stitch_service= (stitch/shadow modes) or "
                             "compiler= (offline mode), not both")
        if cfg.paged:
            raise NotImplementedError(
                "paged KV is not ported yet; use paged=False (dense)")
        if model.prefill is None or model.decode_step is None:
            raise NotImplementedError(
                f"{model.cfg.family} serving is not ported yet "
                f"({model.cfg.name}: no prefill or decode step); the model "
                f"scores through train_forward and block_fn")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = resolve_device(device)
        self._tok = np.zeros((cfg.batch, 1), np.int64)
        self._occupied: set[int] = set()
        self._kv: DenseKV | None = None
        self.stitch_service = stitch_service
        if stitch_service is not None:
            mode = "stitch" if cfg.stitch_execute else "shadow"
        else:
            mode = "offline" if cfg.stitch_execute else "jit"

        def decode_step(params, cache, tok):
            return model.decode_step(params, cache, tok)

        def prefill_step(params, tokens, true_len):
            return model.prefill(params, tokens, true_len=true_len)

        # the drift check covers (cache, tok) / (tokens, true_len): params
        # are fixed for an engine's lifetime
        self._exec = stitch(decode_step, mode=mode, compiler=compiler,
                            service=stitch_service, device=self.device,
                            eligibility_argnums=(1, 2), name="decode_step")
        self._prefill_exec = stitch(prefill_step, mode=mode,
                                    compiler=compiler, service=stitch_service,
                                    device=self.device,
                                    eligibility_argnums=(1, 2),
                                    respecialize=cfg.prefill_cache_size,
                                    name="prefill")

    # -- KV state --------------------------------------------------------------
    @property
    def kv(self) -> DenseKV:
        if self._kv is None:
            self._kv = DenseKV(self.model, self.cfg.batch, self.cfg.max_len,
                               self.device)
        return self._kv

    # -- stage 1: prefill ------------------------------------------------------
    def prefill(self, tokens, prompt_lens=None) -> Prefix:
        """Run a prompt batch (2-D, or a single 1-D prompt) through the
        bucketed prefill; returns the :class:`Prefix` ``insert`` binds."""
        toks = np.asarray(tokens, np.int64)
        if toks.ndim == 1:
            toks = toks[None]
        B, Pn = toks.shape
        if Pn == 0:
            raise ValueError("prefill: empty prompt")
        lens = (np.full((B,), Pn, np.int32) if prompt_lens is None
                else np.asarray(prompt_lens, np.int32).reshape(-1))
        if lens.shape != (B,) or int(lens.max()) > Pn or int(lens.min()) < 1:
            raise ValueError(f"prompt_lens {lens!r} inconsistent with "
                             f"prompts of shape {toks.shape}")
        pb = min(ADMISSION_BUCKET.bucket_dim(Pn), self.cfg.max_len)
        padded = np.zeros((B, pb), np.int64)
        padded[:, :Pn] = toks
        logits, cache = self._prefill_exec(
            self.params, torch.as_tensor(padded, device=self.device),
            torch.as_tensor(lens, device=self.device))
        first = torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int64)
        return Prefix(lengths=lens, first_tokens=first, bucket=pb, kv=cache)

    # -- stage 2: insert -------------------------------------------------------
    def insert(self, prefix: Prefix, slot: int, row: int = 0) -> None:
        """Bind row ``row`` of a prefix to decode slot ``slot``."""
        if not 0 <= slot < self.cfg.batch:
            raise IndexError(f"slot {slot} out of range 0..{self.cfg.batch-1}")
        if slot in self._occupied:
            raise RuntimeError(f"slot {slot} already holds a request "
                               f"(release it first)")
        self.kv.insert_kv(prefix.kv, row, int(prefix.lengths[row]), slot)
        self._tok[slot, 0] = int(prefix.first_tokens[row])
        self._occupied.add(slot)

    # -- stage 3: generate -----------------------------------------------------
    def generate_step(self, steps: int = 1, return_logits: bool = False):
        """Advance every occupied slot ``steps`` greedy tokens; returns the
        (slots, steps) token matrix (free slots' rows are ride-along noise),
        plus the per-step logits when ``return_logits``.  One host readback
        per call regardless of ``steps``."""
        if not self._occupied:
            raise RuntimeError("generate_step: no occupied slots "
                               "(insert a prefix first)")
        occ = sorted(self._occupied)
        cache = self.kv.decode_cache()
        tok = torch.as_tensor(self._tok.copy(), device=self.device)
        toks_dev, logits_all = [], []
        for _ in range(steps):
            logits, cache = self._exec(self.params, cache, tok)
            tok = torch.argmax(logits, dim=-1)[:, None]
            toks_dev.append(tok)
            if return_logits:
                logits_all.append(logits)
        self.kv.absorb(cache)
        out = torch.cat(toks_dev, dim=1).cpu().numpy()
        for s in occ:
            self._tok[s, 0] = int(out[s, -1])
        if return_logits:
            return out, logits_all
        return out

    def release(self, slot: int) -> None:
        """Free a finished slot."""
        self.kv.free(slot)
        self._tok[slot, 0] = 0
        self._occupied.discard(slot)

    @property
    def occupied(self) -> frozenset[int]:
        return frozenset(self._occupied)

    # -- static serving --------------------------------------------------------
    def generate(self, prompts: np.ndarray, prompt_lens=None) -> np.ndarray:
        """prompts: (batch, prompt_len) int -> (batch, max_new_tokens).

        Stages the batch through the three-stage API: one bucketed
        prefill, per-row slot inserts, a chunked generate, then release."""
        prompts = np.asarray(prompts)
        B, _ = prompts.shape
        if B != self.cfg.batch:
            raise ValueError(f"generate: batch {B} != slots {self.cfg.batch}")
        if self._occupied:
            raise RuntimeError("generate needs an idle engine; slots "
                               f"{sorted(self._occupied)} hold live requests")
        px = self.prefill(prompts, prompt_lens=prompt_lens)
        for row in range(B):
            self.insert(px, slot=row, row=row)
        out = [px.first_tokens.astype(np.int64)[:, None]]
        if self.cfg.max_new_tokens > 1:
            out.append(self.generate_step(steps=self.cfg.max_new_tokens - 1))
        for row in range(B):
            self.release(row)
        return np.concatenate(out, axis=1)

    # -- observability ---------------------------------------------------------
    @property
    def stitch_status(self) -> str | None:
        """None before the first decode (or without a service), else the
        decode step's status: hit | miss | pending | failed."""
        if self.stitch_service is None:
            return None
        return self._exec.status

    def stitch_report(self) -> dict:
        """The decode step's exec report: plan stats, call counts, cache
        hit rates and every background-compile failure."""
        return self._exec.report()

    def land_plans(self, timeout: float | None = None) -> int:
        """Join background compiles for decode AND every live prefill
        specialization; returns how many still lack a stitched plan."""
        return (self._exec.land_plans(timeout)
                + self._prefill_exec.land_plans(timeout))

    def report(self) -> dict:
        prefill = self._prefill_exec.report()
        return {
            "decode": self._exec.report(),
            "prefill": prefill,
            "kv": self._kv.report() if self._kv is not None else None,
            "cache": {"prefill_entries": prefill["specializations"],
                      "prefill_cap": self.cfg.prefill_cache_size},
        }
